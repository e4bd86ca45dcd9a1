// Sliding-window attention over the QA decode cache for Hopper (sm_90a),
// plain C interface.
//
// Replaces the Pallas kernel stc_tpu/ops/decode_attention.py::_attn_kernel
// (wrapper decode_attention).  T queries sit at affine slots start + t of a
// decode cache (B, Hkv, C, D) whose keys are stored already rotated; a query
// sees slot s when 0 <= q_slot - s < n_local and s < cursor.  GQA is folded
// into the query rows; tiles outside the live slot range
// [start - n_local + 1, min(start + T, cursor)) are skipped.  Optionally the
// row maxima m of the scaled, masked scores are written too.
//
// Bound on the H100 at llava-ov-0.5b shapes: a token step (T = 1, 7 rows per
// kv head) reads ~2 MB of live cache, 0.6 us at 3.35 TB/s: bytes-bound and
// below the cost of a launch, so the launch cost is the number to watch.
// This first design splits the slot range over blocks (flash-decoding) so
// one kv head's 7 rows still spread over the card; the prompt prefill
// (T = 256) runs the same FP32-FMA tiles as stream_attention.

#include "attn_common.cuh"

namespace stc {

struct DecodeArgs {
  const void* q;       // (B, Hq, T, D) rotated
  const void* k;       // (B, Hkv, C, D) rotated
  const void* v;       // (B, Hkv, C, D)
  const int* start;    // (B,)
  const int* cursor;   // (B,)
  float* part_acc;     // (n_split, B*Hq*T, D)
  float* part_ml;      // (n_split, B*Hq*T, 2)
  int B, Hq, Hkv, T, C, n_local, n_split;
};

template <typename T, int D>
__global__ void __launch_bounds__(NTH)
decode_attention_kernel(DecodeArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  TileSmem<D>& sm = *reinterpret_cast<TileSmem<D>*>(smem_raw);

  const int qt = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z / a.n_split;
  const int split = blockIdx.z % a.n_split;
  const int G = a.Hq / a.Hkv;
  const int GT = G * a.T;
  const int tid = threadIdx.x;
  const float scale = 1.f / sqrtf((float)D);
  const int start = a.start[b];
  const int cursor = a.cursor[b];

  const T* q = static_cast<const T*>(a.q);
  const T* kc = static_cast<const T*>(a.k);
  const T* vc = static_cast<const T*>(a.v);
  const long long hk = ((long long)b * a.Hkv + h) * a.C;

  for (int i = tid; i < BR * D; i += NTH) {
    const int r = i / D, d = i % D;
    const int gr = qt * BR + r;
    float x = 0.f;
    if (gr < GT) {
      const int g = gr / a.T, t = gr % a.T;
      x = to_f(q[(((long long)b * a.Hq + h * G + g) * a.T + t) * D + d]);
    }
    sm.q[r][d] = x;
  }
  Acc<D> acc;
  acc_zero(acc);
  stats_init(sm);
  __syncthreads();

  // live slots over all rows of the call: (start - n_local, start + T - 1]
  const long long lo = (long long)start - a.n_local + 1;
  const long long hi = min((long long)start + a.T, (long long)cursor);
  const int n_tiles = (a.C + BC - 1) / BC;
  for (int tile = split; tile < n_tiles; tile += a.n_split) {
    const int s0 = tile * BC;
    if (!(s0 < hi && s0 + BC - 1 >= lo)) continue;  // uniform over the block
    for (int i = tid; i < BC * D; i += NTH) {
      const int c = i / D, d = i % D;
      const int s = s0 + c;
      const bool ok = s < a.C && s < cursor;
      sm.k[c][d] = ok ? to_f(kc[(hk + s) * D + d]) : 0.f;
      sm.v[c][d] = ok ? to_f(vc[(hk + s) * D + d]) : 0.f;
    }
    __syncthreads();
    tile_update<T, D>(sm, acc, scale, [&](int r, int c) {
      const int gr = qt * BR + r;
      const int s = s0 + c;
      const long long dist = (long long)start + gr % a.T - s;
      return gr < GT && s < a.C && s < cursor && dist >= 0 &&
             dist < a.n_local;
    });
  }

  const long long n_rows = (long long)a.B * a.Hq * a.T;
  write_partial<D>(sm, acc, a.part_acc, a.part_ml, split, n_rows,
                   [&](int r) -> long long {
                     const int gr = qt * BR + r;
                     if (gr >= GT) return -1;
                     const int g = gr / a.T, t = gr % a.T;
                     return ((long long)b * a.Hq + h * G + g) * a.T + t;
                   });
}

template <typename T, int D>
cudaError_t launch(const DecodeArgs& a, void* out, float* m_out,
                   cudaStream_t stream) {
  const size_t smem = sizeof(TileSmem<D>);
  cudaError_t err = cudaFuncSetAttribute(
      decode_attention_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int G = a.Hq / a.Hkv;
  dim3 grid((G * a.T + BR - 1) / BR, a.Hkv, a.B * a.n_split);
  decode_attention_kernel<T, D><<<grid, NTH, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_combine<T, D>(a.part_acc, a.part_ml, a.n_split,
                              (long long)a.B * a.Hq * a.T, out, m_out,
                              stream);
}

template <typename T>
cudaError_t launch_d(const DecodeArgs& a, int D, void* out, float* m_out,
                     cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(a, out, m_out, stream);
    case 32: return launch<T, 32>(a, out, m_out, stream);
    case 64: return launch<T, 64>(a, out, m_out, stream);
    case 128: return launch<T, 128>(a, out, m_out, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace stc

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out).  m_out may be null.
// Returns cudaGetLastError() after the launches.
extern "C" int stc_decode_attention(const void* q, const void* k,
                                    const void* v, const void* start,
                                    const void* cursor, void* part_acc,
                                    void* part_ml, void* out, void* m_out,
                                    int B, int Hq, int Hkv, int T, int D,
                                    int C, int n_local, int n_split,
                                    int dtype, void* stream) {
  stc::DecodeArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.start = static_cast<const int*>(start);
  a.cursor = static_cast<const int*>(cursor);
  a.part_acc = static_cast<float*>(part_acc);
  a.part_ml = static_cast<float*>(part_ml);
  a.B = B;
  a.Hq = Hq;
  a.Hkv = Hkv;
  a.T = T;
  a.C = C;
  a.n_local = n_local;
  a.n_split = n_split;
  if (Hq % Hkv != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* m = static_cast<float*>(m_out);
  cudaError_t err = dtype == 1
                        ? stc::launch_d<__nv_bfloat16>(a, D, out, m, st)
                        : stc::launch_d<float>(a, D, out, m, st);
  return (int)err;
}

// Per-key attention mass over the QA decode cache for Hopper (sm_90a),
// plain C interface.
//
// Replaces the Pallas kernel stc_tpu/ops/decode_attention.py::_score_kernel
// (wrapper decode_score; the reference's get_score).  For T queries at
// affine slots start + t of a decode cache (B, Hkv, C, D) whose keys are
// stored rotated, and the row maxima m (B, Hq, T) that decode_attention
// returns, it writes
//   out[b, hq, slot] = sum_t exp(q_t . k_slot * scale - m[b, hq, t])
// over the keys each query sees (0 <= q_slot - slot < n_local, slot <
// cursor), not normalised by the softmax sum.  Masked entries are selected
// to 0, never multiplied by a mask: a row that sees no key has m = -inf.
//
// Grid (key tiles, Hkv, B): each block owns one tile of BC keys of one kv
// head and walks the G*T folded query rows in chunks of BR, so every key
// belongs to one block and the sums need no second pass.  Tiles outside the
// live slot range [start - n_local + 1, min(start + T, cursor)) write zeros
// without reading anything.
//
// Bound on the H100 at llava-ov-0.5b shapes: the 256-token prompt over a
// 4110-slot cache does 2*14*256*4110*64 ~ 1.9 GFLOP (1.9 us at the dense
// bf16 rate) and moves ~1 MB of keys and ~0.5 MB of output (0.5 us), so
// operations bound it.  This first design runs the products as FP32 FMA
// out of shared memory (the tiles of stream_attention and
// decode_attention); tensor cores are the next step.

#include "attn_common.cuh"

namespace stc {

struct ScoreArgs {
  const void* q;       // (B, Hq, T, D) rotated
  const void* k;       // (B, Hkv, C, D) rotated
  const float* m;      // (B, Hq, T) row maxima of the scaled, masked scores
  const int* start;    // (B,)
  const int* cursor;   // (B,)
  float* out;          // (B, Hq, C)
  int B, Hq, Hkv, T, C, n_local;
};

template <int D>
struct ScoreSmem {
  float q[BR][D + 1];
  float k[BC][D + 1];
  float s[BR][BC + 1];  // masked exp terms of one row chunk
  float m[BR];
  // followed by the per-head sums acc[G][BC] (dynamic)
};

template <typename T, int D>
__global__ void __launch_bounds__(NTH) decode_score_kernel(ScoreArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  ScoreSmem<D>& sm = *reinterpret_cast<ScoreSmem<D>*>(smem_raw);
  float* acc = reinterpret_cast<float*>(smem_raw + sizeof(ScoreSmem<D>));

  const int s0 = blockIdx.x * BC;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int G = a.Hq / a.Hkv;
  const int GT = G * a.T;
  const int tid = threadIdx.x;
  const float scale = 1.f / sqrtf((float)D);
  const int start = a.start[b];
  const int cursor = a.cursor[b];

  for (int i = tid; i < G * BC; i += NTH) acc[i] = 0.f;

  // live slots over all rows of the call: (start - n_local, start + T - 1]
  const long long lo = (long long)start - a.n_local + 1;
  const long long hi = min((long long)start + a.T, (long long)cursor);
  const bool live = s0 < hi && s0 + BC - 1 >= lo;  // uniform over the block

  if (live) {
    const T* q = static_cast<const T*>(a.q);
    const T* kc = static_cast<const T*>(a.k);
    const long long hk = ((long long)b * a.Hkv + h) * a.C;
    for (int i = tid; i < BC * D; i += NTH) {
      const int c = i / D, d = i % D;
      const int s = s0 + c;
      sm.k[c][d] = (s < a.C) ? to_f(kc[(hk + s) * D + d]) : 0.f;
    }
    const int ty = tid / 16, tx = tid % 16;
    for (int r0 = 0; r0 < GT; r0 += BR) {
      for (int i = tid; i < BR * D; i += NTH) {
        const int r = i / D, d = i % D;
        const int gr = r0 + r;
        float x = 0.f;
        if (gr < GT) {
          const int g = gr / a.T, t = gr % a.T;
          x = to_f(q[(((long long)b * a.Hq + h * G + g) * a.T + t) * D + d]);
        }
        sm.q[r][d] = x;
      }
      for (int r = tid; r < BR; r += NTH) {
        const int gr = r0 + r;
        sm.m[r] = 0.f;
        if (gr < GT) {
          const int g = gr / a.T, t = gr % a.T;
          sm.m[r] = a.m[((long long)b * a.Hq + h * G + g) * a.T + t];
        }
      }
      __syncthreads();
      float sc[4][4];
      tile_scores<D>(sm.q, sm.k, sc);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = ty * 4 + i, c = tx + 16 * j;
          const int gr = r0 + r, s = s0 + c;
          const long long dist = (long long)start + gr % a.T - s;
          const bool keep = gr < GT && s < a.C && s < cursor && dist >= 0 &&
                            dist < a.n_local;
          sm.s[r][c] = keep ? expf(sc[i][j] * scale - sm.m[r]) : 0.f;
        }
      __syncthreads();
      // one thread per key: add the chunk's rows into their head's sum
      if (tid < BC) {
        const int rows = min(BR, GT - r0);
        int g = r0 / a.T;
        float sum = 0.f;
        for (int r = 0; r < rows; ++r) {
          const int gr = r0 + r;
          if (gr / a.T != g) {
            acc[g * BC + tid] += sum;
            g = gr / a.T;
            sum = 0.f;
          }
          sum += sm.s[r][tid];
        }
        acc[g * BC + tid] += sum;
      }
      __syncthreads();
    }
  }
  __syncthreads();
  for (int i = tid; i < G * BC; i += NTH) {
    const int g = i / BC, c = i % BC;
    const int s = s0 + c;
    if (s < a.C)
      a.out[((long long)b * a.Hq + h * G + g) * a.C + s] = acc[i];
  }
}

template <typename T, int D>
cudaError_t launch(const ScoreArgs& a, cudaStream_t stream) {
  const int G = a.Hq / a.Hkv;
  const size_t smem = sizeof(ScoreSmem<D>) + (size_t)G * BC * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      decode_score_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.C + BC - 1) / BC, a.Hkv, a.B);
  decode_score_kernel<T, D><<<grid, NTH, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const ScoreArgs& a, int D, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(a, stream);
    case 32: return launch<T, 32>(a, stream);
    case 64: return launch<T, 64>(a, stream);
    case 128: return launch<T, 128>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace stc

// dtype: 0 = float32, 1 = bfloat16 (q and k).  m and out are float32.
// Returns cudaGetLastError() after the launch.
extern "C" int stc_decode_score(const void* q, const void* k, const void* m,
                                const void* start, const void* cursor,
                                void* out, int B, int Hq, int Hkv, int T,
                                int D, int C, int n_local, int dtype,
                                void* stream) {
  stc::ScoreArgs a;
  a.q = q;
  a.k = k;
  a.m = static_cast<const float*>(m);
  a.start = static_cast<const int*>(start);
  a.cursor = static_cast<const int*>(cursor);
  a.out = static_cast<float*>(out);
  a.B = B;
  a.Hq = Hq;
  a.Hkv = Hkv;
  a.T = T;
  a.C = C;
  a.n_local = n_local;
  if (Hq % Hkv != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 1 ? stc::launch_d<__nv_bfloat16>(a, D, st)
                               : stc::launch_d<float>(a, D, st);
  return (int)err;
}

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
// Bound on the H100: a token step (T = 1, 7 rows per kv head) at
// llava-ov-0.5b heads reads ~2 MB of live cache, 0.6 us at 3.35 TB/s:
// bytes-bound and below the cost of a launch, so the launch cost is the
// number to watch.  The 256-token prompt prefill at llava-ov-7b heads does
// ~14.6 GFLOP, 0.015 ms at the dense bf16 rate: operations bound it.
//
// Design.  The slot range is split over blocks (flash-decoding, merged by
// combine_kernel) so one kv head's 7 query rows still spread over the card.
// bf16 queries run the tensor-core tile of attn_tc.cuh (128 folded rows a
// block, 64-slot tiles; a token step's 7 rows fill part of one warp, the
// other warps only help load): the K and V tiles are copied with cp.async
// straight into the padded MMA layout, double-buffered against the
// previous tile's products, slots past the cache or the cursor zero-filled.
// float32 queries keep the FP32-FMA tile of attn_common.cuh, so their
// score operands stay in float32.  stc_decode_attention_tile reports the
// tile each dtype runs; the wrapper sizes its split from it.

#include "attn_common.cuh"
#include "attn_tc.cuh"

#include <stdint.h>

#include <type_traits>

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

// bfloat16 queries: the tensor-core tile.
template <int D>
__global__ void __launch_bounds__(tc::Cfg<D>::NTH, tc::Cfg<D>::MIN_BLOCKS)
decode_attention_tc(DecodeArgs a) {
  constexpr int BC = tc::BC, MT = tc::Cfg<D>::MT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const tc::Smem<D> sm(smem_raw);
  const tc::Block<D> blk(a.Hq, a.Hkv, a.T, a.n_split);
  const bool warp_live = blk.warp_live();
  const float scale = 1.f / sqrtf((float)D);
  const int start = a.start[blk.b];
  const int cursor = a.cursor[blk.b];
  const long long hk = ((long long)blk.b * a.Hkv + blk.h) * a.C;

  // the thread's rows
  bool rok[2 * MT];
  int qslot[2 * MT];
#pragma unroll
  for (int k = 0; k < 2 * MT; ++k) {
    const int r = tc::row_of<D>(k);
    rok[k] = blk.row(r) >= 0;
    qslot[k] = start + blk.token(r);
  }

  tc::Warp<D> w;
  tc::warp_init(w);
  blk.stage(sm.q(), a.q);
  __syncthreads();
  if (warp_live) tc::load_q(w, sm.q());

  // live slots over all rows of the call: (start - n_local, start + T - 1]
  const int lo = start - a.n_local + 1;
  const int hi = min(start + a.T, cursor);
  const int valid = min(a.C, cursor);
  tc::walk(
      blk.split, a.n_split, (a.C + BC - 1) / BC,
      [&](int tile) {
        const int s0 = tile * BC;
        return s0 < hi && s0 + BC - 1 >= lo;
      },
      // slots past the cache or the cursor are zero-filled
      [&](int tile, int i) {
        const int s0 = tile * BC;
        const tc::bf16* k = static_cast<const tc::bf16*>(a.k);
        const tc::bf16* v = static_cast<const tc::bf16*>(a.v);
        tc::load_tile<D>(sm.k(i), k + (hk + s0) * D, valid - s0);
        tc::load_tile<D>(sm.v(i), v + (hk + s0) * D, valid - s0);
      },
      [&](int tile, int i) {
        if (!warp_live) return;
        const int s0 = tile * BC;
        // every slot of the tile is written and seen by every query
        const bool full = s0 + BC <= valid && s0 + BC - 1 <= start &&
                          start + a.T - 1 - s0 < a.n_local;
        tc::update<D>(w, sm.q(), sm.k(i), sm.v(i), scale, [&](int k, int c) {
          if (full) return rok[k];
          const int dist = qslot[k] - (s0 + c);
          return rok[k] && s0 + c < valid && dist >= 0 && dist < a.n_local;
        });
      });

  tc::write_partial<D>(w, blk, a.part_acc, a.part_ml,
                       (long long)a.B * a.Hq * a.T);
}

// float32 queries run the FMA tile, bfloat16 ones the tensor-core tile.
// With `tile` set nothing is launched: tile receives the block's rows, its
// keys per KV tile and the blocks an SM holds at once.
template <typename T, int D>
cudaError_t launch(const DecodeArgs& a, void* out, float* m_out,
                   cudaStream_t stream, int* tile) {
  void (*kernel)(DecodeArgs);
  int smem, br, bc, nth;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    kernel = decode_attention_tc<D>;
    smem = tc::Cfg<D>::SMEM;
    br = tc::Cfg<D>::BR;
    bc = tc::BC;
    nth = tc::Cfg<D>::NTH;
  } else {
    kernel = decode_attention_kernel<T, D>;
    smem = (int)sizeof(TileSmem<D>);
    br = BR;
    bc = BC;
    nth = NTH;
  }
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  if (tile != nullptr) {
    tile[0] = br;
    tile[1] = bc;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&tile[2], kernel,
                                                         nth, smem);
  }
  const int G = a.Hq / a.Hkv;
  dim3 grid((G * a.T + br - 1) / br, a.Hkv, a.B * a.n_split);
  kernel<<<grid, nth, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_combine<T, D>(a.part_acc, a.part_ml, a.n_split,
                              (long long)a.B * a.Hq * a.T, out, m_out,
                              stream);
}

template <typename T>
cudaError_t launch_d(const DecodeArgs& a, int D, void* out, float* m_out,
                     cudaStream_t stream, int* tile) {
  switch (D) {
    case 16: return launch<T, 16>(a, out, m_out, stream, tile);
    case 32: return launch<T, 32>(a, out, m_out, stream, tile);
    case 64: return launch<T, 64>(a, out, m_out, stream, tile);
    case 128: return launch<T, 128>(a, out, m_out, stream, tile);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace stc

// The tile that stc_decode_attention runs for dtype (0 = float32, 1 =
// bfloat16) and head dim D: tile[0] folded query rows a block, tile[1]
// keys a KV tile, tile[2] blocks an SM holds at once.  The wrapper sizes
// its grid and scratch from it.
extern "C" int stc_decode_attention_tile(int dtype, int D, int* tile) {
  stc::DecodeArgs a{};
  return (int)(dtype == 1 ? stc::launch_d<__nv_bfloat16>(a, D, nullptr,
                                                         nullptr, nullptr,
                                                         tile)
                          : stc::launch_d<float>(a, D, nullptr, nullptr,
                                                 nullptr, tile));
}

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out; with bfloat16, q, k
// and v are 16-byte aligned).  m_out may be null.  Returns
// cudaGetLastError() after the launches.
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
  const void* ptrs[] = {q, k, v};
  for (const void* p : ptrs)
    if (dtype == 1 && reinterpret_cast<uintptr_t>(p) % 16 != 0)
      return (int)cudaErrorMisalignedAddress;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* m = static_cast<float*>(m_out);
  cudaError_t err = dtype == 1
                        ? stc::launch_d<__nv_bfloat16>(a, D, out, m, st,
                                                       nullptr)
                        : stc::launch_d<float>(a, D, out, m, st, nullptr);
  return (int)err;
}

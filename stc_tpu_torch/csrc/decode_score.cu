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
// Bound on the H100: one exponential per visible (query head, query, key)
// triple against only 2 D products.  The special-function units take 16
// exponentials a clock per SM and the tensor cores 4096 bf16 flops (at the
// data sheet's 1.83 GHz: ~3.9e12/s against 989e12/s), so one exponential
// costs as much as 256 flops: below D = 128 the exponentials bound it, at
// D = 128 they tie the products.  At llava-ov-0.5b shapes the 256-token
// prompt over a 4110-slot cache pays ~14.3 M of them, ~3.7 us, against
// ~1.9 us of products and ~0.5 us of bytes (~1 MB of keys, ~0.5 MB of
// output).
//
// Design, bf16 (decode_score_tc): the sum runs over queries and is kept
// per key, so the keys are the mma.sync A rows and the queries stream as
// the N side, the S = Q K^T of attn_tc.cuh with the names exchanged.  Grid
// (key tiles, Hq, B): a block owns 128 keys of one query head (tc::Cfg's
// warps and m-tiles), loads their A fragments once into registers, and
// walks the head's T queries in 64-query tiles copied with cp.async,
// double-buffered (tc::walk), with their row maxima beside them.  A term is
// one FFMA and one ex2.approx, exp(x - m) = 2^(x log2 e - m log2 e); where
// some pair of a warp's keys and the query tile is not visible the mask is
// a select.  Each thread adds its columns into its two key rows per
// m-tile, a quad shuffle completes each key's sum, one lane writes it: the
// sum over t never leaves the block.  Key tiles outside the live slot
// range [start - n_local + 1, min(start + T, cursor)) write zeros without
// reading anything; query tiles that see no key of a warp are skipped.
// Measured on the H100 (chip_smoke.py times this tile with each part
// switched off, STC_SCORE_DROP below; PERF.md), at 0.5b heads: a query
// tile's step is half its time, nearly all of it the queries' ldmatrix
// and the mma.sync; the ex2 alone a tenth; the copies and the walk a
// third; the launch and zero writes the rest.  So it is held by moving
// the queries (every key tile's block copies its head's T queries again,
// and each warp's B fragments feed only MT m-tiles) and by the mma.sync,
// not by its exponentials.  A deeper copy ring was no faster; more keys
// a warp (fewer copies of each query tile, more m-tiles a fragment), or
// wgmma reading the queries from shared memory, are the next step.
//
// float32 (decode_score_kernel) keeps the FP32-FMA tile of
// attn_common.cuh: one tile of BC keys of one kv head a block, walking the
// G * T folded query rows in chunks of BR through shared memory.

#include "attn_common.cuh"
#include "attn_tc.cuh"

// Parts of decode_score_tc switched off, for measuring what its time is
// made of (chip_smoke.py builds these beside the real library; results are
// wrong in all but 0): 1 the ex2, 2 the query ldmatrix and mma.sync, 3 the
// whole step of a query tile (the copies and the walk remain), 4 the walk
// (the block writes zeros).
#ifndef STC_SCORE_DROP
#define STC_SCORE_DROP 0
#endif

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

// ---- float32: the FMA tile ----

template <int D>
struct ScoreSmem {
  float q[BR][D + 1];
  float k[BC][D + 1];
  float s[BR][BC + 1];  // masked exp terms of one row chunk
  float m[BR];
  // followed by the per-head sums acc[G][BC] (dynamic)
};

template <int D>
__global__ void __launch_bounds__(NTH) decode_score_kernel(ScoreArgs a) {
  using T = float;
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

template <int D>
cudaError_t launch_fma(const ScoreArgs& a, cudaStream_t stream) {
  const int G = a.Hq / a.Hkv;
  const size_t smem = sizeof(ScoreSmem<D>) + (size_t)G * BC * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      decode_score_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.C + BC - 1) / BC, a.Hkv, a.B);
  decode_score_kernel<D><<<grid, NTH, smem, stream>>>(a);
  return cudaGetLastError();
}

// ---- bfloat16: the tensor-core tile ----

// The block of decode_score_tc: tc::Cfg's warps and m-tiles, whose BR rows
// are here keys, and 64-query tiles.  Shared memory: the (BK, D) keys,
// two (BQ, D) query buffers (bf16 at tc::pitch), two BQ row maxima.
template <int D>
struct ScoreCfg {
  static constexpr int MT = tc::Cfg<D>::MT;    // 16-key m-tiles a warp
  static constexpr int NTH = tc::Cfg<D>::NTH;  // threads a block
  static constexpr int BK = tc::Cfg<D>::BR;    // keys a block
  static constexpr int BQ = tc::BC;            // queries a tile
  static constexpr int WK = 16 * MT;           // keys a warp
  static constexpr int MIN_BLOCKS = D <= 64 ? 3 : 2;
  static constexpr int SMEM =
      (BK + 2 * BQ) * tc::pitch<D>() * 2 + 2 * BQ * (int)sizeof(float);
};

// Whether a query of slots [q0, q0 + n) sees a key of slots [k0, k1]
// (0 <= q_slot - slot < n_local).
__device__ __forceinline__ bool sees(int q0, int n, int k0, int k1,
                                     int n_local) {
  return k0 <= k1 && q0 + n - 1 >= k0 && q0 - k1 < n_local;
}

// One query tile against the warp's keys: S = K Q^T with the keys' A
// fragments `a` in registers and the tile's queries `qs` by ldmatrix, then
// sum[k] += exp(s * scale - m) over the tile's queries for the thread's
// key rows k = 2 * mt + ri.  C fragment: s[mt][j][2 * ri + e] is key row
// (mt, ri), query 8 * j + 2 * tig + e.  With MASK, a term whose query slot
// q0 + col and key slot kslot[k] are not 0 <= q - k < n_local is selected
// to 0; kslot of a key past the cursor or the cache is 2^30 and the slot
// of a query past T -2^30, so neither is seen.
template <int D, bool MASK>
__device__ __forceinline__ void score_tile(
    const uint32_t (&a)[ScoreCfg<D>::MT][D / 16][4], const tc::bf16* qs,
    const float* ms, float c, float (&sum)[2 * ScoreCfg<D>::MT],
    const int (&kslot)[2 * ScoreCfg<D>::MT], int q0, int n, int n_local) {
  constexpr int P = tc::pitch<D>(), MT = ScoreCfg<D>::MT,
                BQ = ScoreCfg<D>::BQ;
  if constexpr (STC_SCORE_DROP == 3) return;
  const int lane = threadIdx.x % 32, tig = lane % 4;
  float s[MT][BQ / 8][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[mt][j][e] = 0.f;
  // one x4 ldmatrix gives both k-halves of two 8-query n-tiles, which feed
  // every m-tile
  const tc::bf16* qrow =
      qs + ((lane / 16) * 8 + lane % 8) * P + ((lane / 8) % 2) * 8;
#pragma unroll
  for (int kk = 0; kk < (STC_SCORE_DROP == 2 ? 0 : D / 16); ++kk) {
    uint32_t b[BQ / 16][4];
#pragma unroll
    for (int jp = 0; jp < BQ / 16; ++jp)
      tc::ldsm_x4(qrow + jp * 16 * P + kk * 16, b[jp][0], b[jp][1], b[jp][2],
                  b[jp][3]);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int jp = 0; jp < BQ / 16; ++jp) {
        tc::mma(s[mt][2 * jp], a[mt][kk], b[jp][0], b[jp][1]);
        tc::mma(s[mt][2 * jp + 1], a[mt][kk], b[jp][2], b[jp][3]);
      }
  }
#pragma unroll
  for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = 8 * j + 2 * tig + e;
      const float ml = ms[col] * tc::LOG2E;
      const int qslot = col < n ? q0 + col : -(1 << 30);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int ri = 0; ri < 2; ++ri) {
          const int k = 2 * mt + ri;
          float x = fmaf(s[mt][j][2 * ri + e], c, -ml);
          if constexpr (STC_SCORE_DROP != 1) x = tc::ex2(x);
          if constexpr (MASK)
            x = (unsigned)(qslot - kslot[k]) < (unsigned)n_local ? x : 0.f;
          sum[k] += x;
        }
    }
}

template <int D>
__global__ void __launch_bounds__(ScoreCfg<D>::NTH, ScoreCfg<D>::MIN_BLOCKS)
decode_score_tc(ScoreArgs a) {
  using S = ScoreCfg<D>;
  constexpr int P = tc::pitch<D>(), MT = S::MT, BK = S::BK, BQ = S::BQ,
                WK = S::WK;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  tc::bf16* ks = reinterpret_cast<tc::bf16*>(smem_raw);
  float* ms = reinterpret_cast<float*>(smem_raw + (BK + 2 * BQ) * P * 2);
  auto qbuf = [&](int i) { return ks + (BK + i * BQ) * P; };

  const int k0 = blockIdx.x * BK, hq = blockIdx.y, b = blockIdx.z;
  const int h = hq / (a.Hq / a.Hkv);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int start = a.start[b], n_local = a.n_local, T = a.T;
  const int kend = min(a.C, a.cursor[b]);  // no key at or past it is seen
  // the block's keys that can be seen, [k0, kmax], and the warp's
  const int kmax = min(k0 + BK, kend) - 1;
  const int wk0 = k0 + warp * WK, wk1 = min(wk0 + WK, kend) - 1;

  float sum[2 * MT];
  int kslot[2 * MT];
#pragma unroll
  for (int k = 0; k < 2 * MT; ++k) {
    sum[k] = 0.f;
    const int s = wk0 + (k / 2) * 16 + lane / 4 + 8 * (k % 2);
    kslot[k] = s < kend ? s : (1 << 30);
  }

  // live slots over all queries: [start - n_local + 1, min(start + T,
  // cursor)); the test is uniform over the block
  if (STC_SCORE_DROP != 4 && sees(start, T, k0, kmax, n_local)) {
    const tc::bf16* kc = static_cast<const tc::bf16*>(a.k) +
                         ((long long)b * a.Hkv + h) * a.C * D;
    tc::load_rows<D>(ks, BK, [&](int r) -> const tc::bf16* {
      return k0 + r < kend ? kc + (long long)(k0 + r) * D : nullptr;
    });
    __syncthreads();
    // the A fragments of the warp's keys, held for the whole walk
    uint32_t af[MT][D / 16][4];
    const tc::bf16* krow = ks + (warp * WK + lane % 16) * P + (lane / 16) * 8;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        tc::ldsm_x4(krow + mt * 16 * P + kk * 16, af[mt][kk][0],
                    af[mt][kk][1], af[mt][kk][2], af[mt][kk][3]);
    const long long row0 = ((long long)b * a.Hq + hq) * T;
    const tc::bf16* qh = static_cast<const tc::bf16*>(a.q) + row0 * D;
    const float* mh = a.m + row0;
    const float c = tc::LOG2E / sqrtf((float)D);
    tc::walk(
        0, 1, (T + BQ - 1) / BQ,
        [&](int qt) {
          const int t0 = qt * BQ;
          return sees(start + t0, min(BQ, T - t0), k0, kmax, n_local);
        },
        [&](int qt, int i) {
          const int t0 = qt * BQ, n = min(BQ, T - t0);
          tc::load_tile<D>(qbuf(i), qh + (long long)t0 * D, n);
          for (int j = threadIdx.x; j < BQ; j += S::NTH)
            tc::cp_async4(ms + i * BQ + j, mh + t0 + (j < n ? j : 0),
                          j < n ? 4 : 0);
        },
        [&](int qt, int i) {
          const int t0 = qt * BQ, n = min(BQ, T - t0), q0 = start + t0;
          if (!sees(q0, n, wk0, wk1, n_local)) return;  // uniform over the warp
          // every pair of the warp's keys and the tile's queries is seen
          const bool full = n == BQ && wk1 == wk0 + WK - 1 && q0 >= wk1 &&
                            q0 + BQ - 1 - wk0 < n_local;
          if (full)
            score_tile<D, false>(af, qbuf(i), ms + i * BQ, c, sum, kslot,
                                 q0, n, n_local);
          else
            score_tile<D, true>(af, qbuf(i), ms + i * BQ, c, sum, kslot, q0,
                                n, n_local);
        });
  }

  // each key's sum is spread over the 4 lanes of a quad
  float* out = a.out + ((long long)b * a.Hq + hq) * a.C;
#pragma unroll
  for (int k = 0; k < 2 * MT; ++k) {
    float v = sum[k];
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    v += __shfl_xor_sync(0xffffffffu, v, 2);
    const int s = wk0 + (k / 2) * 16 + lane / 4 + 8 * (k % 2);
    if (lane % 4 == 0 && s < a.C) out[s] = v;
  }
}

template <int D>
cudaError_t launch_tc(const ScoreArgs& a, cudaStream_t stream) {
  using S = ScoreCfg<D>;
  cudaError_t err = cudaFuncSetAttribute(
      decode_score_tc<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      S::SMEM);
  if (err != cudaSuccess) return err;
  dim3 grid((a.C + S::BK - 1) / S::BK, a.Hq, a.B);
  decode_score_tc<D><<<grid, S::NTH, S::SMEM, stream>>>(a);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dtype(const ScoreArgs& a, int dtype, cudaStream_t stream) {
  return dtype == 1 ? launch_tc<D>(a, stream) : launch_fma<D>(a, stream);
}

cudaError_t launch_d(const ScoreArgs& a, int D, int dtype,
                     cudaStream_t stream) {
  switch (D) {
    case 16: return launch_dtype<16>(a, dtype, stream);
    case 32: return launch_dtype<32>(a, dtype, stream);
    case 64: return launch_dtype<64>(a, dtype, stream);
    case 128: return launch_dtype<128>(a, dtype, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace stc

// dtype: 0 = float32, 1 = bfloat16 (q and k; with bfloat16 both are
// 16-byte aligned).  m and out are float32.  Returns cudaGetLastError()
// after the launch.
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
  if (dtype == 1 && (reinterpret_cast<uintptr_t>(q) % 16 != 0 ||
                     reinterpret_cast<uintptr_t>(k) % 16 != 0))
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)stc::launch_d(a, D, dtype, st);
}

// Shared FP32-FMA tile machinery of the hand-written attention kernels:
// the float32 instances of stream_attention.cu, decode_attention.cu and
// decode_score.cu (their bf16 instances run the tensor-core tile of
// attn_tc.cuh).  combine_kernel serves the first two.
//
// One CUDA block owns BR folded query rows (GQA: the G query heads of one
// kv head times T tokens, row = g * T + t) and walks KV tiles of BC keys.
// Scores, the online softmax and P @ V run as plain FP32 FMA out of shared
// memory; m / l / acc stay in FP32 (m, l in shared memory, acc in
// registers).  The KV walk of a row tile is split over several blocks
// (flash-decoding style); each split writes its partial (m, l, acc) and
// combine_kernel merges them and normalises by l (0 where l == 0).
//
// Rounding points follow the Pallas kernels: score operands are values of
// the input dtype (rotated keys are rounded to it first), probabilities are
// rounded to the value dtype before P @ V, l sums the unrounded ones.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace stc {

constexpr int BR = 64;    // folded query rows per block
constexpr int BC = 64;    // keys per KV tile
constexpr int NTH = 256;  // threads per block: 16 x 16, 4 rows x D/16 cols each

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// round to the storage dtype and back
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

template <int D>
struct TileSmem {
  float q[BR][D + 1];   // +1: rows of one warp land in different banks
  float k[BC][D + 1];
  float v[BC][D];
  float s[BR][BC + 1];  // scores, then rounded probabilities
  float m[BR];
  float l[BR];
  float alpha[BR];
};

// Thread (ty, tx) = (tid / 16, tid % 16) owns rows ty*4 + i (i < 4) and
// columns tx + 16*j (j < D/16) of the (BR, D) accumulator.
template <int D>
struct Acc {
  float a[4][D / 16];
};

template <int D>
__device__ __forceinline__ void acc_zero(Acc<D>& acc) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < D / 16; ++j) acc.a[i][j] = 0.f;
}

template <int D>
__device__ __forceinline__ void stats_init(TileSmem<D>& sm) {
  for (int r = threadIdx.x; r < BR; r += NTH) {
    sm.m[r] = -INFINITY;
    sm.l[r] = 0.f;
  }
}

// One online-softmax update with the tile in sm.k / sm.v against the rows
// in sm.q.  keep(r, c) says whether row r may attend key c.  Ends with a
// barrier, so the caller may refill sm.k / sm.v / sm.q right after.
// Thread (ty, tx)'s 4 x 4 block of the (BR, BC) dot products q . k: rows
// ty*4 + i, keys tx + 16*j, accumulated in f32.
template <int D>
__device__ __forceinline__ void tile_scores(const float (*q)[D + 1],
                                            const float (*k)[D + 1],
                                            float s[4][4]) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = q[ty * 4 + i][d];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = k[tx + 16 * j][d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
  }
}

template <typename TV, int D, typename Keep>
__device__ void tile_update(TileSmem<D>& sm, Acc<D>& acc, float scale,
                            Keep keep) {
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;

  float s[4][4];
  tile_scores<D>(sm.q, sm.k, s);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = ty * 4 + i, c = tx + 16 * j;
      sm.s[r][c] = keep(r, c) ? s[i][j] * scale : -INFINITY;
    }
  __syncthreads();

  // row statistics: warp w updates rows w*8 .. w*8+7, two keys per lane
  const int warp = tid / 32, lane = tid % 32;
  for (int rr = 0; rr < BR / (NTH / 32); ++rr) {
    const int r = warp * (BR / (NTH / 32)) + rr;
    const float x0 = sm.s[r][lane], x1 = sm.s[r][lane + 32];
    float mx = fmaxf(x0, x1);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    const float m_old = sm.m[r];
    const float m_new = fmaxf(m_old, mx);
    float p0 = 0.f, p1 = 0.f, alpha = 1.f;
    if (m_new != -INFINITY) {
      p0 = (x0 == -INFINITY) ? 0.f : expf(x0 - m_new);
      p1 = (x1 == -INFINITY) ? 0.f : expf(x1 - m_new);
      alpha = (m_old == -INFINITY) ? 0.f : expf(m_old - m_new);
    }
    float sum = p0 + p1;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
    sm.s[r][lane] = round_to<TV>(p0);
    sm.s[r][lane + 32] = round_to<TV>(p1);
    __syncwarp();
    if (lane == 0) {
      sm.m[r] = m_new;
      sm.l[r] = alpha * sm.l[r] + sum;
      sm.alpha[r] = alpha;
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float al = sm.alpha[ty * 4 + i];
#pragma unroll
    for (int j = 0; j < D / 16; ++j) acc.a[i][j] *= al;
  }
#pragma unroll 4
  for (int c = 0; c < BC; ++c) {
    float vv[D / 16];
#pragma unroll
    for (int j = 0; j < D / 16; ++j) vv[j] = sm.v[c][tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float p = sm.s[ty * 4 + i][c];
#pragma unroll
      for (int j = 0; j < D / 16; ++j) acc.a[i][j] = fmaf(p, vv[j], acc.a[i][j]);
    }
  }
  __syncthreads();
}

// Write this split's partial state of the block's rows.  row_index(r)
// gives the flat output row (b, head, t) of folded row r, or -1 for rows
// past the end.  part_acc: (n_split, rows, D); part_ml: (n_split, rows, 2).
template <int D, typename RowIndex>
__device__ void write_partial(const TileSmem<D>& sm, const Acc<D>& acc,
                              float* part_acc, float* part_ml, int split,
                              long long n_rows, RowIndex row_index) {
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    const long long row = row_index(r);
    if (row < 0) continue;
    float* dst = part_acc + ((long long)split * n_rows + row) * D;
#pragma unroll
    for (int j = 0; j < D / 16; ++j) dst[tx + 16 * j] = acc.a[i][j];
    if (tx == 0) {
      part_ml[((long long)split * n_rows + row) * 2] = sm.m[r];
      part_ml[((long long)split * n_rows + row) * 2 + 1] = sm.l[r];
    }
  }
}

// Merge the splits of every output row; one warp per row.  The lanes take
// the splits' maxima, weights and sums 32 splits at a time, so a row with
// many splits (a token step walks one key tile a split) waits on few
// dependent loads.  m_out (may be null) receives the row maxima of the
// scaled, masked scores (-inf for a row with no visible key).
template <typename T, int D>
__global__ void combine_kernel(const float* __restrict__ part_acc,
                               const float* __restrict__ part_ml,
                               int n_split, long long n_rows,
                               T* __restrict__ out, float* __restrict__ m_out) {
  const long long row =
      (long long)blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= n_rows) return;  // uniform over the warp
  auto ml = [&](int s) { return part_ml + ((long long)s * n_rows + row) * 2; };
  float m = -INFINITY;
  for (int s = lane; s < n_split; s += 32) m = fmaxf(m, ml(s)[0]);
#pragma unroll
  for (int k = 16; k > 0; k /= 2)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, k));
  constexpr int PER = (D + 31) / 32;
  float o[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) o[j] = 0.f;
  float l = 0.f;  // this lane's splits
  if (m != -INFINITY) {
    for (int s0 = 0; s0 < n_split; s0 += 32) {
      // lane i: the weight of split s0 + i (0 for a split without keys)
      float w = 0.f;
      if (s0 + lane < n_split) {
        const float ms = ml(s0 + lane)[0];
        if (ms != -INFINITY) {
          w = expf(ms - m);
          l += w * ml(s0 + lane)[1];
        }
      }
      const int n = min(32, n_split - s0);
#pragma unroll 4
      for (int i = 0; i < n; ++i) {
        const float wi = __shfl_sync(0xffffffffu, w, i);
        if (wi == 0.f) continue;  // uniform over the warp
        const float* src = part_acc + ((long long)(s0 + i) * n_rows + row) * D;
#pragma unroll
        for (int j = 0; j < PER; ++j) {
          const int d = lane + 32 * j;
          if (d < D) o[j] = fmaf(wi, src[d], o[j]);
        }
      }
    }
  }
#pragma unroll
  for (int k = 16; k > 0; k /= 2) l += __shfl_xor_sync(0xffffffffu, l, k);
  const float inv = (l == 0.f) ? 1.f : 1.f / l;
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int d = lane + 32 * j;
    if (d < D) out[row * D + d] = from_f<T>(o[j] * inv);
  }
  if (m_out != nullptr && lane == 0) m_out[row] = m;
}

template <typename T, int D>
cudaError_t launch_combine(const float* part_acc, const float* part_ml,
                           int n_split, long long n_rows, void* out,
                           float* m_out, cudaStream_t stream) {
  const int rows_per_block = 8;
  const long long grid = (n_rows + rows_per_block - 1) / rows_per_block;
  combine_kernel<T, D><<<(unsigned)grid, rows_per_block * 32, 0, stream>>>(
      part_acc, part_ml, n_split, n_rows, static_cast<T*>(out), m_out);
  return cudaGetLastError();
}

}  // namespace stc

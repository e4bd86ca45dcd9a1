// Tensor-core tile of the bf16 attention kernels (stream_attention.cu,
// decode_attention.cu), FlashAttention-2 style on mma.sync; decode_score.cu
// uses its block layout, copies, fragments and walk with keys and queries
// in exchanged roles.
//
// A block owns BR folded query rows (GQA: the G query heads of one kv head
// times T tokens, row = g * T + t), 16 or 32 a warp (Cfg), and walks KV
// tiles of 64 keys that it copies into shared memory with cp.async,
// double-buffered (walk), as bf16 rows padded by 16 bytes so that the 8
// rows of one ldmatrix fall in different banks.  Per warp and tile:
//   S = Q K^T   mma.sync.m16n8k16 bf16 -> f32; Q's A fragments come from
//               the block's staged queries (held in registers with one
//               m-tile a warp) and K's B fragments by ldmatrix (with two
//               m-tiles, each B fragment feeds both);
//   softmax     row max over the thread's keys and a quad shuffle; masked
//               terms are -inf, so their p is 2^-inf = 0: selected, never
//               multiplied by a mask;
//   l           sums the unrounded f32 p (this thread's keys; the quad's
//               partial sums are added at the end);
//   O += P V    P packed to bf16 in registers as the A operand (the C
//               fragment of S is the A fragment of P), V by ldmatrix.trans,
//               O in f32 registers.
// The rounding points are those of the FMA tile (attn_common.cuh): score
// operands in bf16, probabilities rounded to bf16 before P @ V, l over the
// unrounded ones.  The order of the f32 sums differs, and exp(x - m) is
// evaluated as 2^(x log2 e - m log2 e) (ex2.approx).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace stc {
namespace tc {

using bf16 = __nv_bfloat16;

constexpr int BC = 64;   // keys per KV tile
constexpr float LOG2E = 1.4426950408889634f;

// The block's layout by head dim.  Up to D = 64, 4 warps of two 16-row
// m-tiles (each K/V fragment feeds both, halving the shared-memory reads
// per product) and two blocks an SM; at D = 128 the (32, 128) f32
// accumulator of two m-tiles does not fit 255 registers, so 8 warps of one
// m-tile and one block an SM.  Measured on the H100 at D = 128: two m-tiles
// with a softmax step of 32 or 16 keys (which spilled in stream_attention)
// were no faster, nor were 4 warps and two blocks an SM.
template <int D>
struct Cfg {
  static constexpr int MT = D <= 64 ? 2 : 1;   // 16-row m-tiles a warp
  static constexpr int NW = D <= 64 ? 4 : 8;   // warps a block
  static constexpr int NTH = 32 * NW;          // threads a block
  static constexpr int BR = 16 * MT * NW;      // folded query rows a block
  static constexpr int MIN_BLOCKS = D <= 64 ? 2 : 1;
  // shared memory: the (BR, D) queries, then two (K, V) tile buffers
  static constexpr int SMEM = (BR + 4 * BC) * (D + 8) * 2;
};

// bf16 elements per shared-memory row of a (rows, D) tile: D + 16 bytes
template <int D>
__host__ __device__ constexpr int pitch() {
  return D + 8;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(const void* p, uint32_t& r0,
                                        uint32_t& r1, uint32_t& r2,
                                        uint32_t& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(const void* p, uint32_t& r0,
                                          uint32_t& r1, uint32_t& r2,
                                          uint32_t& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(smem_u32(p)));
}

// d += a * b on one 16 x 8 x 16 tile, f32 accumulate
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x (MUFU.EX2; 2^-inf = 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two f32 rounded to bf16, the first in the low half
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// cp.async of 16 bytes; src_bytes < 16 zero-fills the rest
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes));
}
// cp.async of 4 bytes; src_bytes 0 writes a zero
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [0, n) of a (n, D) bf16 tile into shared memory at pitch P with
// plain 16-byte loads; row_ptr(r) gives the source row or null for a row
// of zeros.
template <int D, typename RowPtr>
__device__ __forceinline__ void load_rows(bf16* dst, int n, RowPtr row_ptr) {
  constexpr int CH = D / 8;  // 16-byte pieces per row
  for (int i = threadIdx.x; i < n * CH; i += Cfg<D>::NTH) {
    const int r = i / CH, ch = i % CH;
    const bf16* src = row_ptr(r);
    uint4 v = make_uint4(0, 0, 0, 0);
    if (src != nullptr) v = *reinterpret_cast<const uint4*>(src + 8 * ch);
    *reinterpret_cast<uint4*>(dst + r * pitch<D>() + 8 * ch) = v;
  }
}

// cp.async of the (BC, D) bf16 K/V tile whose rows start at src (row stride D)
// into shared memory at pitch P; rows at or past n_valid are zero-filled.
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          int n_valid) {
  constexpr int CH = D / 8;  // 16-byte pieces per row
  for (int j = threadIdx.x; j < BC * CH; j += Cfg<D>::NTH) {
    const int r = j / CH, ch = 8 * (j % CH);
    const bool ok = r < n_valid;
    cp_async16(dst + r * pitch<D>() + ch, ok ? src + r * D + ch : src,
               ok ? 16 : 0);
  }
}

// Shared memory of a block: the block's (BR, D) queries, then two (K, V)
// tile buffers, all at pitch P.
template <int D>
struct Smem {
  bf16* base;
  __device__ explicit Smem(void* p) : base(static_cast<bf16*>(p)) {}
  __device__ bf16* q() const { return base; }
  __device__ bf16* k(int i) const {
    return base + (Cfg<D>::BR + 2 * i * BC) * pitch<D>();
  }
  __device__ bf16* v(int i) const {
    return base + (Cfg<D>::BR + (2 * i + 1) * BC) * pitch<D>();
  }
};

// Where a block sits in the grid (row tile, kv head, batch row x split):
// its BR folded rows g * T + t of the G query heads of kv head h.
template <int D>
struct Block {
  int qt, h, b, split, G, GT, T, Hq;
  __device__ Block(int Hq_, int Hkv, int T_, int n_split)
      : qt(blockIdx.x),
        h(blockIdx.y),
        b(blockIdx.z / n_split),
        split(blockIdx.z % n_split),
        G(Hq_ / Hkv),
        GT(Hq_ / Hkv * T_),
        T(T_),
        Hq(Hq_) {}
  // the flat (b, head, t) row of block row r, -1 past the end; a query or
  // output row of a (B, Hq, T, D) tensor
  __device__ long long row(int r) const {
    const int gr = qt * Cfg<D>::BR + r;
    if (gr >= GT) return -1;
    return ((long long)b * Hq + h * G + gr / T) * T + gr % T;
  }
  // token t of block row r
  __device__ int token(int r) const { return (qt * Cfg<D>::BR + r) % T; }
  // whether the calling warp holds a row before the end (uniform over it)
  __device__ bool warp_live() const {
    return qt * Cfg<D>::BR + (int)threadIdx.x / 32 * 16 * Cfg<D>::MT < GT;
  }
  // the block's rows of q (B, Hq, T, D) into qs (zeros past the end)
  __device__ void stage(bf16* qs, const void* q) const {
    load_rows<D>(qs, Cfg<D>::BR, [&](int r) -> const bf16* {
      const long long i = row(r);
      return i < 0 ? nullptr : static_cast<const bf16*>(q) + i * D;
    });
  }
};

// The double-buffered walk over a split's KV tiles: tiles split, split +
// n_split, ... below n_tiles for which live(tile) holds.  load(tile, i)
// issues the cp.async copies of a tile into buffer i; step(tile, i) runs
// once they have landed, between block barriers.  The copies of the next
// tile overlap the step of the current one.
template <typename Live, typename Load, typename Step>
__device__ __forceinline__ void walk(int split, int n_split, int n_tiles,
                                     Live live, Load load, Step step) {
  auto next = [&](int t) -> int {
    for (; t < n_tiles; t += n_split)
      if (live(t)) return t;
    return -1;
  };
  int cur = next(split), bi = 0;
  if (cur >= 0) load(cur, 0);
  cp_async_commit();
  while (cur >= 0) {  // uniform over the block
    const int nxt = next(cur + n_split);
    if (nxt >= 0) load(nxt, bi ^ 1);
    cp_async_commit();       // one group a tile, empty past the last
    cp_async_wait<1>();      // cur's group has landed
    __syncthreads();
    step(cur, bi);
    __syncthreads();  // every warp done with buffer bi before its refill
    bi ^= 1;
    cur = nxt;
  }
}

// One warp's state for its MT m-tiles of 16 rows: the (16 MT, D) f32
// accumulator in C fragments and, per thread, the running max and partial
// sum of its rows k = 2 * mt + ri, ri = 0 for row lane / 4 of m-tile mt
// and 1 for row lane / 4 + 8.
template <int D>
struct Warp {
  static constexpr int MT = Cfg<D>::MT;
  // with one m-tile, its A fragments stay in registers (load_q); with two
  // they are read from the staged queries at each k-step
  uint32_t q[MT == 1 ? D / 16 : 1][4];
  float o[MT][D / 8][4];
  float m[2 * MT], l[2 * MT];
};

template <int D>
__device__ __forceinline__ void warp_init(Warp<D>& w) {
  constexpr int MT = Cfg<D>::MT;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) w.o[mt][j][e] = 0.f;
#pragma unroll
  for (int k = 0; k < 2 * MT; ++k) {
    w.m[k] = -INFINITY;
    w.l[k] = 0.f;
  }
}

// The block row (0 .. BR) of the thread's row k.
template <int D>
__device__ __forceinline__ int row_of(int k) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  return warp * 16 * Cfg<D>::MT + (k / 2) * 16 + lane / 4 + 8 * (k % 2);
}

// The A fragments of a one-m-tile warp's rows from the staged (BR, D)
// queries qs (a no-op with two m-tiles).
template <int D>
__device__ __forceinline__ void load_q(Warp<D>& w, const bf16* qs) {
  if constexpr (Cfg<D>::MT == 1) {
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    const bf16* row =
        qs + (warp * 16 + lane % 16) * pitch<D>() + (lane / 16) * 8;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      ldsm_x4(row + 16 * kk, w.q[kk][0], w.q[kk][1], w.q[kk][2], w.q[kk][3]);
  }
}

// One online-softmax update of the warp's rows, whose (BR, D) queries are
// staged at qs (and, with one m-tile, loaded by load_q), with the (BC, D)
// tiles ks and vs.  keep(k, c): whether the thread's row k may attend key
// c of the tile.
template <int D, typename Keep>
__device__ __forceinline__ void update(Warp<D>& w, const bf16* qs,
                                       const bf16* ks, const bf16* vs,
                                       float scale, Keep keep) {
  constexpr int P = pitch<D>(), MT = Cfg<D>::MT;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int tig = lane % 4;

  float s[MT][BC / 8][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < BC / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[mt][j][e] = 0.f;
  // S = Q K^T.  Per k-step: the A fragments of both m-tiles and the B
  // fragments of all keys (one x4 ldmatrix gives both k-halves of two
  // 8-key n-tiles), then the products; each B fragment feeds both m-tiles.
  const bf16* qrow = qs + (warp * 16 * MT + lane % 16) * P + (lane / 16) * 8;
  const bf16* krow =
      ks + ((lane / 16) * 8 + lane % 8) * P + ((lane / 8) % 2) * 8;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[MT][4], b[BC / 16][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      if constexpr (MT == 1) {
#pragma unroll
        for (int e = 0; e < 4; ++e) a[mt][e] = w.q[kk][e];
      } else {
        ldsm_x4(qrow + mt * 16 * P + kk * 16, a[mt][0], a[mt][1], a[mt][2],
                a[mt][3]);
      }
    }
#pragma unroll
    for (int jp = 0; jp < BC / 16; ++jp)
      ldsm_x4(krow + jp * 16 * P + kk * 16, b[jp][0], b[jp][1], b[jp][2],
              b[jp][3]);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int jp = 0; jp < BC / 16; ++jp) {
        mma(s[mt][2 * jp], a[mt], b[jp][0], b[jp][1]);
        mma(s[mt][2 * jp + 1], a[mt], b[jp][2], b[jp][3]);
      }
  }

  // mask (a masked raw score becomes -inf) and the row maxima of the raw
  // scores; C fragment: s[mt][j][2 * ri + e] is row (mt, ri), key 8 * j +
  // 2 * tig + e.  Four partial maxima and sums a row keep the dependency
  // chains short.
  float alpha[2 * MT];
  const float c = scale * LOG2E;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    float mx[2][4];
#pragma unroll
    for (int ri = 0; ri < 2; ++ri)
#pragma unroll
      for (int k = 0; k < 4; ++k) mx[ri][k] = -INFINITY;
#pragma unroll
    for (int j = 0; j < BC / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ri = e / 2;
        const float x =
            keep(2 * mt + ri, 8 * j + 2 * tig + e % 2) ? s[mt][j][e]
                                                       : -INFINITY;
        s[mt][j][e] = x;
        mx[ri][j % 4] = fmaxf(mx[ri][j % 4], x);
      }
#pragma unroll
    for (int ri = 0; ri < 2; ++ri) {
      const int k = 2 * mt + ri;
      float m =
          fmaxf(fmaxf(mx[ri][0], mx[ri][1]), fmaxf(mx[ri][2], mx[ri][3]));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
      // m is kept as the max of the scaled scores (scale > 0, so max(s) *
      // scale is the max of s * scale, bit for bit)
      const float m_old = w.m[k];
      const float m_new = fmaxf(m_old, m * scale);
      // where m_new is -inf every term is masked: any finite reference
      // will do
      const float m_ref = (m_new == -INFINITY) ? 0.f : m_new * LOG2E;
      alpha[k] = ex2(m_old * LOG2E - m_ref);  // 0 while m_old is -inf
      // p = exp(s * scale - m) as 2^(s * scale * log2 e - m * log2 e); a
      // masked term is 2^-inf = 0
      float sum[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int j = 0; j < BC / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[mt][j][2 * ri + e];
          x = ex2(fmaf(x, c, -m_ref));
          sum[j % 4] += x;
        }
      w.m[k] = m_new;
      w.l[k] = alpha[k] * w.l[k] + ((sum[0] + sum[1]) + (sum[2] + sum[3]));
    }
  }
  // rescale the accumulator, unless no row max of the warp moved
  bool moved = false;
#pragma unroll
  for (int k = 0; k < 2 * MT; ++k) moved |= alpha[k] != 1.f;
  if (__any_sync(0xffffffffu, moved)) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        w.o[mt][j][0] *= alpha[2 * mt];
        w.o[mt][j][1] *= alpha[2 * mt];
        w.o[mt][j][2] *= alpha[2 * mt + 1];
        w.o[mt][j][3] *= alpha[2 * mt + 1];
      }
  }

  // O += P V, 16 keys at a time; one x4 ldmatrix.trans gives both key
  // halves of two 8-dim n-tiles of V, which feed both m-tiles
  const bf16* vrow =
      vs + (((lane / 8) % 2) * 8 + lane % 8) * P + (lane / 16) * 8;
  // fragments loaded together
  constexpr int NB = D / 16 < 4 / MT ? D / 16 : 4 / MT;
#pragma unroll
  for (int kc = 0; kc < BC / 16; ++kc) {
    uint32_t a[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      a[mt][0] = pack(s[mt][2 * kc][0], s[mt][2 * kc][1]);
      a[mt][1] = pack(s[mt][2 * kc][2], s[mt][2 * kc][3]);
      a[mt][2] = pack(s[mt][2 * kc + 1][0], s[mt][2 * kc + 1][1]);
      a[mt][3] = pack(s[mt][2 * kc + 1][2], s[mt][2 * kc + 1][3]);
    }
#pragma unroll
    for (int d0 = 0; d0 < D / 16; d0 += NB) {
      uint32_t b[NB][4];
#pragma unroll
      for (int u = 0; u < NB; ++u)
        ldsm_x4_t(vrow + kc * 16 * P + (d0 + u) * 16, b[u][0], b[u][1],
                  b[u][2], b[u][3]);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int u = 0; u < NB; ++u) {
          mma(w.o[mt][2 * (d0 + u)], a[mt], b[u][0], b[u][1]);
          mma(w.o[mt][2 * (d0 + u) + 1], a[mt], b[u][2], b[u][3]);
        }
    }
  }
}

// Write the warp's partial state for the block's rows.  part_acc:
// (n_split, rows, D); part_ml: (n_split, rows, 2).
template <int D>
__device__ __forceinline__ void write_partial(Warp<D>& w, const Block<D>& blk,
                                              float* part_acc,
                                              float* part_ml,
                                              long long n_rows) {
  const int tig = threadIdx.x % 4;
#pragma unroll
  for (int k = 0; k < 2 * Cfg<D>::MT; ++k) {
    float l = w.l[k];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const long long row = blk.row(row_of<D>(k));
    if (row < 0) continue;
    const long long at = (long long)blk.split * n_rows + row;
    float* dst = part_acc + at * D + 2 * tig;
    const int mt = k / 2, e = 2 * (k % 2);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<float2*>(dst + 8 * j) =
          make_float2(w.o[mt][j][e], w.o[mt][j][e + 1]);
    if (tig == 0) {
      part_ml[at * 2] = w.m[k];
      part_ml[at * 2 + 1] = l;
    }
  }
}

}  // namespace tc
}  // namespace stc

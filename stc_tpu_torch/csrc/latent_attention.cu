// Paged streaming encode attention over latent rows (absorbed multi-head
// latent attention, ops/latent_attention.py): one joint softmax over
//
//   [init rows @ window RoPE | window pages | init rows @ one angle]
//
// of B streams, each row [c (512) | k_pe (64)] bf16 shared by every query
// head: a score runs over all 576 dims, the value is the first 512.  The
// page cover, positions, masks and scalars are stream_attention.cu's.
//
// Tile (latent_attention_tc): a block owns 64 query rows (row = t * Hq + h
// of the (B, T, Hq, 576) queries: 4 m-tiles of 16) and walks key tiles of
// 32 rows: tile 0 the init rows at the window angle, tiles 1 .. n_cov the
// page cover, tile n_cov + 1 the init rows again, scored with the
// queries' rope dims at the one angle (staged apart).  A pre-pass
// (latent_attention_rope) rotates the rope dims of every cover key once
// (f32, rounded to bf16, as stream_attention's cover pre-pass does) into
// a (B, Lc, 64) scratch; a tile is copied with cp.async, its first 512
// dims from the pages and its last 64 from the scratch (double-buffered,
// tc::walk).  8 warps: the two warps of an m-tile each compute S for 16 of
// the 32 keys over all 576 dims (four accumulator chains) and swap them
// through shared memory, so each holds the whole S; each then accumulates
// P V for its 256 of the 512 value dims (128 f32 registers).
// Splits of the key walk are merged by stream_attention's combine kernel.
// Rounding points are the plain version's: bf16 operands, probabilities
// rounded to bf16 before P V, l over the unrounded ones.

#include "attn_common.cuh"
#include "attn_tc.cuh"

namespace stc {
namespace lat {

using tc::bf16;

constexpr int W = 576;          // row width
constexpr int R = 512;          // value dims (kv_lora_rank)
constexpr int P = 64;           // rope dims
constexpr int BR = 64;          // query rows a block
constexpr int BC = 32;          // keys a tile
constexpr int NTH = 256;        // 8 warps
constexpr int PW = W + 8;       // smem pitch of a row (16 bytes of pad)
constexpr int PP = P + 8;       // smem pitch of a staged rope row
constexpr int RH = R / 2;       // value dims a warp
// shared memory: queries, the one-angle rope dims, two key tiles, the
// S exchange (4 m-tiles x 2 halves x 32 lanes x 8 floats)
constexpr int SMEM = (BR + 2 * BC) * PW * 2 + BR * PP * 2 + 4 * 2 * 32 * 8 * 4;

struct Args {
  const bf16* q_rot;      // (B, T, Hq, W)
  const bf16* q_one;      // (B, T, Hq, W)
  const bf16* block_c;    // (B, Nb, S, W)
  const float* cos_cover;  // (B, Lc, P)
  const float* sin_cover;
  const bf16* k_init_rot;  // (B, n_init, W)
  const bf16* k_init_raw;
  const int* scalars;      // (B, 5)
  bf16* rope;              // (B, Lc, P) scratch: the cover's rope dims
  float* part_acc;         // (n_split, B * T * Hq, R)
  float* part_ml;          // (n_split, B * T * Hq, 2)
  int B, Hq, T, Nb, S, Lc, ppt, n_init, n_local, n_split;
  float scale;
};

// The rope dims of each cover key rotated at its cover angle (rotate-half),
// rounded to bf16, into a.rope; keys outside the store are zero.
__global__ void latent_attention_rope(const Args a) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long n = (long long)a.B * a.Lc * (P / 2);
  if (i >= n) return;
  const int d = (int)(i % (P / 2));
  const long long bc = i / (P / 2);
  const int b = (int)(bc / a.Lc);
  const long long c = bc % a.Lc;
  const long long page = (long long)a.scalars[5 * b + 1] * a.ppt + c / a.S;
  bf16* dst = a.rope + bc * P + d;
  if (page >= a.Nb) {
    dst[0] = dst[P / 2] = __float2bfloat16_rn(0.f);
    return;
  }
  const bf16* x = a.block_c + ((b * (long long)a.Nb + page) * a.S + c % a.S)
                  * W + R + d;
  const float x1 = __bfloat162float(x[0]), x2 = __bfloat162float(x[P / 2]);
  const float cs = a.cos_cover[bc * P + d], sn = a.sin_cover[bc * P + d];
  dst[0] = __float2bfloat16_rn(__fadd_rn(__fmul_rn(x1, cs),
                                         __fmul_rn(-x2, sn)));
  dst[P / 2] = __float2bfloat16_rn(__fadd_rn(__fmul_rn(x2, cs),
                                             __fmul_rn(x1, sn)));
}

__global__ void __launch_bounds__(NTH, 1)
    latent_attention_tc(const Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* kbuf = qs + BR * PW;
  bf16* qone = kbuf + 2 * BC * PW;
  float* sx = reinterpret_cast<float*>(qone + BR * PP);

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int mt = warp % 4, half = warp / 4;
  const int g = lane / 4, tig = lane % 4;
  const int qt = blockIdx.x, split = blockIdx.y, b = blockIdx.z;
  const int rows = a.T * a.Hq;
  const int row0 = qt * BR;

  const int* sc = a.scalars + 5 * b;
  const int L = sc[0], start_tile = sc[1], total = sc[2];
  const int init_active = sc[3], offset = sc[4];
  // the cover's key c sits at position base + c; keys at or past c_lim are
  // outside the store or not yet written
  const long long first_page = (long long)start_tile * a.ppt;
  const long long base = a.n_init + (offset + first_page) * a.S;
  const long long c_lim = min((long long)a.Lc,
                              min((a.Nb - first_page) * a.S,
                                  (total - offset - first_page) * a.S));
  const int n_cov = (a.Lc + BC - 1) / BC;
  const int n_tiles = n_cov + 2;
  const int t_lo = row0 / a.Hq;
  const int t_hi = (min(row0 + BR, rows) - 1) / a.Hq;

  // stage the block's queries and the rope dims of its one-angle queries
  const long long qrow0 = (long long)b * rows + row0;
  for (int i = threadIdx.x; i < BR * (W / 8); i += NTH) {
    const int r = i / (W / 8), ch = 8 * (i % (W / 8));
    const bool ok = row0 + r < rows;
    tc::cp_async16(qs + r * PW + ch,
                   ok ? a.q_rot + (qrow0 + r) * W + ch : a.q_rot,
                   ok ? 16 : 0);
  }
  for (int i = threadIdx.x; i < BR * (P / 8); i += NTH) {
    const int r = i / (P / 8), ch = 8 * (i % (P / 8));
    const bool ok = row0 + r < rows;
    tc::cp_async16(qone + r * PP + ch,
                   ok ? a.q_one + (qrow0 + r) * W + R + ch : a.q_one,
                   ok ? 16 : 0);
  }

  auto live = [&](int t) -> bool {
    if (t == 0) return true;
    if (t == n_tiles - 1) return init_active != 0;
    const long long c0 = (long long)(t - 1) * BC;
    const long long c1 = min(c0 + BC, c_lim) - 1;  // last valid key
    if (c1 < c0) return false;
    // some (query, key) distance within [0, n_local)
    return base + c0 <= (long long)L + t_hi &&
           base + c1 > (long long)L + t_lo - a.n_local;
  };
  auto load = [&](int t, int i) {
    bf16* dst = kbuf + i * BC * PW;
    for (int j = threadIdx.x; j < BC * (W / 8); j += NTH) {
      const int r = j / (W / 8), ch = 8 * (j % (W / 8));
      const bf16* src = nullptr;
      if (t == 0 || t == n_tiles - 1) {
        if (r < a.n_init)
          src = (t == 0 ? a.k_init_rot : a.k_init_raw) +
                ((long long)b * a.n_init + r) * W + ch;
      } else {
        const long long c = (long long)(t - 1) * BC + r;
        if (c < a.Lc && ch >= R)
          src = a.rope + ((long long)b * a.Lc + c) * P + ch - R;
        else if (c < a.Lc && first_page + c / a.S < a.Nb)
          src = a.block_c +
                (((long long)b * a.Nb + first_page + c / a.S) * a.S +
                 c % a.S) * W + ch;
      }
      tc::cp_async16(dst + r * PW + ch, src ? src : a.block_c,
                     src ? 16 : 0);
    }
  };

  float o[RH / 8][4];
#pragma unroll
  for (int j = 0; j < RH / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  const float c2 = a.scale * tc::LOG2E;

  auto step = [&](int t, int i) {
    const bf16* ks = kbuf + i * BC * PW;
    // S for this warp's 16 keys (half * 16 ..) over all 576 dims, in four
    // chains (two n-tiles x even and odd k-steps)
    float s[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    {
      float acc[2][2][4];
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[u][j][e] = 0.f;
      const bf16* qrow = qs + (mt * 16 + lane % 16) * PW + (lane / 16) * 8;
      const bf16* orow = qone + (mt * 16 + lane % 16) * PP + (lane / 16) * 8;
      const bf16* krow = ks + (half * 16 + (lane / 16) * 8 + lane % 8) * PW +
                         ((lane / 8) % 2) * 8;
      const bool far = t == n_tiles - 1;
#pragma unroll 4
      for (int kk = 0; kk < W / 16; ++kk) {
        uint32_t af[4], bf[4];
        if (far && kk >= R / 16)
          tc::ldsm_x4(orow + (kk - R / 16) * 16, af[0], af[1], af[2], af[3]);
        else
          tc::ldsm_x4(qrow + kk * 16, af[0], af[1], af[2], af[3]);
        tc::ldsm_x4(krow + kk * 16, bf[0], bf[1], bf[2], bf[3]);
        tc::mma(acc[kk % 2][0], af, bf[0], bf[1]);
        tc::mma(acc[kk % 2][1], af, bf[2], bf[3]);
      }
      // swap with the other warp of the m-tile: both halves go through
      // shared memory and come back in key order (an index into s that
      // depends on the warp would put s in local memory)
      float* me = sx + ((mt * 2 + half) * 32 + lane) * 8;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        me[e] = acc[0][0][e] + acc[1][0][e];
        me[4 + e] = acc[0][1][e] + acc[1][1][e];
      }
      asm volatile("bar.sync %0, 64;\n" ::"r"(1 + mt));
      const float* s0 = sx + ((mt * 2) * 32 + lane) * 8;
      const float* s1 = sx + ((mt * 2 + 1) * 32 + lane) * 8;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[0][e] = s0[e];
        s[1][e] = s0[4 + e];
        s[2][e] = s1[e];
        s[3][e] = s1[4 + e];
      }
    }
    // masks: C fragment s[j][2 * ri + e] is row mt * 16 + g + 8 ri, key
    // 8 j + 2 tig + e
    float alpha[2];
#pragma unroll
    for (int ri = 0; ri < 2; ++ri) {
      const int r = row0 + mt * 16 + g + 8 * ri;
      const bool row_ok = r < rows;
      const long long qpos = (long long)L + (row_ok ? r / a.Hq : 0);
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kk = 8 * j + 2 * tig + e;
          bool ok = row_ok;
          if (t == 0) {
            const long long d = qpos - kk;
            ok = ok && kk < a.n_init && d >= 0 && d < a.n_local;
          } else if (t == n_tiles - 1) {
            ok = ok && kk < a.n_init;
          } else {
            const long long c = (long long)(t - 1) * BC + kk;
            const long long d = qpos - (base + c);
            ok = ok && c < c_lim && d >= 0 && d < a.n_local;
          }
          float& x = s[j][2 * ri + e];
          x = ok ? x : -INFINITY;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run[ri], mx * a.scale);
      const float m_ref = (m_new == -INFINITY) ? 0.f : m_new * tc::LOG2E;
      alpha[ri] = tc::ex2(m_run[ri] * tc::LOG2E - m_ref);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[j][2 * ri + e];
          x = tc::ex2(fmaf(x, c2, -m_ref));
          sum += x;
        }
      m_run[ri] = m_new;
      l_run[ri] = alpha[ri] * l_run[ri] + sum;
    }
#pragma unroll
    for (int j = 0; j < RH / 8; ++j) {
      o[j][0] *= alpha[0];
      o[j][1] *= alpha[0];
      o[j][2] *= alpha[1];
      o[j][3] *= alpha[1];
    }
    // O += P V over this warp's 256 value dims
    const bf16* vrow = ks + (((lane / 8) % 2) * 8 + lane % 8) * PW +
                       half * RH + (lane / 16) * 8;
#pragma unroll
    for (int kc = 0; kc < 2; ++kc) {
      uint32_t af[4];
      af[0] = tc::pack(s[2 * kc][0], s[2 * kc][1]);
      af[1] = tc::pack(s[2 * kc][2], s[2 * kc][3]);
      af[2] = tc::pack(s[2 * kc + 1][0], s[2 * kc + 1][1]);
      af[3] = tc::pack(s[2 * kc + 1][2], s[2 * kc + 1][3]);
#pragma unroll
      for (int d0 = 0; d0 < RH / 16; ++d0) {
        uint32_t bf[4];
        tc::ldsm_x4_t(vrow + kc * 16 * PW + d0 * 16, bf[0], bf[1], bf[2],
                      bf[3]);
        tc::mma(o[2 * d0], af, bf[0], bf[1]);
        tc::mma(o[2 * d0 + 1], af, bf[2], bf[3]);
      }
    }
  };

  tc::walk(split, a.n_split, n_tiles, live, load, step);

  // the partial sums of the quad, then this split's state of each row
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    l_run[ri] += __shfl_xor_sync(0xffffffffu, l_run[ri], 1);
    l_run[ri] += __shfl_xor_sync(0xffffffffu, l_run[ri], 2);
  }
  const long long n_rows = (long long)a.B * rows;
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    const int r = row0 + mt * 16 + g + 8 * ri;
    if (r >= rows) continue;
    const long long row = (long long)b * rows + r;
    float* dst = a.part_acc + ((long long)split * n_rows + row) * R +
                 half * RH + 2 * tig;
#pragma unroll
    for (int j = 0; j < RH / 8; ++j)
      *reinterpret_cast<float2*>(dst + 8 * j) =
          make_float2(o[j][2 * ri], o[j][2 * ri + 1]);
    if (half == 0 && tig == 0) {
      a.part_ml[((long long)split * n_rows + row) * 2] = m_run[ri];
      a.part_ml[((long long)split * n_rows + row) * 2 + 1] = l_run[ri];
    }
  }
}

cudaError_t launch(const Args& a, void* out, cudaStream_t stream,
                   int* tile) {
  cudaError_t err = cudaFuncSetAttribute(
      latent_attention_tc, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM);
  if (err != cudaSuccess) return err;
  if (tile != nullptr) {
    tile[0] = BR;
    tile[1] = BC;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &tile[2], latent_attention_tc, NTH, SMEM);
  }
  const long long n_rope = (long long)a.B * a.Lc * (P / 2);
  latent_attention_rope<<<(unsigned)((n_rope + 255) / 256), 256, 0,
                          stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dim3 grid((a.T * a.Hq + BR - 1) / BR, a.n_split, a.B);
  latent_attention_tc<<<grid, NTH, SMEM, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_combine<bf16, R>(a.part_acc, a.part_ml, a.n_split,
                                 (long long)a.B * a.T * a.Hq, out, nullptr,
                                 stream);
}

}  // namespace lat
}  // namespace stc

// tile[0] query rows a block, tile[1] keys a tile, tile[2] blocks an SM
// holds at once.  The wrapper sizes its grid and scratch from it.
extern "C" int stc_latent_attention_tile(int* tile) {
  stc::lat::Args a{};
  return (int)stc::lat::launch(a, nullptr, nullptr, tile);
}

// bfloat16 rows of 576 dims (512 + 64 rope).  q_rot, q_one: (B, T, Hq, 576);
// block_c: (B, Nb, S, 576); cos_cover, sin_cover: (B, Lc, 64) f32;
// k_init_rot, k_init_raw: (B, n_init, 576); scalars: (B, 5) int32 as
// stream_attention's; rope (B, Lc, 64) bf16 scratch; part_acc
// (n_split, B T Hq, 512) and part_ml
// (n_split, B T Hq, 2) f32 scratch; out (B, T, Hq, 512).  Every bf16
// pointer 16-byte aligned.  Returns cudaGetLastError() after the launches.
extern "C" int stc_latent_attention(
    const void* q_rot, const void* q_one, const void* block_c,
    const void* cos_cover, const void* sin_cover, const void* k_init_rot,
    const void* k_init_raw, const void* scalars, void* rope, void* part_acc,
    void* part_ml, void* out, int B, int Hq, int T, int Nb, int S, int Lc,
    int ppt, int n_init, int n_local, int n_split, float scale,
    void* stream) {
  using stc::lat::bf16;
  stc::lat::Args a;
  a.q_rot = static_cast<const bf16*>(q_rot);
  a.q_one = static_cast<const bf16*>(q_one);
  a.block_c = static_cast<const bf16*>(block_c);
  a.cos_cover = static_cast<const float*>(cos_cover);
  a.sin_cover = static_cast<const float*>(sin_cover);
  a.k_init_rot = static_cast<const bf16*>(k_init_rot);
  a.k_init_raw = static_cast<const bf16*>(k_init_raw);
  a.scalars = static_cast<const int*>(scalars);
  a.rope = static_cast<bf16*>(rope);
  a.part_acc = static_cast<float*>(part_acc);
  a.part_ml = static_cast<float*>(part_ml);
  a.B = B;
  a.Hq = Hq;
  a.T = T;
  a.Nb = Nb;
  a.S = S;
  a.Lc = Lc;
  a.ppt = ppt;
  a.n_init = n_init;
  a.n_local = n_local;
  a.n_split = n_split;
  a.scale = scale;
  if (n_init > stc::lat::BC || n_split < 1) return (int)cudaErrorInvalidValue;
  const void* ptrs[] = {q_rot, q_one, block_c, k_init_rot, k_init_raw,
                        rope,  out};
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0)
      return (int)cudaErrorMisalignedAddress;
  return (int)stc::lat::launch(a, out, static_cast<cudaStream_t>(stream),
                               nullptr);
}

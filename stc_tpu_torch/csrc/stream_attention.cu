// Paged streaming encode attention for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas kernel stc_tpu/ops/stream_attention.py::_kernel
// (wrapper stream_attention), all three page kinds: 1a pages in the input
// dtype, 1b int8 pages and 1c packed int4 pages, each quantized kind with
// f32 scales per (page, dim).  One joint online softmax over three key
// groups of a video append:
//   1. the init tokens under window RoPE (k_init_rot), mask
//      0 <= q_pos - j < n_local;
//   2. the window pages, read in place from the append-only page store
//      (B, Hkv, Nb, S, D) starting at page start_tile * ppt, dequantized in
//      f32 where quantized, RoPE applied to each key from the cover tables
//      (f32, rounded to the input dtype), mask 0 <= q_pos - pos < n_local
//      and abs_page < total, where the key at cover index c has
//      pos = n_init + (start_page + offset) * S + c;
//   3. the unrotated init keys against the one-angle queries, gated by
//      init_active.
// GQA is folded into the query rows; tiles holding no live key are skipped;
// the KV walk of a row tile is split over blocks and merged by
// combine_kernel; the output is normalised by l and 0 where l == 0.
//
// Window compression (page_keep, optional): a (B, Nb, S) byte mask over the
// store's page slots.  A window key at cover index c lies in page slot
// start_page + c / S (the slot its row is read from) at row c % S, and is
// masked unless its keep byte is set (the JAX engine's jnp path ANDs the
// window's keep rows into the window mask and runs no Pallas kernel).  The
// init groups are never masked, and the tile skip stays a position test: a
// live tile whose keys are all dropped is computed and adds nothing.  Both
// tiles take the mask as a template flag (KEEP): a null page_keep launches
// the KEEP = false instances, the unmasked code unchanged.  The bf16 tile
// copies each KV tile's 64 keep bytes into shared memory beside its keys
// (one byte a key, double-buffered with them) and masks from there.
//
// Bound on the H100: one 8-page append (T 480) over the full 264-page
// window at llava-ov-7b heads (28/4 of 128) does ~103 GFLOP of visible
// (query, key) pairs, 0.104 ms at the dense bf16 rate, and reads ~16 MB of
// int8 pages: operations bound it.  A 1-frame append at llava-ov-0.5b heads
// does ~3.2 GFLOP (3.3 us) against ~7.7 MB of bf16 pages (2.3 us).
//
// Design.  bf16 queries take two kernels.  A pre-pass reads each live
// window tile once per kv head: it dequantizes the page rows in f32 (int8 x
// scale; both nibbles of a packed int4 byte are a dim and its rotate-half
// partner), rotates the keys with the f32 cover tables (whose two halves
// are equal, so it reads the first) and writes MMA-ready bf16 keys and
// values, (B, Hkv, Lc, D), to scratch.  The attention then runs the
// tensor-core tile of attn_tc.cuh (128 folded rows a block, 64-key tiles),
// copying those rows with cp.async into padded shared-memory tiles,
// double-buffered against the previous tile's products.  A transform
// inside the attention would be repeated for every 128-row tile (27 times
// on an 8-page append at llava-ov-7b heads) and, measured on the H100,
// cost as much as the products it sat between.  float32 queries keep the
// FP32-FMA tile of attn_common.cuh (64 x 64), so their score operands stay
// in float32.  stc_stream_attention_tile reports the tile each dtype runs;
// the wrapper sizes its split from it.

#include <stdint.h>

#include <type_traits>

#include "attn_common.cuh"
#include "attn_tc.cuh"

namespace stc {

// One page row's element d and its rotate-half partner (negated for
// d < D/2), dequantized in f32.  `sc` is the page's scale row (D floats);
// pages in the input dtype have none.
template <int D>
__device__ __forceinline__ void page_pair(const float* row, const float*,
                                          int d, float& x, float& xr) {
  x = row[d];
  xr = (d < D / 2) ? -row[d + D / 2] : row[d - D / 2];
}
template <int D>
__device__ __forceinline__ void page_pair(const __nv_bfloat16* row,
                                          const float*, int d, float& x,
                                          float& xr) {
  x = to_f(row[d]);
  xr = (d < D / 2) ? -to_f(row[d + D / 2]) : to_f(row[d - D / 2]);
}
template <int D>
__device__ __forceinline__ void page_pair(const int8_t* row, const float* sc,
                                          int d, float& x, float& xr) {
  const int p = (d < D / 2) ? d + D / 2 : d - D / 2;
  x = (float)row[d] * sc[d];
  const float y = (float)row[p] * sc[p];
  xr = (d < D / 2) ? -y : y;
}
// split-plane int4: byte j holds dim j (low nibble) and dim j + D/2 (high
// nibble), so d and its partner come from one byte
__device__ __forceinline__ float nibble(int v) {
  return (float)(v > 7 ? v - 16 : v);
}
template <int D>
__device__ __forceinline__ void page_pair(const uint8_t* row, const float* sc,
                                          int d, float& x, float& xr) {
  const int byte = row[d % (D / 2)];
  const float lo = nibble(byte & 0x0F), hi = nibble(byte >> 4);
  if (d < D / 2) {
    x = lo * sc[d];
    xr = -(hi * sc[d + D / 2]);
  } else {
    x = hi * sc[d];
    xr = lo * sc[d - D / 2];
  }
}

// One page row's element d, dequantized in f32 and rounded to T.
template <typename T, int D>
__device__ __forceinline__ float page_val(const T* row, const float*, int d) {
  return to_f(row[d]);
}
template <typename T, int D>
__device__ __forceinline__ float page_val(const int8_t* row, const float* sc,
                                          int d) {
  return round_to<T>((float)row[d] * sc[d]);
}
template <typename T, int D>
__device__ __forceinline__ float page_val(const uint8_t* row, const float* sc,
                                          int d) {
  const int byte = row[d % (D / 2)];
  const float q = nibble(d < D / 2 ? (byte & 0x0F) : (byte >> 4));
  return round_to<T>(q * sc[d]);
}

struct StreamArgs {
  const void* q_rot;       // (B, Hq, T, D)
  const void* q_one;       // (B, Hq, T, D)
  const void* block_k;     // (B, Hkv, Nb, S, D) unrotated
  const void* block_v;     // (B, Hkv, Nb, S, D); D/2 bytes a row for int4
  const float* k_scales;   // (B, Hkv, Nb, D), quantized pages only
  const float* v_scales;
  const float* cos_cover;  // (B, Lc, D)
  const float* sin_cover;  // (B, Lc, D)
  const void* k_init_rot;  // (B, Hkv, n_init, D)
  const void* v_init;      // (B, Hkv, n_init, D)
  const void* k_init_raw;  // (B, Hkv, n_init, D)
  const int* scalars;      // (B, 5): L, start_tile, total, init_active, offset
  const uint8_t* page_keep;  // (B, Nb, S) window keep bytes, or null
  float* part_acc;         // (n_split, B*Hq*T, D)
  float* part_ml;          // (n_split, B*Hq*T, 2)
  __nv_bfloat16* cover_k;  // (B, Hkv, Lc, D) scratch of the bf16 kernel
  __nv_bfloat16* cover_v;
  int B, Hq, Hkv, T, Nb, S, Lc, ppt, n_init, n_local, n_split;
};

// T: queries, init keys and output; P: page elements (T, int8_t or packed
// uint8_t); KEEP: the window keys are masked by a.page_keep
template <typename T, typename P, int D, bool KEEP>
__global__ void __launch_bounds__(NTH)
stream_attention_kernel(StreamArgs a) {
  constexpr int DP = std::is_same<P, uint8_t>::value ? D / 2 : D;
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

  const int L = a.scalars[b * 5 + 0];
  const int start_page = a.scalars[b * 5 + 1] * a.ppt;
  const int total = a.scalars[b * 5 + 2];
  const int init_active = a.scalars[b * 5 + 3];
  const int offset = a.scalars[b * 5 + 4];
  // position of the key at cover index c is pos_base + c
  const long long pos_base =
      (long long)a.n_init + (long long)(start_page + offset) * a.S;
  const long long pos_end = (long long)a.n_init + (long long)total * a.S;
  const int c_store = (a.Nb - start_page) * a.S;  // cover keys in the store
  const int c_lim = min(a.Lc, max(c_store, 0));
  // keep byte of cover key c (c < c_lim) is keep_row[c]: the store's page
  // slots are consecutive rows of S bytes
  const uint8_t* keep_row =
      a.page_keep + ((long long)b * a.Nb + start_page) * a.S;

  const T* q_rot = static_cast<const T*>(a.q_rot);
  const T* q_one = static_cast<const T*>(a.q_one);
  const P* bk = static_cast<const P*>(a.block_k);
  const P* bv = static_cast<const P*>(a.block_v);

  // folded row r -> (head, t); rows past G*T stay masked
  auto q_row_ptr = [&](const T* q, int r) -> const T* {
    const int gr = qt * BR + r;
    const int g = gr / a.T, t = gr % a.T;
    return q + (((long long)b * a.Hq + h * G + g) * a.T + t) * D;
  };
  auto load_q = [&](const T* q) {
    for (int i = tid; i < BR * D; i += NTH) {
      const int r = i / D, d = i % D;
      const int gr = qt * BR + r;
      sm.q[r][d] = (gr < GT) ? to_f(q_row_ptr(q, r)[d]) : 0.f;
    }
  };
  auto q_pos = [&](int r) -> long long {
    return (long long)L + (qt * BR + r) % a.T;
  };
  auto row_ok = [&](int r) -> bool { return qt * BR + r < GT; };

  Acc<D> acc;
  acc_zero(acc);
  stats_init(sm);
  load_q(q_rot);
  __syncthreads();

  // ---- group 2: window pages, tiles of the cover strided over splits ----
  const int n_tiles = (a.Lc + BC - 1) / BC;
  const long long q_lo = L, q_hi = (long long)L + a.T - 1;
  const long long hk = ((long long)b * a.Hkv + h) * a.Nb;
  for (int tile = split; tile < n_tiles; tile += a.n_split) {
    const int c0 = tile * BC;
    const long long p0 = pos_base + c0, p1 = pos_base + c0 + BC - 1;
    const bool live = c0 < c_lim && p0 < pos_end && p0 <= q_hi &&
                      q_lo - p1 < a.n_local;
    if (!live) continue;  // uniform over the block
    for (int i = tid; i < BC * D; i += NTH) {
      const int c = i / D, d = i % D;
      const int cc = c0 + c;
      float kr = 0.f, vf = 0.f;
      if (cc < c_lim && pos_base + cc < pos_end) {
        const int page = start_page + cc / a.S, o = cc % a.S;
        const long long row = ((hk + page) * a.S + o) * DP;
        const long long srow = (hk + page) * D;
        float x, xr;
        page_pair<D>(bk + row, a.k_scales + srow, d, x, xr);
        const long long ci = ((long long)b * a.Lc + cc) * D + d;
        kr = round_to<T>(x * a.cos_cover[ci] + xr * a.sin_cover[ci]);
        vf = page_val<T, D>(bv + row, a.v_scales + srow, d);
      }
      sm.k[c][d] = kr;
      sm.v[c][d] = vf;
    }
    __syncthreads();
    tile_update<T, D>(sm, acc, scale, [&](int r, int c) {
      const int cc = c0 + c;
      const long long pos = pos_base + cc;
      const long long dist = q_pos(r) - pos;
      return row_ok(r) && cc < c_lim && pos < pos_end && dist >= 0 &&
             dist < a.n_local && (!KEEP || keep_row[cc] != 0);
    });
  }

  // ---- groups 1 and 3: the init tokens, once per row tile (split 0) ----
  if (split == 0) {
    const long long ib = ((long long)b * a.Hkv + h) * a.n_init;
    const T* kir = static_cast<const T*>(a.k_init_rot);
    const T* kiw = static_cast<const T*>(a.k_init_raw);
    const T* vi = static_cast<const T*>(a.v_init);
    for (int grp = 0; grp < 2; ++grp) {
      if (grp == 1 && !init_active) break;
      const T* ksrc = grp == 0 ? kir : kiw;
      for (int i = tid; i < BC * D; i += NTH) {
        const int c = i / D, d = i % D;
        const bool ok = c < a.n_init;
        sm.k[c][d] = ok ? to_f(ksrc[(ib + c) * D + d]) : 0.f;
        sm.v[c][d] = ok ? to_f(vi[(ib + c) * D + d]) : 0.f;
      }
      if (grp == 1) load_q(q_one);
      __syncthreads();
      if (grp == 0) {
        tile_update<T, D>(sm, acc, scale, [&](int r, int c) {
          const long long dist = q_pos(r) - c;
          return row_ok(r) && c < a.n_init && dist >= 0 && dist < a.n_local;
        });
      } else {
        tile_update<T, D>(sm, acc, scale, [&](int r, int c) {
          return row_ok(r) && c < a.n_init;
        });
      }
    }
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

// ---- bfloat16 queries: the tensor-core tile (attn_tc.cuh) ----

// One page row's dims d .. d + 7 and their rotate-half partners d + D/2 ..
// d + D/2 + 7 (d a multiple of 8, below D/2), dequantized in f32.  `sc` is
// the page's scale row (D floats); bf16 pages have none.
template <int D>
__device__ __forceinline__ void row8(const __nv_bfloat16* row, const float*,
                                     int d, float lo[8], float hi[8]) {
  const uint4 x = *reinterpret_cast<const uint4*>(row + d);
  const uint4 y = *reinterpret_cast<const uint4*>(row + d + D / 2);
  const __nv_bfloat162* xp = reinterpret_cast<const __nv_bfloat162*>(&x);
  const __nv_bfloat162* yp = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 a = __bfloat1622float2(xp[i]), b = __bfloat1622float2(yp[i]);
    lo[2 * i] = a.x;
    lo[2 * i + 1] = a.y;
    hi[2 * i] = b.x;
    hi[2 * i + 1] = b.y;
  }
}
__device__ __forceinline__ void scales8(const float* sc, float s[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(sc));
  const float4 b = __ldg(reinterpret_cast<const float4*>(sc + 4));
  s[0] = a.x, s[1] = a.y, s[2] = a.z, s[3] = a.w;
  s[4] = b.x, s[5] = b.y, s[6] = b.z, s[7] = b.w;
}
template <int D>
__device__ __forceinline__ void row8(const int8_t* row, const float* sc,
                                     int d, float lo[8], float hi[8]) {
  const uint2 x = *reinterpret_cast<const uint2*>(row + d);
  const uint2 y = *reinterpret_cast<const uint2*>(row + d + D / 2);
  float sx[8], sy[8];
  scales8(sc + d, sx);
  scales8(sc + d + D / 2, sy);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const unsigned wx = i < 4 ? x.x : x.y, wy = i < 4 ? y.x : y.y;
    lo[i] = (float)(int8_t)((wx >> (8 * (i % 4))) & 0xFF) * sx[i];
    hi[i] = (float)(int8_t)((wy >> (8 * (i % 4))) & 0xFF) * sy[i];
  }
}
// split-plane int4: bytes d .. d + 7 hold dims d .. d + 7 in their low
// nibbles and the partners d + D/2 .. in their high ones
template <int D>
__device__ __forceinline__ void row8(const uint8_t* row, const float* sc,
                                     int d, float lo[8], float hi[8]) {
  const uint2 x = *reinterpret_cast<const uint2*>(row + d);
  float sx[8], sy[8];
  scales8(sc + d, sx);
  scales8(sc + d + D / 2, sy);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int byte = ((i < 4 ? x.x : x.y) >> (8 * (i % 4))) & 0xFF;
    lo[i] = nibble(byte & 0x0F) * sx[i];
    hi[i] = nibble(byte >> 4) * sy[i];
  }
}

// What both bf16 kernels derive from a batch row's scalars: the cover
// index range of window keys in the store and their affine positions.
struct Cover {
  int L, start_page, init_active, c_lim;
  long long pos_base, pos_end, q_lo, q_hi;
  const uint8_t* keep_row;  // keep byte of cover key c < c_lim (KEEP)

  __device__ Cover(const StreamArgs& a, int b) {
    L = a.scalars[b * 5 + 0];
    start_page = a.scalars[b * 5 + 1] * a.ppt;
    const int total = a.scalars[b * 5 + 2];
    init_active = a.scalars[b * 5 + 3];
    const int offset = a.scalars[b * 5 + 4];
    // position of the key at cover index c is pos_base + c
    pos_base = (long long)a.n_init + (long long)(start_page + offset) * a.S;
    pos_end = (long long)a.n_init + (long long)total * a.S;
    const int c_store = (a.Nb - start_page) * a.S;  // cover keys in the store
    c_lim = min(a.Lc, max(c_store, 0));
    q_lo = L;
    q_hi = (long long)L + a.T - 1;
    keep_row = a.page_keep + ((long long)b * a.Nb + start_page) * a.S;
  }
  // whether tile `tile` of bc cover keys holds a key some query may see
  __device__ bool live(int tile, int bc, int n_local) const {
    const long long p0 = pos_base + (long long)tile * bc;
    return tile * bc < c_lim && p0 < pos_end && p0 <= q_hi &&
           q_lo - (p0 + bc - 1) < n_local;
  }
};

constexpr int COVER_NTH = 256;  // threads of a pre-pass block
// cover keys of a pre-pass block: the attention's KV tile, so that the
// pre-pass writes every row of each tile the attention reads
constexpr int COVER_BC = tc::BC;

// Pre-pass of the bf16 kernel: one block per (live tile of COVER_BC cover
// keys, kv head, batch row) dequantizes the page rows in f32, rotates the
// keys with the f32 cover tables and rounds keys and values to bf16 into
// cover_k / cover_v (B, Hkv, Lc, D), zeros for keys outside the store or
// past the last page.  It runs once per key, where a transform inside the
// attention kernel would run once per row tile.
template <typename P, int D>
__global__ void __launch_bounds__(COVER_NTH)
stream_cover(StreamArgs a) {
  constexpr int H = D / 2;
  constexpr int ROW = (std::is_same<P, uint8_t>::value ? H : D) *
                      (int)sizeof(P);  // bytes of one page row
  const int tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const Cover cv(a, b);
  if (!cv.live(tile, COVER_BC, a.n_local)) return;  // never read
  const long long hk = ((long long)b * a.Hkv + h) * a.Nb;
  const unsigned char* bk = static_cast<const unsigned char*>(a.block_k);
  const unsigned char* bv = static_cast<const unsigned char*>(a.block_v);
  const long long first = (hk + cv.start_page) * a.S;  // store row of c = 0
  const long long out0 = ((long long)b * a.Hkv + h) * a.Lc;
  // one item: key cc, dims d .. d + 7 and their rotate-half partners
  for (int i = threadIdx.x; i < COVER_BC * (H / 8); i += COVER_NTH) {
    const int cc = tile * COVER_BC + i / (H / 8), d = 8 * (i % (H / 8));
    if (cc >= a.Lc) break;
    uint32_t k_lo[4] = {}, k_hi[4] = {}, v_lo[4] = {}, v_hi[4] = {};
    if (cc < cv.c_lim && cv.pos_base + cc < cv.pos_end) {
      const long long srow = (hk + cv.start_page + cc / a.S) * D;
      float xl[8], xh[8], yl[8], yh[8];
      row8<D>(reinterpret_cast<const P*>(bk + (first + cc) * ROW),
              a.k_scales + srow, d, xl, xh);
      row8<D>(reinterpret_cast<const P*>(bv + (first + cc) * ROW),
              a.v_scales + srow, d, yl, yh);
      // rope_cos_sin concatenates the angles twice, so the tables' two
      // halves are equal and the first serves both (tests/test_torch_ops.py
      // checks)
      const long long t = ((long long)b * a.Lc + cc) * D + d;
      float co[8], si[8];
      scales8(a.cos_cover + t, co);
      scales8(a.sin_cover + t, si);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int u = 2 * e, v = 2 * e + 1;
        // rotate-half: dim d pairs with -(dim d + D/2), d + D/2 with d
        k_lo[e] = tc::pack(xl[u] * co[u] + (-xh[u]) * si[u],
                           xl[v] * co[v] + (-xh[v]) * si[v]);
        k_hi[e] = tc::pack(xh[u] * co[u] + xl[u] * si[u],
                           xh[v] * co[v] + xl[v] * si[v]);
        v_lo[e] = tc::pack(yl[u], yl[v]);
        v_hi[e] = tc::pack(yh[u], yh[v]);
      }
    }
    __nv_bfloat16* kr = a.cover_k + (out0 + cc) * D;
    __nv_bfloat16* vr = a.cover_v + (out0 + cc) * D;
    *reinterpret_cast<uint4*>(kr + d) = *reinterpret_cast<uint4*>(k_lo);
    *reinterpret_cast<uint4*>(kr + d + H) = *reinterpret_cast<uint4*>(k_hi);
    *reinterpret_cast<uint4*>(vr + d) = *reinterpret_cast<uint4*>(v_lo);
    *reinterpret_cast<uint4*>(vr + d + H) = *reinterpret_cast<uint4*>(v_hi);
  }
}

// The bf16 attention: the tensor-core tile over the pre-pass's cover rows
// (tc::walk: cp.async, double-buffered against the previous tile's
// products), then, on split 0, the init keys.
template <int D, bool KEEP>
__global__ void __launch_bounds__(tc::Cfg<D>::NTH, tc::Cfg<D>::MIN_BLOCKS)
stream_attention_tc(StreamArgs a) {
  using bf16 = __nv_bfloat16;
  constexpr int BC = tc::BC, MT = tc::Cfg<D>::MT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const tc::Smem<D> sm(smem_raw);
  // with KEEP, the keep bytes of the two buffered KV tiles, after the tile
  // buffers
  unsigned char* keep_s = smem_raw + tc::Cfg<D>::SMEM;
  const tc::Block<D> blk(a.Hq, a.Hkv, a.T, a.n_split);
  const bool warp_live = blk.warp_live();
  const float scale = 1.f / sqrtf((float)D);
  const Cover cv(a, blk.b);
  const long long hc = ((long long)blk.b * a.Hkv + blk.h) * a.Lc;

  // the thread's rows (positions fit 32 bits: the scalars are int32)
  bool rok[2 * MT];
  int qpos[2 * MT];
#pragma unroll
  for (int k = 0; k < 2 * MT; ++k) {
    const int r = tc::row_of<D>(k);
    rok[k] = blk.row(r) >= 0;
    qpos[k] = cv.L + blk.token(r);
  }
  tc::Warp<D> w;
  tc::warp_init(w);
  blk.stage(sm.q(), a.q_rot);
  __syncthreads();
  if (warp_live) tc::load_q(w, sm.q());

  // group 2: the split's live window tiles; key c of a tile sits at
  // position p0 + c
  tc::walk(
      blk.split, a.n_split, (a.Lc + BC - 1) / BC,
      [&](int tile) { return cv.live(tile, BC, a.n_local); },
      [&](int tile, int i) {
        const long long c0 = (long long)tile * BC;
        tc::load_tile<D>(sm.k(i), a.cover_k + (hc + c0) * D,
                         (int)(a.Lc - c0));
        tc::load_tile<D>(sm.v(i), a.cover_v + (hc + c0) * D,
                         (int)(a.Lc - c0));
        if constexpr (KEEP) {
          const int c = (int)c0 + (int)threadIdx.x;
          if (threadIdx.x < BC)
            keep_s[i * BC + threadIdx.x] = c < cv.c_lim ? cv.keep_row[c] : 0;
        }
      },
      [&](int tile, int i) {
        if (!warp_live) return;
        const long long p0 = cv.pos_base + (long long)tile * BC;
        const int n_ok =
            (int)min((long long)(cv.c_lim - tile * BC), cv.pos_end - p0);
        // every key of the tile is in the store and seen by every query
        const bool full = n_ok >= BC && cv.q_lo - (p0 + BC - 1) >= 0 &&
                          cv.q_hi - p0 < a.n_local;
        int base[2 * MT];
#pragma unroll
        for (int k = 0; k < 2 * MT; ++k) base[k] = qpos[k] - (int)p0;
        tc::update<D>(w, sm.q(), sm.k(i), sm.v(i), scale, [&](int k, int c) {
          if constexpr (KEEP) {
            if (keep_s[i * BC + c] == 0) return false;
          }
          if (full) return rok[k];
          const int dist = base[k] - c;
          return rok[k] && c < n_ok && dist >= 0 && dist < a.n_local;
        });
      });

  // groups 1 and 3, once per row tile (split 0): the init keys at window
  // RoPE (mask 0 <= q_pos - c < n_local), then, with init_active, the raw
  // init keys against the one-angle queries (every key kept); one update
  // site serves both.
  const long long ib = ((long long)blk.b * a.Hkv + blk.h) * a.n_init;
  for (int grp = 0; blk.split == 0 && grp < 1 + (cv.init_active != 0);
       ++grp) {
    const bf16* kp =
        static_cast<const bf16*>(grp == 0 ? a.k_init_rot : a.k_init_raw);
    const bf16* vp = static_cast<const bf16*>(a.v_init);
    if (grp == 1) blk.stage(sm.q(), a.q_one);
    tc::load_rows<D>(sm.k(0), BC, [&](int r) -> const bf16* {
      return r < a.n_init ? kp + (ib + r) * D : nullptr;
    });
    tc::load_rows<D>(sm.v(0), BC, [&](int r) -> const bf16* {
      return r < a.n_init ? vp + (ib + r) * D : nullptr;
    });
    __syncthreads();
    if (warp_live) {
      if (grp == 1) tc::load_q(w, sm.q());
      tc::update<D>(w, sm.q(), sm.k(0), sm.v(0), scale, [&](int k, int c) {
        const int dist = qpos[k] - c;
        return rok[k] && c < a.n_init &&
               (grp == 1 || (dist >= 0 && dist < a.n_local));
      });
    }
    __syncthreads();  // every warp done before the next group's loads
  }

  tc::write_partial<D>(w, blk, a.part_acc, a.part_ml,
                       (long long)a.B * a.Hq * a.T);
}

// float32 queries run the FMA tile; bfloat16 ones the cover pre-pass and
// the tensor-core tile.  With `tile` set nothing is launched: tile receives
// the block's rows, its keys per KV tile and the blocks an SM holds at once.
template <typename T, typename P, int D>
cudaError_t launch(const StreamArgs& a, void* out, cudaStream_t stream,
                   int* tile) {
  constexpr bool tcore = std::is_same<T, __nv_bfloat16>::value;
  const bool keep = a.page_keep != nullptr;
  void (*kernel)(StreamArgs);
  int smem, br, bc, nth;
  if constexpr (tcore) {
    kernel = keep ? stream_attention_tc<D, true>
                  : stream_attention_tc<D, false>;
    smem = tc::Cfg<D>::SMEM + (keep ? 2 * tc::BC : 0);
    br = tc::Cfg<D>::BR;
    bc = tc::BC;
    nth = tc::Cfg<D>::NTH;
  } else {
    kernel = keep ? stream_attention_kernel<T, P, D, true>
                  : stream_attention_kernel<T, P, D, false>;
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
  if constexpr (tcore) {
    dim3 cover((a.Lc + COVER_BC - 1) / COVER_BC, a.Hkv, a.B);
    stream_cover<P, D><<<cover, COVER_NTH, 0, stream>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const int G = a.Hq / a.Hkv;
  dim3 grid((G * a.T + br - 1) / br, a.Hkv, a.B * a.n_split);
  kernel<<<grid, nth, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_combine<T, D>(a.part_acc, a.part_ml, a.n_split,
                              (long long)a.B * a.Hq * a.T, out, nullptr,
                              stream);
}

template <typename T, typename P>
cudaError_t launch_d(const StreamArgs& a, int D, void* out,
                     cudaStream_t stream, int* tile) {
  switch (D) {
    case 16: return launch<T, P, 16>(a, out, stream, tile);
    case 32: return launch<T, P, 32>(a, out, stream, tile);
    case 64: return launch<T, P, 64>(a, out, stream, tile);
    case 128: return launch<T, P, 128>(a, out, stream, tile);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_p(const StreamArgs& a, int pages, int D, void* out,
                     cudaStream_t stream, int* tile) {
  switch (pages) {
    case 0: return launch_d<T, T>(a, D, out, stream, tile);
    case 1: return launch_d<T, int8_t>(a, D, out, stream, tile);
    case 2: return launch_d<T, uint8_t>(a, D, out, stream, tile);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace stc

// The tile that stc_stream_attention runs for dtype (0 = float32, 1 =
// bfloat16), page kind and head dim D: tile[0] folded query rows a block,
// tile[1] keys a KV tile, tile[2] blocks an SM holds at once.  The wrapper
// sizes its grid and scratch from it.
extern "C" int stc_stream_attention_tile(int dtype, int pages, int D,
                                         int* tile) {
  stc::StreamArgs a{};
  return (int)(dtype == 1
                   ? stc::launch_p<__nv_bfloat16>(a, pages, D, nullptr,
                                                  nullptr, tile)
                   : stc::launch_p<float>(a, pages, D, nullptr, nullptr,
                                          tile));
}

// dtype: 0 = float32, 1 = bfloat16 (queries, init keys and values, output).
// pages: 0 = pages in that dtype (k_scales, v_scales unused), 1 = int8,
// 2 = packed int4 (uint8, D/2 bytes a row), each with f32 scales
// (B, Hkv, Nb, D).  cover_k, cover_v: (B, Hkv, Lc, D) bf16 scratch, with
// bfloat16 only.  page_keep: (B, Nb, S) bytes, a window key kept where
// nonzero, or null (nothing masked).  With bfloat16, every pointer but
// page_keep is 16-byte aligned.  Returns cudaGetLastError() after the
// launches.
extern "C" int stc_stream_attention(
    const void* q_rot, const void* q_one, const void* block_k,
    const void* block_v, const void* k_scales, const void* v_scales,
    const void* cos_cover, const void* sin_cover, const void* k_init_rot,
    const void* v_init, const void* k_init_raw, const void* scalars,
    const void* page_keep, void* part_acc, void* part_ml, void* cover_k,
    void* cover_v, void* out,
    int B, int Hq, int Hkv, int T, int D, int Nb, int S, int Lc, int ppt,
    int n_init, int n_local, int n_split, int dtype, int pages,
    void* stream) {
  stc::StreamArgs a;
  a.q_rot = q_rot;
  a.q_one = q_one;
  a.block_k = block_k;
  a.block_v = block_v;
  a.k_scales = static_cast<const float*>(k_scales);
  a.v_scales = static_cast<const float*>(v_scales);
  a.cos_cover = static_cast<const float*>(cos_cover);
  a.sin_cover = static_cast<const float*>(sin_cover);
  a.k_init_rot = k_init_rot;
  a.v_init = v_init;
  a.k_init_raw = k_init_raw;
  a.scalars = static_cast<const int*>(scalars);
  a.page_keep = static_cast<const uint8_t*>(page_keep);
  a.part_acc = static_cast<float*>(part_acc);
  a.part_ml = static_cast<float*>(part_ml);
  a.cover_k = static_cast<__nv_bfloat16*>(cover_k);
  a.cover_v = static_cast<__nv_bfloat16*>(cover_v);
  a.B = B;
  a.Hq = Hq;
  a.Hkv = Hkv;
  a.T = T;
  a.Nb = Nb;
  a.S = S;
  a.Lc = Lc;
  a.ppt = ppt;
  a.n_init = n_init;
  a.n_local = n_local;
  a.n_split = n_split;
  if (n_init > stc::BC || n_init > stc::tc::BC || Hq % Hkv != 0)
    return (int)cudaErrorInvalidValue;
  if (pages != 0 && (k_scales == nullptr || v_scales == nullptr))
    return (int)cudaErrorInvalidValue;
  if (dtype == 1 && (cover_k == nullptr || cover_v == nullptr))
    return (int)cudaErrorInvalidValue;
  const void* ptrs[] = {q_rot,    q_one,     block_k,    block_v,
                        k_scales, v_scales,  cos_cover,  sin_cover,
                        cover_k,  cover_v,   k_init_rot, v_init,
                        k_init_raw, out};
  for (const void* p : ptrs)
    if (dtype == 1 && reinterpret_cast<uintptr_t>(p) % 16 != 0)
      return (int)cudaErrorMisalignedAddress;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      dtype == 1 ? stc::launch_p<__nv_bfloat16>(a, pages, D, out, st, nullptr)
                 : stc::launch_p<float>(a, pages, D, out, st, nullptr);
  return (int)err;
}

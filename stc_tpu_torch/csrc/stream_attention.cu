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
// the output is normalised by l and 0 where l == 0.
//
// Bound on the H100 at llava-ov-0.5b shapes, full window: one 1-frame
// append does 4*14*60*15028*64 ~ 3.2 GFLOP (3.3 us at the dense bf16 rate)
// and reads ~7.7 MB of bf16 window pages (3.9 MB int8, 1.9 MB int4) plus
// ~7.7 MB of f32 RoPE cover tables (4.7 us at 3.35 TB/s): bytes bound it
// while the tables come from memory (computing cos/sin in the kernel would
// halve the bytes).  This first design runs the products as FP32 FMA
// (67 TFLOP/s peak) and splits the KV walk over blocks so a 60-token append
// still fills the card; tensor cores (mma/wgmma), TMA page loads and
// in-kernel RoPE tables are the next steps.  Dequantizing costs a few
// integer and float operations per loaded element, beside the D FMAs each
// loaded key feeds.

#include <stdint.h>

#include <type_traits>

#include "attn_common.cuh"

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
  float* part_acc;         // (n_split, B*Hq*T, D)
  float* part_ml;          // (n_split, B*Hq*T, 2)
  int B, Hq, Hkv, T, Nb, S, Lc, ppt, n_init, n_local, n_split;
};

// T: queries, init keys and output; P: page elements (T, int8_t or packed
// uint8_t)
template <typename T, typename P, int D>
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
             dist < a.n_local;
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

template <typename T, typename P, int D>
cudaError_t launch(const StreamArgs& a, void* out, cudaStream_t stream) {
  const size_t smem = sizeof(TileSmem<D>);
  cudaError_t err = cudaFuncSetAttribute(
      stream_attention_kernel<T, P, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int G = a.Hq / a.Hkv;
  dim3 grid((G * a.T + BR - 1) / BR, a.Hkv, a.B * a.n_split);
  stream_attention_kernel<T, P, D><<<grid, NTH, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_combine<T, D>(a.part_acc, a.part_ml, a.n_split,
                              (long long)a.B * a.Hq * a.T, out, nullptr,
                              stream);
}

template <typename T, typename P>
cudaError_t launch_d(const StreamArgs& a, int D, void* out,
                     cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, P, 16>(a, out, stream);
    case 32: return launch<T, P, 32>(a, out, stream);
    case 64: return launch<T, P, 64>(a, out, stream);
    case 128: return launch<T, P, 128>(a, out, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_p(const StreamArgs& a, int pages, int D, void* out,
                     cudaStream_t stream) {
  switch (pages) {
    case 0: return launch_d<T, T>(a, D, out, stream);
    case 1: return launch_d<T, int8_t>(a, D, out, stream);
    case 2: return launch_d<T, uint8_t>(a, D, out, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace stc

// dtype: 0 = float32, 1 = bfloat16 (queries, init keys and values, output).
// pages: 0 = pages in that dtype (k_scales, v_scales unused), 1 = int8,
// 2 = packed int4 (uint8, D/2 bytes a row), each with f32 scales
// (B, Hkv, Nb, D).  Returns cudaGetLastError() after the launches.
extern "C" int stc_stream_attention(
    const void* q_rot, const void* q_one, const void* block_k,
    const void* block_v, const void* k_scales, const void* v_scales,
    const void* cos_cover, const void* sin_cover, const void* k_init_rot,
    const void* v_init, const void* k_init_raw, const void* scalars,
    void* part_acc, void* part_ml, void* out, int B, int Hq, int Hkv, int T,
    int D, int Nb, int S, int Lc, int ppt, int n_init, int n_local,
    int n_split, int dtype, int pages, void* stream) {
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
  a.part_acc = static_cast<float*>(part_acc);
  a.part_ml = static_cast<float*>(part_ml);
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
  if (n_init > stc::BC || Hq % Hkv != 0) return (int)cudaErrorInvalidValue;
  if (pages != 0 && (k_scales == nullptr || v_scales == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      dtype == 1 ? stc::launch_p<__nv_bfloat16>(a, pages, D, out, st)
                 : stc::launch_p<float>(a, pages, D, out, st);
  return (int)err;
}

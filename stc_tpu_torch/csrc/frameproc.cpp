// Host-side frame preprocessor and YUV 4:2:0 packer (the JAX package's
// native frame library, copied unchanged below this header so the two
// packages pack the same bytes).
//
// Bilinear resize of uint8 HWC frames to the model's input size,
// normalization and HWC->CHW transpose, multithreaded across frames,
// writing planar float32; and the RGB -> planar BT.601 4:2:0 packer.  Built
// with g++ at first use into a shared library and driven through ctypes
// (native.py of this package).
//
// Layout contract:
//   in : n * (h * w * 3) uint8, row-major HWC RGB
//   out: n * (3 * out_hw * out_hw) float32, planar CHW
//   half-pixel-center bilinear sampling (matches torch interpolate
//   align_corners=false)

#include <cstdint>
#include <cmath>
#include <algorithm>
#include <thread>
#include <vector>

namespace {

void preprocess_one(const uint8_t* frame, int h, int w, float* out,
                    int out_hw, const float* mean, const float* inv_std) {
    const float sy = static_cast<float>(h) / out_hw;
    const float sx = static_cast<float>(w) / out_hw;
    const int plane = out_hw * out_hw;
    for (int oy = 0; oy < out_hw; ++oy) {
        float fy = (oy + 0.5f) * sy - 0.5f;
        fy = std::max(0.0f, std::min(fy, static_cast<float>(h - 1)));
        const int y0 = static_cast<int>(fy);
        const int y1 = std::min(y0 + 1, h - 1);
        const float wy = fy - y0;
        for (int ox = 0; ox < out_hw; ++ox) {
            float fx = (ox + 0.5f) * sx - 0.5f;
            fx = std::max(0.0f, std::min(fx, static_cast<float>(w - 1)));
            const int x0 = static_cast<int>(fx);
            const int x1 = std::min(x0 + 1, w - 1);
            const float wx = fx - x0;
            const uint8_t* p00 = frame + (y0 * w + x0) * 3;
            const uint8_t* p01 = frame + (y0 * w + x1) * 3;
            const uint8_t* p10 = frame + (y1 * w + x0) * 3;
            const uint8_t* p11 = frame + (y1 * w + x1) * 3;
            for (int c = 0; c < 3; ++c) {
                const float top = p00[c] + (p01[c] - p00[c]) * wx;
                const float bot = p10[c] + (p11[c] - p10[c]) * wx;
                const float v = (top + (bot - top) * wy) * (1.0f / 255.0f);
                out[c * plane + oy * out_hw + ox] =
                    (v - mean[c]) * inv_std[c];
            }
        }
    }
}

// BT.601 full-range RGB -> planar YUV 4:2:0, fixed-point (x256) integer
// math so the numpy twin (native.py _rgb_to_yuv420_np) reproduces
// it bit-for-bit.  Out layout per frame: Y[h*w] U[h/2*w/2] V[h/2*w/2].
void rgb_to_yuv420_one(const uint8_t* frame, int h, int w, uint8_t* out) {
    const int cw = w / 2, ch = h / 2;
    uint8_t* Y = out;
    uint8_t* U = out + h * w;
    uint8_t* V = U + ch * cw;
    // chroma accumulated over each 2x2 block before the >>2 average
    for (int y = 0; y < h; ++y) {
        for (int x = 0; x < w; ++x) {
            const uint8_t* p = frame + (y * w + x) * 3;
            const int r = p[0], g = p[1], b = p[2];
            Y[y * w + x] = static_cast<uint8_t>(
                (77 * r + 150 * g + 29 * b + 128) >> 8);
        }
    }
    for (int cy = 0; cy < ch; ++cy) {
        for (int cx = 0; cx < cw; ++cx) {
            int su = 0, sv = 0;
            for (int dy = 0; dy < 2; ++dy) {
                for (int dx = 0; dx < 2; ++dx) {
                    const uint8_t* p =
                        frame + ((2 * cy + dy) * w + (2 * cx + dx)) * 3;
                    const int r = p[0], g = p[1], b = p[2];
                    su += (-43 * r - 85 * g + 128 * b + 32768 + 128) >> 8;
                    sv += (128 * r - 107 * g - 21 * b + 32768 + 128) >> 8;
                }
            }
            U[cy * cw + cx] = static_cast<uint8_t>((su + 2) >> 2);
            V[cy * cw + cx] = static_cast<uint8_t>((sv + 2) >> 2);
        }
    }
}

}  // namespace

extern "C" {

// Returns 0 on success.  h and w must be even.
int stc_rgb_to_yuv420(const uint8_t* frames, int n, int h, int w,
                      uint8_t* out, int n_threads) {
    if (n <= 0 || h <= 0 || w <= 0 || (h % 2) || (w % 2)) return 1;
    const long in_stride = static_cast<long>(h) * w * 3;
    const long out_stride = static_cast<long>(h) * w * 3 / 2;

    auto work = [&](int begin, int end) {
        for (int i = begin; i < end; ++i)
            rgb_to_yuv420_one(frames + i * in_stride, h, w,
                              out + i * out_stride);
    };

    n_threads = std::max(1, std::min(n_threads, n));
    if (n_threads == 1) {
        work(0, n);
        return 0;
    }
    std::vector<std::thread> threads;
    const int per = (n + n_threads - 1) / n_threads;
    for (int t = 0; t < n_threads; ++t) {
        const int b = t * per;
        const int e = std::min(n, b + per);
        if (b < e) threads.emplace_back(work, b, e);
    }
    for (auto& th : threads) th.join();
    return 0;
}

// Returns 0 on success.
int stc_preprocess_frames(const uint8_t* frames, int n, int h, int w,
                          float* out, int out_hw,
                          const float* mean, const float* std_,
                          int n_threads) {
    if (n <= 0 || h <= 0 || w <= 0 || out_hw <= 0) return 1;
    const float inv_std[3] = {1.0f / std_[0], 1.0f / std_[1], 1.0f / std_[2]};
    const long in_stride = static_cast<long>(h) * w * 3;
    const long out_stride = 3L * out_hw * out_hw;

    auto work = [&](int begin, int end) {
        for (int i = begin; i < end; ++i) {
            preprocess_one(frames + i * in_stride, h, w,
                           out + i * out_stride, out_hw, mean, inv_std);
        }
    };

    n_threads = std::max(1, std::min(n_threads, n));
    if (n_threads == 1) {
        work(0, n);
        return 0;
    }
    std::vector<std::thread> threads;
    const int per = (n + n_threads - 1) / n_threads;
    for (int t = 0; t < n_threads; ++t) {
        const int b = t * per;
        const int e = std::min(n, b + per);
        if (b < e) threads.emplace_back(work, b, e);
    }
    for (auto& th : threads) th.join();
    return 0;
}

}  // extern "C"

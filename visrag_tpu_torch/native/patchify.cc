// Native host-side patch extraction — the data-loader hot loop.
//
// Role: the reference feeds its towers through torchvision/timm C++ kernels
// (ToTensor + conv-stem unfold); here the host stops at uint8 patch
// extraction (normalization happens on-device inside the jitted encode
// step, see preprocess/device.py) and this kernel does the (H, W, 3) ->
// (grid, 3*ps*ps) permutation in one parallel pass instead of numpy's
// reshape/transpose/copy chain (several full-buffer passes, one thread).
//
// Layout contract (must match preprocess/transform.patchify_u8): row-major
// patch grid; within a patch row the pixels are (c, ph, pw)-flattened —
// compatible with a Conv2d(3, D, ps, stride=ps) weight viewed (D, 3*ps*ps).
//
// Built by native/__init__.py with g++ -O3 -fopenmp at first
// import (cached .so); ctypes binding, numpy fallback if the toolchain is
// unavailable.

#include <cstdint>

extern "C" {

void patchify_u8(const uint8_t* img, long H, long W, long ps, uint8_t* out) {
    const long gh = H / ps, gw = W / ps;
    const long pd = 3 * ps * ps;
#pragma omp parallel for collapse(2) schedule(static)
    for (long gy = 0; gy < gh; ++gy) {
        for (long gx = 0; gx < gw; ++gx) {
            uint8_t* dst = out + (gy * gw + gx) * pd;
            for (long c = 0; c < 3; ++c) {
                for (long py = 0; py < ps; ++py) {
                    const uint8_t* src =
                        img + ((gy * ps + py) * W + gx * ps) * 3 + c;
                    uint8_t* d = dst + (c * ps + py) * ps;
                    for (long px = 0; px < ps; ++px) {
                        d[px] = src[px * 3];
                    }
                }
            }
        }
    }
}

// fp32 variant with fused ToTensor + Inception normalize ((x/255 - m) / s),
// for the non-device-mode path (preprocess/transform.patchify).
void patchify_f32(const uint8_t* img, long H, long W, long ps,
                  const float* mean, const float* inv_std, float* out) {
    const long gh = H / ps, gw = W / ps;
    const long pd = 3 * ps * ps;
    const float k = 1.0f / 255.0f;
#pragma omp parallel for collapse(2) schedule(static)
    for (long gy = 0; gy < gh; ++gy) {
        for (long gx = 0; gx < gw; ++gx) {
            float* dst = out + (gy * gw + gx) * pd;
            for (long c = 0; c < 3; ++c) {
                const float m = mean[c], is = inv_std[c];
                for (long py = 0; py < ps; ++py) {
                    const uint8_t* src =
                        img + ((gy * ps + py) * W + gx * ps) * 3 + c;
                    float* d = dst + (c * ps + py) * ps;
                    for (long px = 0; px < ps; ++px) {
                        d[px] = (static_cast<float>(src[px * 3]) * k - m) * is;
                    }
                }
            }
        }
    }
}

}  // extern "C"

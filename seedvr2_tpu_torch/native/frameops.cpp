// Host-side frame conversion loops of the video I/O path (the port's copy
// of native/frameops.cpp; the same four functions, the same arithmetic).
//
// uint8 BGR -> float RGB on decode, float -> 16- or 8-bit codes for the
// writers: single passes over the frame where numpy makes several with
// temporaries. Built with g++ into build/ at first use and bound with
// ctypes (seedvr2_tpu_torch/io/frameops.py), which falls back to numpy
// when no compiler is found.

#include <cstdint>
#include <cstddef>
#include <cmath>

extern "C" {

// uint8 interleaved (BGR or RGB) -> float32 [0,1] RGB, optional channel swap.
void u8_to_f32_rgb(const uint8_t* src, float* dst, size_t npix, int nch,
                   int swap_rb) {
    const float inv = 1.0f / 255.0f;
    if (nch == 3) {
        if (swap_rb) {
            for (size_t i = 0; i < npix; ++i) {
                dst[3 * i + 0] = src[3 * i + 2] * inv;
                dst[3 * i + 1] = src[3 * i + 1] * inv;
                dst[3 * i + 2] = src[3 * i + 0] * inv;
            }
        } else {
            const size_t n = npix * 3;
            for (size_t i = 0; i < n; ++i) dst[i] = src[i] * inv;
        }
    } else {  // 4 channels (BGRA/RGBA)
        for (size_t i = 0; i < npix; ++i) {
            const uint8_t* p = src + 4 * i;
            float* q = dst + 4 * i;
            q[0] = (swap_rb ? p[2] : p[0]) * inv;
            q[1] = p[1] * inv;
            q[2] = (swap_rb ? p[0] : p[2]) * inv;
            q[3] = p[3] * inv;
        }
    }
}

// float32 [0,1] -> uint16 little-endian (rgb48le for 10-bit+ encode).
void f32_to_u16(const float* src, uint16_t* dst, size_t n) {
    for (size_t i = 0; i < n; ++i) {
        float v = src[i];
        v = v < 0.0f ? 0.0f : (v > 1.0f ? 1.0f : v);
        dst[i] = (uint16_t)(v * 65535.0f + 0.5f);
    }
}

// float32 [0,1] -> uint8 with round-half-away (matches numpy round+clip).
void f32_to_u8(const float* src, uint8_t* dst, size_t n) {
    for (size_t i = 0; i < n; ++i) {
        float v = src[i];
        v = v < 0.0f ? 0.0f : (v > 1.0f ? 1.0f : v);
        dst[i] = (uint8_t)(v * 255.0f + 0.5f);
    }
}

// In-place [-1,1] -> [0,1] normalize + clamp (phase 4's output normalize).
void denorm_clamp(float* x, size_t n) {
    for (size_t i = 0; i < n; ++i) {
        float v = x[i] * 0.5f + 0.5f;
        x[i] = v < 0.0f ? 0.0f : (v > 1.0f ? 1.0f : v);
    }
}

}  // extern "C"

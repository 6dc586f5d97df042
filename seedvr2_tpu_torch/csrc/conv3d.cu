// Plain C entry points of K1 / K4 and K6 (conv3d.cuh on conv_pipeline.cuh)
// and the error-string helper of the kernel library. Every .cu file of
// csrc/ is one translation unit, compiled on its own (in parallel) and
// linked into one shared library that ops/cuda_lib.py loads with ctypes.
// Each entry launches on the caller's stream, allocates nothing and returns
// cudaGetLastError() right after the launch so a refused launch is reported
// to the caller. The two tensor maps hold the data pointers, so they are
// encoded on each call (microseconds) from the pointers given, which may
// lie anywhere in an allocation as long as they are 16-byte aligned; a
// failed encode returns conv::kEncodeError + its CUresult (ops/cuda_lib.py
// raises on it).
#include "conv3d.cuh"

using namespace seedvr2;

namespace {

bool misaligned(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; }

template <bool kGn>
int conv3d(const void* x, const void* w, const void* bias, const void* scale, const void* shift, void* y, int B,
           int T, int H, int W, int cin, int cout, void* stream) {
  if (B < 1 || T < 1 || H < 1 || W < 1 || cin < 1 || cout < 1 || cin % conv::kBK != 0 || cout % conv::kBN != 0 ||
      misaligned(x) || misaligned(w) || (kGn && (misaligned(scale) || misaligned(shift))))
    return (int)cudaErrorInvalidValue;
  int err = 0;
  Conv3dPolicy<kGn> p;
  p.g = conv::geometry(H, W, cin, (long)B * T, cout / conv::kBN, &err);
  if (err != 0) return err;
  p.T = T;
  p.cout = cout;
  p.tiles_n = cout / conv::kBN;
  p.bias = (const float*)bias;
  p.gn_scale = (const float*)scale;
  p.gn_shift = (const float*)shift;
  p.y = (bf16*)y;
  return conv::launch(p, x, B, T + 2, w, 27L * cin, cout, (cudaStream_t)stream);
}

}  // namespace

extern "C" {

const char* seedvr2_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// x [B, T+2, H, W, cin], w [27, cin, cout] bf16; scale == shift == nullptr:
// K1; both given ([B, T+2, cin] fp32): K4. cin % 64 == 0, cout % 128 == 0.
int seedvr2_conv3d_3x3x3(const void* x, const void* w, const void* bias, const void* scale, const void* shift,
                         void* y, int B, int T, int H, int W, int cin, int cout, void* stream) {
  return scale != nullptr ? conv3d<true>(x, w, bias, scale, shift, y, B, T, H, W, cin, cout, stream)
                          : conv3d<false>(x, w, bias, nullptr, nullptr, y, B, T, H, W, cin, cout, stream);
}

// K6: x [B, T+2, H, W, cin], wf [27*cin, cout] bf16 (K1's weight viewed
// flat); the same kernel as K1's.
int seedvr2_conv3d_im2col(const void* x, const void* wf, const void* bias, void* y, int B, int T, int H, int W,
                          int cin, int cout, void* stream) {
  return conv3d<false>(x, wf, bias, nullptr, nullptr, y, B, T, H, W, cin, cout, stream);
}

// What the runtime holds for the kernel of K1 / K6 (gn == 0) or K4 (gn !=
// 0): registers a thread, local memory (spills) a thread, and the dynamic
// shared memory it launches with.
int seedvr2_conv3d_attributes(int gn, int* regs, int* local_bytes, int* smem_bytes) {
  return gn ? conv::attributes<Conv3dPolicy<true>>(regs, local_bytes, smem_bytes)
            : conv::attributes<Conv3dPolicy<false>>(regs, local_bytes, smem_bytes);
}

}  // extern "C"

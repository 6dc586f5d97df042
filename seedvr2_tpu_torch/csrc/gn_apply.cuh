// K9: the VAE's per-frame GroupNorm applied from K8's tables, with or
// without the SiLU after it: y = bf16(x * scale + shift) for each frame
// (b, t) of x [B, T, H, W, C] bf16, scale and shift [B, T, C] fp32
// (ops/conv3d_kernel.py:gn_silu_tables); with the SiLU flag, y =
// bf16(silu(float(that))).
//
// Replaces no TPU kernel: the JAX package leaves this pass to XLA's fused
// elementwise ops (seedvr2_tpu/models/vae/causal_conv.py:124-136, the
// unfused branch of causal_conv3d(gn=...); model.py:141-149 and :264-265,
// :287-288, norm_out's _gn then _silu; model.py:173, the mid attention's
// _gn). The port's plain version of it (ops/normalization.py:
// group_norm_frames_plain) made two fp32 copies of the activation and ran
// some twelve launches over it, 605 ms of the 3B batch's 987 ms of device
// time on the default (unfused) route (PERF.md).
//
// The op order is the JAX package's: the normalised value is rounded to
// bf16 before the SiLU, which then runs in fp32 and rounds again (K4 rounds
// once, after its SiLU: a different function, which stays K4's). The
// normalisation is a multiply and an add, each rounded (__fmul_rn,
// __fadd_rn, never contracted into an FMA), so it gives the bits of the
// plain version's x.float() * scale + shift; the SiLU is x / (1 +
// __expf(-x)), whose few-ulp error moves a bf16 code only at a tie.
//
// What bounds it on the H100: bytes. x is read once and y written once (2
// bytes each a value); a value costs a few flops and one exponential.
//
// Design: one launch, no atomics, no shared memory. Grid (pixel chunks,
// B * T): a block takes a chunk of ppb * steps pixels of one frame (the
// geometry is the caller's: ops/normalization.py:gn_apply_geometry), C / 8
// neighbouring threads a pixel, each holding its 8 channels' scale and
// shift in registers (loaded once as 16-byte words) and moving 16 bytes of
// x and of y a pixel, 4 pixels in flight at a time.
#pragma once

#include "common.cuh"

namespace seedvr2 {
namespace gnapply {

constexpr int kMaxThreads = 1024;

// One bf16 value of x (as fp32) normalised, rounded, and with kSilu passed
// through the SiLU and rounded again; returned as its 16 bits.
template <bool kSilu>
__device__ __forceinline__ uint32_t apply(float x, float s, float h) {
  bf16 y = __float2bfloat16_rn(__fadd_rn(__fmul_rn(x, s), h));
  if (kSilu) {
    const float v = __bfloat162float(y);
    y = __float2bfloat16_rn(v / (1.f + __expf(-v)));
  }
  return (uint32_t)__bfloat16_as_ushort(y);
}

// 8 channels of one pixel: word j of the 16-byte load holds channels 2j
// (low half) and 2j + 1 (high half).
template <bool kSilu>
__device__ __forceinline__ uint4 apply8(uint4 u, const float (&s)[8], const float (&h)[8]) {
  uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float lo = __uint_as_float(w[j] << 16), hi = __uint_as_float(w[j] & 0xffff0000u);
    w[j] = apply<kSilu>(lo, s[2 * j], h[2 * j]) | (apply<kSilu>(hi, s[2 * j + 1], h[2 * j + 1]) << 16);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// grid (chunks, frames), ppb * C / 8 threads.
template <bool kSilu>
__global__ void __launch_bounds__(kMaxThreads) gn_apply_kernel(const bf16* __restrict__ x,
                                                               const float* __restrict__ scale,
                                                               const float* __restrict__ shift, bf16* __restrict__ y,
                                                               int P, int C, int ppb, int steps) {
  const int tpp = C / 8;  // threads a pixel
  const int tc = threadIdx.x % tpp, pl = threadIdx.x / tpp;
  const long frame = blockIdx.y;
  const long chunk_px = (long)ppb * steps;
  const long p0 = blockIdx.x * chunk_px;
  const long pend = min((long)P, p0 + chunk_px);

  float s[8], h[8];
  const float4* s4 = reinterpret_cast<const float4*>(scale + frame * C) + 2 * tc;
  const float4* h4 = reinterpret_cast<const float4*>(shift + frame * C) + 2 * tc;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float4 a = __ldg(s4 + i), b = __ldg(h4 + i);
    s[4 * i] = a.x, s[4 * i + 1] = a.y, s[4 * i + 2] = a.z, s[4 * i + 3] = a.w;
    h[4 * i] = b.x, h[4 * i + 1] = b.y, h[4 * i + 2] = b.z, h[4 * i + 3] = b.w;
  }

  const uint4* src = reinterpret_cast<const uint4*>(x + frame * P * C) + tc;
  uint4* dst = reinterpret_cast<uint4*>(y + frame * P * C) + tc;
  long p = p0 + pl;
  for (; p + 3L * ppb < pend; p += 4L * ppb) {
    uint4 u[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) u[i] = __ldg(src + (p + (long)i * ppb) * tpp);
#pragma unroll
    for (int i = 0; i < 4; ++i) dst[(p + (long)i * ppb) * tpp] = apply8<kSilu>(u[i], s, h);
  }
  for (; p < pend; p += ppb) dst[p * tpp] = apply8<kSilu>(__ldg(src + p * tpp), s, h);
}

}  // namespace gnapply
}  // namespace seedvr2

// K2: the decoder's folded upsample (1x1x1 expansion -> depth-to-space ->
// 3x3x3 conv, folded into one low-resolution conv at load time).
//
// Replaces the Pallas kernel seedvr2_tpu/ops/fold_upsample_kernel.py:
// fold_upsample_conv (_kernel). For temporal phase a and spatial phase
// (u, v) the output pixel (2i+u, 2j+v) of frame tp*A+a is
//   sum over taps (dt, dh, dw) in kt x 2 x 2 of
//     x[tp+dt, i+u+dh-1, j+v+dw-1, :] @ K[dt, dh, dw, :, phase block]
//   + btab[dh, dw, phase block] where that low-res tap lies inside the frame
//   + bc
// (out-of-frame taps read zero, so they must not add their expansion bias).
//
// What bounds it on the H100: like K1 it is tensor-core bound (kt*4*C*2
// FLOPs per output value); on top, its output is four times the input's
// spatial size, so the store must not add a pass. The design: the K1
// implicit-GEMM tile with the folded tap map (M = 64 low-res pixels, N = 64
// channels, K = kt*4*C), one grid.z slice per (batch, frame, temporal
// phase, spatial phase), the masked bias table added in the epilogue, and
// each result stored straight to its interleaved high-res position, so the
// phase tensor never exists in memory.
#pragma once

#include "common.cuh"

namespace seedvr2 {

// x: [B, Tp+kt-1, H, W, C]; K: [kt, 2, 2, C, A*4*C] bf16;
// btab: [2, 2, A*4*C] fp32; bc: [C] fp32; y: [B, Tp*A, 2H, 2W, C].
// grid = (ceil(H*W/64), C/64, B*Tp*A*4).
__global__ void __launch_bounds__(kThreads)
    fold_upsample_kernel(const bf16* __restrict__ x, const bf16* __restrict__ K,
                         const float* __restrict__ btab, const float* __restrict__ bc,
                         bf16* __restrict__ y, int Tp, int kt, int A, int H, int W, int C) {
  __shared__ __align__(128) unsigned char smem[kIgemmSmem];
  bf16* sa = reinterpret_cast<bf16*>(smem);
  bf16* sb = reinterpret_cast<bf16*>(smem + kTileABytes);
  float* sc = reinterpret_cast<float*>(smem);

  int z = blockIdx.z;
  const int ph = z & 3;
  const int u = ph >> 1, v = ph & 1;
  z >>= 2;
  const int a = z % A;
  z /= A;
  const int tp = z % Tp;
  const int b = z / Tp;

  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int hw = H * W;
  const long P = (long)A * 4 * C;
  const long pcol = (long)((a * 2 + u) * 2 + v) * C;  // this phase's column block
  const bf16* xf = x + ((long)b * (Tp + kt - 1) + tp) * hw * C;

  int pi[2], pj[2];
  bool pv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int p = m0 + igemm_a_row(i);
    pv[i] = p < hw;
    pi[i] = p / W;
    pj[i] = p - pi[i] * W;
  }

  FragC acc[2][2];
  igemm_zero(acc);
  for (int dt = 0; dt < kt; ++dt)
    for (int dh = 0; dh < 2; ++dh)
      for (int dw = 0; dw < 2; ++dw) {
        const bf16* src[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int hh = pi[i] + u + dh - 1, ww = pj[i] + v + dw - 1;
          const bool ok = pv[i] && hh >= 0 && hh < H && ww >= 0 && ww < W;
          src[i] = ok ? xf + ((long)dt * hw + (long)hh * W + ww) * C : nullptr;
        }
        const long tap = (dt * 2 + dh) * 2 + dw;
        igemm_tap(acc, src, K + tap * C * P + pcol + n0, P, C, sa, sb);
      }
  igemm_store_c(acc, sc);

  const long frame = (long)b * Tp * A + (long)tp * A + a;
  for (int c = threadIdx.x; c < kBM * (kBN / 8); c += kThreads) {
    const int r = c >> 3, cc = (c & 7) * 8;
    const int p = m0 + r;
    if (p >= hw) continue;
    const int i = p / W, j = p - (p / W) * W;
    float val[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) val[e] = sc[r * kLdC + cc + e] + bc[n0 + cc + e];
    for (int dh = 0; dh < 2; ++dh) {
      const int hh = i + u + dh - 1;
      if (hh < 0 || hh >= H) continue;
      for (int dw = 0; dw < 2; ++dw) {
        const int ww = j + v + dw - 1;
        if (ww < 0 || ww >= W) continue;
        const float* bt = btab + (dh * 2 + dw) * P + pcol + n0 + cc;
#pragma unroll
        for (int e = 0; e < 8; ++e) val[e] += bt[e];
      }
    }
    Pack8 out;
#pragma unroll
    for (int e = 0; e < 8; ++e) out.h[e] = __float2bfloat16(val[e]);
    const long row = frame * (2L * H) + 2 * i + u;
    *reinterpret_cast<uint4*>(y + (row * (2L * W) + 2 * j + v) * C + n0 + cc) = out.u;
  }
}

}  // namespace seedvr2

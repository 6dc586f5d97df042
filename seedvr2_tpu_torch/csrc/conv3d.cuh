// K1: stride-1 3x3x3 convolution of the causal video VAE, channels-last.
//
// Replaces the Pallas kernel seedvr2_tpu/ops/conv3d_kernel.py:conv3d_3x3x3
// (_kernel). Same contract: the input is already extended in time (causal
// head or streaming carry), SAME zero padding in H and W, valid in time,
// fp32 accumulation, bias added in fp32, output in bf16.
//
// What bounds it on the H100: at the VAE's shapes (Cin, Cout in 128..512)
// the conv does 27*Cin*2 FLOPs per output value against ~4 bytes of
// activation traffic, far above the ~295 FLOP/byte ridge, so it is bound by
// tensor-core issue. The design follows from that: an implicit GEMM with
// M = 64 output pixels of one frame, N = 64 output channels and
// K = 27 * Cin looped as (tap, 32-channel chunk); the 27 shifted windows
// are gathered straight from the unpadded input with predicated 16-byte
// loads (the Pallas wrapper's jnp.pad and its +7 column alignment pad were
// TPU artefacts and are gone); the batch and the frames ride grid.z instead
// of a host loop; the weights are laid out once at load as [27, Cin, Cout].
// Not yet done (later work): cp.async/TMA double buffering and wgmma.
#pragma once

#include "common.cuh"

namespace seedvr2 {

// x: [B, T+2, H, W, cin]; w: [27, cin, cout]; bias: [cout] fp32;
// y: [B, T, H, W, cout]. grid = (ceil(H*W/64), cout/64, B*T).
__global__ void __launch_bounds__(kThreads)
    conv3d_3x3x3_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                        const float* __restrict__ bias, bf16* __restrict__ y, int T, int H, int W,
                        int cin, int cout) {
  __shared__ __align__(128) unsigned char smem[kIgemmSmem];
  bf16* sa = reinterpret_cast<bf16*>(smem);
  bf16* sb = reinterpret_cast<bf16*>(smem + kTileABytes);
  float* sc = reinterpret_cast<float*>(smem);

  const int bt = blockIdx.z;
  const int b = bt / T, t = bt - b * T;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int hw = H * W;
  // frame t of the extended input; temporal tap kt adds kt frames
  const bf16* xf = x + ((long)b * (T + 2) + t) * hw * cin;

  int ph[2], pw[2];
  bool pv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int p = m0 + igemm_a_row(i);
    pv[i] = p < hw;
    ph[i] = p / W;
    pw[i] = p - ph[i] * W;
  }

  FragC acc[2][2];
  igemm_zero(acc);
  for (int kt = 0; kt < 3; ++kt)
    for (int kh = 0; kh < 3; ++kh)
      for (int kw = 0; kw < 3; ++kw) {
        const bf16* src[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int hh = ph[i] + kh - 1, ww = pw[i] + kw - 1;
          const bool ok = pv[i] && hh >= 0 && hh < H && ww >= 0 && ww < W;
          src[i] = ok ? xf + ((long)kt * hw + (long)hh * W + ww) * cin : nullptr;
        }
        const int tap = (kt * 3 + kh) * 3 + kw;
        igemm_tap(acc, src, w + (long)tap * cin * cout + n0, cout, cin, sa, sb);
      }
  igemm_store_c(acc, sc);

  // epilogue: 64 rows x 8 chunks of 8 channels, 4 chunks per thread
  for (int c = threadIdx.x; c < kBM * (kBN / 8); c += kThreads) {
    const int r = c >> 3, cc = (c & 7) * 8;
    const int p = m0 + r;
    if (p >= hw) continue;
    Pack8 out;
#pragma unroll
    for (int j = 0; j < 8; ++j) out.h[j] = __float2bfloat16(sc[r * kLdC + cc + j] + bias[n0 + cc + j]);
    *reinterpret_cast<uint4*>(y + ((long)bt * hw + p) * cout + n0 + cc) = out.u;
  }
}

}  // namespace seedvr2

// K6: the stride-1 3x3x3 VAE convolution as ONE folded product,
//   y[M, Cout] = col(x)[M, 27*Cin] @ Wf[27*Cin, Cout] + bias,
// with col(x)[p, k] = x_ext[t + kt, h + kh - 1, w + kw - 1, c] for
// k = tap * Cin + c, tap = (kt * 3 + kh) * 3 + kw (zero outside the image).
//
// Replaces the Pallas kernel seedvr2_tpu/ops/conv3d_kernel.py:
// conv3d_3x3x3_im2col (_kernel_im2col), which gathers the 27 taps into a
// [M, 27*Cin] VMEM matrix and runs a single contraction of depth 27*Cin
// instead of 27 accumulating depth-Cin products. Same contract as K1: the
// input is already extended in time, SAME zero padding in H and W, valid
// in time, fp32 accumulation, bias in fp32, bf16 output.
//
// How it differs from K1 (conv3d.cuh): K1 computes a 4 x 16 output patch
// from a halo'd input slab loaded once per (temporal tap, 32-channel
// chunk), its 9 spatial taps read from the slab. K6 computes 64 pixels in
// raster order and walks the folded K axis of the product in uniform
// 64-deep steps; each step is one panel of the column matrix, gathered
// straight from the input from k -> (tap = k / Cin, c = k % Cin) (with
// Cin % 64 == 0 a step never crosses a tap), against the matching 64 rows
// of the folded weight [27*Cin, Cout] (K1's stored layout viewed flat).
// The column matrix itself is never materialised: on the TPU it lived in
// VMEM, here it would be 27x the input in device memory.
//
// What bounds it on the H100: the same tensor-core work as K1 (2*27*Cin
// FLOPs per output value), so operations, not bytes. Its 64-deep steps
// take half K1's block-wide barriers per unit of K, but every input
// element is fetched once per spatial tap; it is a first, simple WMMA form
// like K1 (no cp.async/TMA pipeline, no wgmma yet).
#pragma once

#include "common.cuh"

namespace seedvr2 {

constexpr int kIcBK = 64;  // depth of one folded-K step
constexpr int kIcLdA = kIcBK + 8;
constexpr int kIcLdB = kBN + 8;
constexpr int kIcTileA = kBM * kIcLdA * 2;
constexpr int kIcTileB = kIcBK * kIcLdB * 2;
constexpr int kIcSmem = kTileCBytes > kIcTileA + kIcTileB ? kTileCBytes : kIcTileA + kIcTileB;
constexpr int kIcRows = kBM * (kIcBK / 8) / kThreads;  // A-panel rows a thread loads (4)

// Epilogue: the spilled 64x64 tile plus the fp32 bias, rounded to bf16
// and stored to y[frame bt][pixel m0 + r][channel n0 + c] (channels-last,
// row stride cout); rows past the frame's hw pixels are dropped. 64 rows x
// 8 chunks of 8 channels, 4 chunks per thread.
__device__ __forceinline__ void im2col_epilogue(const float* sc, const float* __restrict__ bias,
                                               bf16* __restrict__ y, int bt, int hw, int m0,
                                               int n0, int cout) {
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

// x: [B, T+2, H, W, cin]; wf: [27*cin, cout]; bias: [cout] fp32;
// y: [B, T, H, W, cout]. grid = (ceil(H*W/64), cout/64, B*T); cin % 64 == 0.
__global__ void __launch_bounds__(kThreads)
    conv3d_im2col_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wf,
                         const float* __restrict__ bias, bf16* __restrict__ y, int T, int H,
                         int W, int cin, int cout) {
  __shared__ __align__(128) unsigned char smem[kIcSmem];
  bf16* sa = reinterpret_cast<bf16*>(smem);
  bf16* sb = reinterpret_cast<bf16*>(smem + kIcTileA);
  float* sc = reinterpret_cast<float*>(smem);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const int bt = blockIdx.z;
  const int b = bt / T, t = bt - b * T;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int hw = H * W;
  const bf16* xf = x + ((long)b * (T + 2) + t) * hw * cin;

  // this thread's A-panel rows (tid >> 3) + 16 i, 16-byte chunk (tid & 7)
  const int kc = tid & 7;
  int ph[kIcRows], pw[kIcRows];
  bool pv[kIcRows];
#pragma unroll
  for (int i = 0; i < kIcRows; ++i) {
    const int p = m0 + (tid >> 3) + 16 * i;
    pv[i] = p < hw;
    ph[i] = p / W;
    pw[i] = p - ph[i] * W;
  }

  FragC acc[2][2];
  igemm_zero(acc);
  const int K = 27 * cin;
  for (int k0 = 0; k0 < K; k0 += kIcBK) {
    // column panel k0 .. k0+63: one tap, channels c0 .. c0+63
    const int tap = k0 / cin, c0 = k0 - tap * cin;
    const int kt = tap / 9, kh = (tap / 3) % 3, kw = tap % 3;
#pragma unroll
    for (int i = 0; i < kIcRows; ++i) {
      const int hh = ph[i] + kh - 1, ww = pw[i] + kw - 1;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (pv[i] && hh >= 0 && hh < H && ww >= 0 && ww < W)
        v = *reinterpret_cast<const uint4*>(xf + ((long)kt * hw + (long)hh * W + ww) * cin + c0 +
                                            kc * 8);
      *reinterpret_cast<uint4*>(sa + ((tid >> 3) + 16 * i) * kIcLdA + kc * 8) = v;
    }
    // weight panel: rows k0 .. k0+63 of the folded weight, columns n0 .. n0+63
#pragma unroll
    for (int i = 0; i < kIcRows; ++i) {
      const int r = (tid >> 3) + 16 * i;
      *reinterpret_cast<uint4*>(sb + r * kIcLdB + kc * 8) =
          *reinterpret_cast<const uint4*>(wf + (long)(k0 + r) * cout + n0 + kc * 8);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kIcBK; kk += 16) {
      FragA fa[2];
      FragBRow fb[2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        wmma::load_matrix_sync(fa[mi], sa + (wm * 32 + mi * 16) * kIcLdA + kk, kIcLdA);
#pragma unroll
      for (int ni = 0; ni < 2; ++ni)
        wmma::load_matrix_sync(fb[ni], sb + kk * kIcLdB + wn * 32 + ni * 16, kIcLdB);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 2; ++ni) wmma::mma_sync(acc[mi][ni], fa[mi], fb[ni], acc[mi][ni]);
    }
    __syncthreads();
  }
  igemm_store_c(acc, sc);
  im2col_epilogue(sc, bias, y, bt, hw, m0, n0, cout);
}

}  // namespace seedvr2

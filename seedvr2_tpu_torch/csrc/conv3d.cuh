// K1: stride-1 3x3x3 convolution of the causal video VAE, channels-last,
// and K4: the same convolution with the resnet's GroupNorm + SiLU folded
// into its input load (template flag kGn).
//
// Replaces the Pallas kernel seedvr2_tpu/ops/conv3d_kernel.py:conv3d_3x3x3
// (_kernel, and _kernel_gn when scale/shift tables are given). Same
// contract: the input is already extended in time (causal head or streaming
// carry), SAME zero padding in H and W, valid in time, fp32 accumulation,
// bias added in fp32, output in bf16.
//
// What bounds it on the H100: at the VAE's shapes (Cin, Cout in 128..512)
// the conv does 27*Cin*2 FLOPs per output value against ~4 bytes of
// activation traffic, far above the ~295 FLOP/byte ridge, so it is bound by
// tensor-core issue. The design follows from that: an implicit GEMM whose
// M = 64 output pixels are a 4 x 16 patch of one frame, N = 64 output
// channels, K = 27 * Cin looped as (temporal tap, 32-channel chunk, spatial
// tap). For each temporal tap and chunk the block loads the patch's 6 x 18
// halo'd input slab once into shared memory (predicated 16-byte loads from
// the unpadded input: out-of-image pixels are zero; the Pallas wrapper's
// jnp.pad and its +7 column alignment pad were TPU artefacts and are gone),
// and the 9 spatial taps read their A fragments straight from the slab at
// shifted offsets: 108 loads per 64 x 32 chunk instead of 9 x 64. The
// batch and the frames ride grid.z instead of a host loop; the weights are
// laid out once at load as [27, Cin, Cout].
//
// K4 (kGn): the GroupNorm statistics are folded by the caller into fp32
// tables scale/shift [B, T+2, Cin] (one row per frame of the extended
// input); every in-image slab element of frame t+kt is stored as
// silu(x * scale + shift), rounded to bf16, so each element is normalised
// once per block and temporal tap. The normalised tensor is never written
// to device memory, which is what the fusion buys (the unfused path writes
// it and the conv reads it back). An out-of-image slab element stays 0:
// SAME padding pads the normalised activations, and silu(shift) of a raw
// zero is not 0 (the Pallas kernel's mask at _kernel_gn does the same).
// Not yet done (later work): cp.async/TMA double buffering and wgmma.
#pragma once

#include "common.cuh"

namespace seedvr2 {

constexpr int kTH = 4, kTW = 16;             // output patch: kTH x kTW = kBM pixels
constexpr int kSH = kTH + 2, kSW = kTW + 2;  // input slab with the 3x3 halo
constexpr int kSlabPix = kSH * kSW;
constexpr int kLdS = kBK + 16;  // 48 bf16 = 96 bytes a slab pixel: every shifted fragment start is 32-byte aligned
constexpr int kSlabBytes = kSlabPix * kLdS * 2;
constexpr int kConvSmem = kTileCBytes > kSlabBytes + kTileBBytes ? kTileCBytes : kSlabBytes + kTileBBytes;
static_assert(kTH * kTW == kBM, "the patch is the M tile");

// silu(x * scale + shift) of eight bf16 channels, in fp32 with the multiply
// and the add rounded separately (as the plain version's two tensor ops),
// rounded once back to bf16. scale/shift point at the eight channels' fp32
// table entries (16-byte aligned).
__device__ __forceinline__ uint4 gn_silu8(uint4 raw, const float* __restrict__ scale,
                                          const float* __restrict__ shift) {
  Pack8 in, out;
  in.u = raw;
  const float4 s0 = *reinterpret_cast<const float4*>(scale);
  const float4 s1 = *reinterpret_cast<const float4*>(scale + 4);
  const float4 f0 = *reinterpret_cast<const float4*>(shift);
  const float4 f1 = *reinterpret_cast<const float4*>(shift + 4);
  const float s[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
  const float f[8] = {f0.x, f0.y, f0.z, f0.w, f1.x, f1.y, f1.z, f1.w};
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float v = __fadd_rn(__fmul_rn(__bfloat162float(in.h[j]), s[j]), f[j]);
    out.h[j] = __float2bfloat16(v / (1.0f + expf(-v)));
  }
  return out.u;
}

// x: [B, T+2, H, W, cin]; w: [27, cin, cout]; bias: [cout] fp32;
// scale, shift (kGn only): [B, T+2, cin] fp32; y: [B, T, H, W, cout].
// grid = (ceil(H/4) * ceil(W/16), cout/64, B*T).
template <bool kGn>
__global__ void __launch_bounds__(kThreads)
    conv3d_3x3x3_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                        const float* __restrict__ bias, const float* __restrict__ scale,
                        const float* __restrict__ shift, bf16* __restrict__ y, int T, int H, int W,
                        int cin, int cout) {
  __shared__ __align__(128) unsigned char smem[kConvSmem];
  bf16* slab = reinterpret_cast<bf16*>(smem);
  bf16* sb = reinterpret_cast<bf16*>(smem + kSlabBytes);
  float* sc = reinterpret_cast<float*>(smem);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const int tiles_w = (W + kTW - 1) / kTW;
  const int h0 = (blockIdx.x / tiles_w) * kTH, w0 = (blockIdx.x % tiles_w) * kTW;
  const int n0 = blockIdx.y * kBN;
  const int bt = blockIdx.z;
  const int b = bt / T, t = bt - b * T;
  const long hw = (long)H * W;
  const long frame0 = (long)b * (T + 2) + t;  // frame t of the extended input

  FragC acc[2][2];
  igemm_zero(acc);
  for (int kt = 0; kt < 3; ++kt) {
    const bf16* xf = x + (frame0 + kt) * hw * cin;
    const float* gs = kGn ? scale + (frame0 + kt) * cin : nullptr;
    const float* gf = kGn ? shift + (frame0 + kt) * cin : nullptr;
    for (int c0 = 0; c0 < cin; c0 += kBK) {
      // the slab: kSlabPix pixels x 4 chunks of 8 channels
      for (int e = tid; e < kSlabPix * (kBK / 8); e += kThreads) {
        const int pix = e >> 2, kc = e & 3;
        const int hh = h0 - 1 + pix / kSW, ww = w0 - 1 + pix % kSW;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (hh >= 0 && hh < H && ww >= 0 && ww < W) {
          v = *reinterpret_cast<const uint4*>(xf + ((long)hh * W + ww) * cin + c0 + kc * 8);
          if constexpr (kGn) v = gn_silu8(v, gs + c0 + kc * 8, gf + c0 + kc * 8);
        }
        *reinterpret_cast<uint4*>(slab + pix * kLdS + kc * 8) = v;
      }
      for (int tap = 0; tap < 9; ++tap) {
        const int kh = tap / 3, kw = tap - kh * 3;
        const bf16* wt = w + ((long)(kt * 9 + tap) * cin + c0) * cout + n0;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int c = tid + kThreads * i;
          const int r = c >> 3, nc = c & 7;
          *reinterpret_cast<uint4*>(sb + r * kLdB + nc * 8) =
              *reinterpret_cast<const uint4*>(wt + (long)r * cout + nc * 8);
        }
        __syncthreads();  // the slab (at the first tap) and this tap's weights are in place
#pragma unroll
        for (int kk = 0; kk < kBK; kk += 16) {
          FragA fa[2];
          FragBRow fb[2];
          // fragment mi of warp wm: output row 2*wm + mi of the patch, its 16 columns
#pragma unroll
          for (int mi = 0; mi < 2; ++mi)
            wmma::load_matrix_sync(fa[mi], slab + ((2 * wm + mi + kh) * kSW + kw) * kLdS + kk, kLdS);
#pragma unroll
          for (int ni = 0; ni < 2; ++ni)
            wmma::load_matrix_sync(fb[ni], sb + kk * kLdB + wn * 32 + ni * 16, kLdB);
#pragma unroll
          for (int mi = 0; mi < 2; ++mi)
#pragma unroll
            for (int ni = 0; ni < 2; ++ni) wmma::mma_sync(acc[mi][ni], fa[mi], fb[ni], acc[mi][ni]);
        }
        __syncthreads();  // before the weights (or, after the last tap, the slab) are replaced
      }
    }
  }
  igemm_store_c(acc, sc);

  // epilogue: tile row m is patch pixel (m / 16, m % 16); 64 rows x 8 chunks of 8 channels
  for (int e = tid; e < kBM * (kBN / 8); e += kThreads) {
    const int m = e >> 3, cc = (e & 7) * 8;
    const int h = h0 + m / kTW, ww = w0 + m % kTW;
    if (h >= H || ww >= W) continue;
    Pack8 out;
#pragma unroll
    for (int j = 0; j < 8; ++j) out.h[j] = __float2bfloat16(sc[m * kLdC + cc + j] + bias[n0 + cc + j]);
    *reinterpret_cast<uint4*>(y + ((long)bt * hw + (long)h * W + ww) * cout + n0 + cc) = out.u;
  }
}

}  // namespace seedvr2

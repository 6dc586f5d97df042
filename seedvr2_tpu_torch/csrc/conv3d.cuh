// K1: stride-1 3x3x3 convolution of the causal video VAE, channels-last;
// K4: the same convolution with the resnet's GroupNorm + SiLU folded into
// its input (template flag kGn); K6: K1's function as one product over the
// folded 27 * Cin axis, which is what this kernel computes for K1 too.
//
// Replaces the Pallas kernels seedvr2_tpu/ops/conv3d_kernel.py:
// conv3d_3x3x3 (_kernel, and _kernel_gn when scale/shift tables are given)
// and conv3d_3x3x3_im2col (_kernel_im2col, which gathers the 27 taps into a
// [M, 27*Cin] VMEM matrix for one contraction). Same contract: the input is
// already extended in time (causal head or streaming carry), SAME zero
// padding in H and W, valid in time, fp32 accumulation, bias added in fp32,
// one rounding to bf16. The Pallas wrapper's jnp.pad and its +7 column
// alignment pad were TPU artefacts: TMA's zero fill is the padding.
//
// The kernel is conv_pipeline.cuh's with this policy: the K axis walks
// (kt, 64-channel chunk, kh, kw), one halo'd slab [64 ch, pw + 8, ph + 2]
// of frame t + kt a (kt, chunk), read by the 9 spatial taps (kh, kw) at
// shifts (kh, kw); the weight [3, 3, 3, Cin, Cout] is the flat [27 * Cin,
// Cout] it already is in memory, tap (kt, kh, kw) at rows (kt * 9 + kh * 3
// + kw) * Cin. Tiles walk output columns fastest, then patch column, patch
// row, frame, batch: blocks in flight at once share their input halos and
// weights in L2.
//
// K4: the GroupNorm statistics are folded by the caller into fp32 tables
// scale/shift [B, T+2, Cin] (one row per frame of the extended input).
// The pipeline's pass (warps 1-3 of the producer warpgroup, on the next
// slab while the consumers multiply this one) rewrites each in-image
// element of a landed slab as silu(x * scale + shift), rounded to bf16,
// once a (kt, chunk), so the normalised tensor is never written to device memory,
// which is what the fusion buys. An out-of-image slab element stays TMA's 0: SAME padding
// pads the normalised activations, and silu(shift) of a raw zero is not 0
// (the Pallas kernel's mask at _kernel_gn does the same).
#pragma once

#include "conv_pipeline.cuh"

namespace seedvr2 {

// silu(v) = h + h tanh(h), h = v / 2: one MUFU op an element (tanh.approx,
// max relative error ~2^-11 of tanh), against two for exp2 and a
// reciprocal, which made K4 slower on the card. Its error is absolute, ~5e-4
// |h| at most: under the bf16 rounding of silu(v) for v > -4, and at most
// ~2e-3 where silu(v) is small (v < -4); rel L2 of the conv against the plain
// version ~4e-4 (bf16 rounding: ~4e-3).
__device__ __forceinline__ float silu_approx(float v) {
  const float h = 0.5f * v;
  float t;
  asm("tanh.approx.f32 %0, %1;" : "=f"(t) : "f"(h));
  return fmaf(h, t, h);
}

// silu(x * scale + shift) of two bf16 channels, in fp32 with the multiply
// and the add rounded separately (as the plain version's two tensor ops),
// rounded once back to bf16.
__device__ __forceinline__ uint32_t gn_silu2(uint32_t x2, float s0, float s1, float f0, float f1) {
  const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&x2);
  return pack_bf16(silu_approx(__fadd_rn(__fmul_rn(__low2float(h), s0), f0)),
                   silu_approx(__fadd_rn(__fmul_rn(__high2float(h), s1), f1)));
}

template <bool kGn>
struct Conv3dPolicy {
  static constexpr int kTaps = 9;       // (kh, kw), kh * 3 + kw
  static constexpr int kHalo = 2;       // the slab is ph + 2 pixel rows
  static constexpr bool kTransform = kGn;
  // K4 loads a slab a whole stage ahead, so that its pass hides behind the
  // stage before (3 slab stages leave room for 3 weight stages)
  static constexpr int kSlabStages = kGn ? 3 : 2, kWStages = kGn ? 3 : 6;

  conv::Geometry g;
  int T, cout, tiles_n;
  const float* bias;      // [cout]
  const float* gn_scale;  // [B, T+2, cin] (K4)
  const float* gn_shift;  // [B, T+2, cin] (K4)
  bf16* y;                // [B, T, H, W, cout]

  struct Tile {
    int b, t, h0, w0, n0;
  };

  __device__ Tile tile(int i) const {
    Tile c;
    c.n0 = (i % tiles_n) * conv::kBN;
    i /= tiles_n;
    c.w0 = (i % g.tiles_w) * g.pw;
    i /= g.tiles_w;
    c.h0 = (i % g.tiles_h) * g.ph;
    i /= g.tiles_h;
    c.t = i % T;
    c.b = i / T;
    return c;
  }
  __device__ int temporal_taps() const { return 3; }
  // the box [64 ch, pw + 8, ph + 2] at channel ch * 64, pixel (h0 - 1, w0 - 1) of frame t + kt
  __device__ void slab(const Tile& c, int kt, int ch, int (&o)[5]) const {
    o[0] = ch * conv::kBK;
    o[1] = c.w0 - 1;
    o[2] = c.h0 - 1;
    o[3] = c.t + kt;
    o[4] = c.b;
  }
  __device__ int weight_col(const Tile& c) const { return c.n0; }
  __device__ int weight_row(const Tile&, int kt, int tap) const { return (kt * 9 + tap) * g.cin; }
  __device__ static int2 tap_offset(int tap) { return make_int2(tap / 3, tap % 3); }

  __device__ float2 col_bias(const Tile& c, int col) const {
    return __ldg(reinterpret_cast<const float2*>(bias + c.n0 + col));
  }
  __device__ bf16* out(const Tile& c, int h, int w) const {
    return y + ((((long)c.b * T + c.t) * g.H + h) * g.W + w) * cout + c.n0;
  }
  __device__ uint32_t edge(const Tile&, int, int) const { return 0u; }
  __device__ float2 fix_bias(const Tile&, uint32_t, int, float2 b) const { return b; }
  __device__ bool column_ok(const Tile&, int) const { return true; }

  // K4's pass on the slab of (kt, chunk ch): pass thread pt (0..95) owns
  // the 8 channels 8 (pt % 8) .. + 7 of the chunk (a 16-byte unit of a
  // pixel row, stored at unit (pt % 8) ^ (r % 8) of slab row r by the
  // 128-byte swizzle) and every 12th pixel of the (ph + 2) x (pw + 2)
  // region the taps read, two pixels a step so that their dependent chains
  // overlap; it reads its 8 channels' table entries once a slab.
  __device__ void transform(const Tile& c, int kt, int ch, unsigned char* buf, int pt) const {
    const int un = pt & 7;
    const long row = ((long)c.b * (T + 2) + c.t + kt) * g.cin + ch * conv::kBK + 8 * un;
    float s[8], f[8];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float4 s4 = __ldg(reinterpret_cast<const float4*>(gn_scale + row) + h);
      const float4 f4 = __ldg(reinterpret_cast<const float4*>(gn_shift + row) + h);
      s[4 * h] = s4.x, s[4 * h + 1] = s4.y, s[4 * h + 2] = s4.z, s[4 * h + 3] = s4.w;
      f[4 * h] = f4.x, f[4 * h + 1] = f4.y, f[4 * h + 2] = f4.z, f[4 * h + 3] = f4.w;
    }
    const int rows = g.ph + 2, cols = g.pw + 2, sw = g.pw + 8;
    constexpr int kSlots = conv::kPassThreads / 8;  // pixels a step of the 96 threads, for each of a pair
    int sr[2] = {0, 0}, sc[2] = {pt >> 3, (pt >> 3) + kSlots};  // cols >= 18 > kSlots: one wrap at most
    if (sc[1] >= cols) {
      sc[1] -= cols;
      ++sr[1];
    }
    while (sr[0] < rows) {
      uint4* u[2];
      uint4 v[2];
      bool ok[2];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int r = sr[k] * sw + sc[k];
        ok[k] = sr[k] < rows && (unsigned)(c.h0 - 1 + sr[k]) < (unsigned)g.H &&
                (unsigned)(c.w0 - 1 + sc[k]) < (unsigned)g.W;
        u[k] = reinterpret_cast<uint4*>(buf + r * 128 + ((un ^ (r & 7)) << 4));
        v[k] = ok[k] ? *u[k] : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        v[k].x = gn_silu2(v[k].x, s[0], s[1], f[0], f[1]);
        v[k].y = gn_silu2(v[k].y, s[2], s[3], f[2], f[3]);
        v[k].z = gn_silu2(v[k].z, s[4], s[5], f[4], f[5]);
        v[k].w = gn_silu2(v[k].w, s[6], s[7], f[6], f[7]);
        if (ok[k]) *u[k] = v[k];
        sc[k] += 2 * kSlots;
        while (sc[k] >= cols) {
          sc[k] -= cols;
          ++sr[k];
        }
      }
    }
  }
};

}  // namespace seedvr2

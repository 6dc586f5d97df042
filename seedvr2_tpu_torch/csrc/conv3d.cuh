// K1: stride-1 3x3x3 convolution of the causal video VAE, channels-last,
// and K4: the same convolution with the resnet's GroupNorm + SiLU folded
// into its input load (template flag kGn).
//
// Replaces the Pallas kernel seedvr2_tpu/ops/conv3d_kernel.py:conv3d_3x3x3
// (_kernel, and _kernel_gn when scale/shift tables are given). Same
// contract: the input is already extended in time (causal head or streaming
// carry), SAME zero padding in H and W, valid in time, fp32 accumulation,
// bias added in fp32, output in bf16. The Pallas wrapper's jnp.pad and its
// +7 column alignment pad were TPU artefacts and are gone: the slab loads
// are predicated on the unpadded input.
//
// What bounds it on the H100: tensor-core issue (27*Cin*2 FLOPs per output
// value) and, behind it, the L2 -> shared memory traffic of the weight and
// slab tiles. The design is the conv core's (conv_core.cuh): an implicit
// GEMM of M = 256 output pixels (a 16 x 16 patch of one frame, from an 18 x
// 18 halo'd slab) x N = 128 output channels x K = 27 * Cin, walked as
// (temporal tap, 32-channel chunk) stages, each warp reading the 9 spatial
// taps from the slab at shifted offsets. This policy maps the stage to
// frame t + kt of the extended input and rows (kt*9 + tap)*Cin + c of the
// weights, laid out once at load as [27, Cin, Cout]; batch, frames, patches
// and column blocks ride blockIdx.x.
//
// Chunk depth, ring and occupancy: a stage is the slab (324 pixels x 40
// bf16, 25,920 B) and 9 weight tiles of 32 x 128 bf16 (73,728 B); the two
// stages are 199,296 B of the 227 KB a block may have, so one block (8
// warps) an SM, with up to 255 registers a thread (128 fp32 accumulators,
// 48 B-fragment and 4 A-fragment registers of the tap walk). 32-channel
// chunks give each warp 576 mma.sync between barriers.
//
// K4 (kGn): the GroupNorm statistics are folded by the caller into fp32
// tables scale/shift [B, T+2, Cin] (one row per frame of the extended
// input). cp.async lands the raw slab chunk; each thread then stores every
// in-image element of the units it copied as silu(x * scale + shift),
// rounded to bf16, with its 8 channels' table entries read once a stage,
// so each element is normalised once per block and stage. The normalised
// tensor is never written to device memory, which is what the fusion buys.
// An out-of-image slab element stays 0: SAME padding pads the normalised
// activations, and silu(shift) of a raw zero is not 0 (the Pallas kernel's
// mask at _kernel_gn does the same).
#pragma once

#include "conv_core.cuh"

namespace seedvr2 {

// silu(x * scale + shift) of eight bf16 channels, in fp32 with the multiply
// and the add rounded separately (as the plain version's two tensor ops),
// rounded once back to bf16. The sigmoid takes the hardware exp2 and
// reciprocal (__expf, __fdividef: a few fp32 ulps, far under the bf16
// rounding that follows); IEEE expf and division made the pass cost ~40%
// of the conv.
struct GnSilu8 {
  float s[8], f[8];  // the eight channels' scale and shift
  __device__ uint4 operator()(uint4 raw) const {
    Pack8 in, out;
    in.u = raw;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float v = __fadd_rn(__fmul_rn(__bfloat162float(in.h[j]), s[j]), f[j]);
      out.h[j] = __float2bfloat16(__fdividef(v, 1.0f + __expf(-v)));
    }
    return out.u;
  }
};

struct Conv3dArgs {
  const bf16* x;       // [B, T+2, H, W, cin]
  const bf16* w;       // [27, cin, cout]
  const float* bias;   // [cout]
  const float* scale;  // [B, T+2, cin] (K4)
  const float* shift;  // [B, T+2, cin] (K4)
  bf16* y;             // [B, T, H, W, cout]
  int T, H, W, cin, cout;
};

// grid = B * ceil(H/16) * ceil(W/16) * T * cout/128 blocks.
template <bool kGn>
struct Conv3dPolicy {
  using Args = Conv3dArgs;
  static constexpr int kBK = 32;
  static constexpr int kDY = 3, kDX = 3, kTiles = 9;  // weight tile kh * 3 + kw of the temporal tap
  static constexpr bool kPrepare = kGn;
  __host__ __device__ static constexpr bool uses(int, int) { return true; }
  __host__ __device__ static constexpr int b_tile(int dy, int dx, int) { return dy * kDX + dx; }
  // warp wn's output channels n0 + 64 wn ..: 16-column group np at unit 8 wn + 2 np
  __host__ __device__ static constexpr int b_unit(int wn, int np) { return wn * 8 + np * 2; }
  using L = conv::Layout<kBK, kTiles>;
  using Prep = GnSilu8;

  const Args a;  // a copy: the compiler reads its fields from the parameter space
  int h0_, w0_, n0, bt;
  long frame0;  // frame t of the extended input of batch b

  // blockIdx.x = ((b * tiles + tile) * T + t) * (cout / 128) + column block:
  // the blocks that read the same input (a frame's column blocks, and the
  // frames whose temporal taps overlap) run side by side and share it in L2
  __device__ explicit Conv3dPolicy(const Args& args) : a(args) {
    const int tiles_w = (a.W + conv::kPW - 1) / conv::kPW;
    const int tiles = (a.H + conv::kPH - 1) / conv::kPH * tiles_w;
    const int nbk = a.cout / conv::kBN;
    int idx = blockIdx.x;
    n0 = (idx % nbk) * conv::kBN;
    idx /= nbk;
    const int t = idx % a.T;
    idx /= a.T;
    const int tile = idx % tiles, b = idx / tiles;
    h0_ = (tile / tiles_w) * conv::kPH;
    w0_ = (tile % tiles_w) * conv::kPW;
    bt = b * a.T + t;
    frame0 = (long)b * (a.T + 2) + t;
  }
  __device__ int H() const { return a.H; }
  __device__ int W() const { return a.W; }
  __device__ int h0() const { return h0_; }
  __device__ int w0() const { return w0_; }
  __device__ int cin() const { return a.cin; }
  __device__ int temporal_taps() const { return 3; }
  __device__ const bf16* frame(int kt) const { return a.x + (frame0 + kt) * a.H * a.W * a.cin; }
  __device__ const bf16* weight(int kt, int tap, int k, int col) const {
    return a.w + ((long)(kt * 9 + tap) * a.cin + k) * a.cout + n0 + col;
  }
  __device__ int ox(int) const { return 0; }

  // K4: the transform of channels c .. c+7 of frame t + kt, its fp32 table
  // entries read once (16-byte aligned rows)
  __device__ GnSilu8 prep(int kt, int c) const {
    GnSilu8 g;
    const long row = (frame0 + kt) * a.cin + c;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float4 s4 = *reinterpret_cast<const float4*>(a.scale + row + 4 * h);
      const float4 f4 = *reinterpret_cast<const float4*>(a.shift + row + 4 * h);
      g.s[4 * h] = s4.x, g.s[4 * h + 1] = s4.y, g.s[4 * h + 2] = s4.z, g.s[4 * h + 3] = s4.w;
      g.f[4 * h] = f4.x, g.f[4 * h + 1] = f4.y, g.f[4 * h + 2] = f4.z, g.f[4 * h + 3] = f4.w;
    }
    return g;
  }

  // accumulator (mi, ni, c): pixel (h0 + 4*wm + mi, w0 + g [+8 for c2, c3]),
  // channel n0 + 64*wn + 8*ni + 2t [+1]
  __device__ void store(const conv::Acc& acc, int wm, int wn, int lane) const {
    const int g = lane >> 2, t = lane & 3;
    const int c = n0 + wn * 64 + 2 * t;
    float bias[8][2];
#pragma unroll
    for (int ni = 0; ni < 8; ++ni) {
      bias[ni][0] = a.bias[c + ni * 8];
      bias[ni][1] = a.bias[c + ni * 8 + 1];
    }
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
      const int h = h0_ + 4 * wm + mi;
      if (h >= a.H) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int w = w0_ + g + 8 * half;
        if (w >= a.W) continue;
        bf16* out = a.y + (((long)bt * a.H + h) * a.W + w) * a.cout + c;
#pragma unroll
        for (int ni = 0; ni < 8; ++ni)
          *reinterpret_cast<uint32_t*>(out + ni * 8) = pack_bf16(acc[mi][ni][2 * half] + bias[ni][0],
                                                                 acc[mi][ni][2 * half + 1] + bias[ni][1]);
      }
    }
  }
};

}  // namespace seedvr2

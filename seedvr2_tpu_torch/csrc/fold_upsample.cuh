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
// What bounds it on the H100: like K1, tensor-core issue (kt*4*C*2 FLOPs
// per output value) and the L2 -> shared memory traffic behind it; on top,
// its output is four times the input's spatial size, so the store must not
// add a pass. The design is the conv core's (conv_core.cuh) with this
// policy: for temporal phase a, the four spatial phases are one 3x3 conv
// over the low-resolution input whose output columns are the phases'
// channel blocks. A block covers all four phases of a 16 x 16 low-res
// patch: M = 256 pixels x N = 4 phases x 32 channels, each phase's 32
// columns taken from its C-wide column block ((a*2+u)*2+v)*C of the folded
// weight. Warp (wm, wn) runs the phases (u, wn), u = 0, 1, on patch rows
// 4*wm.. and walks exactly their 2 x 2 taps (slab offsets u+dh, wn+dw) for
// each temporal tap, so no zero tap is multiplied and the warps' loads
// balance. The shared slab is loaded once per (temporal tap, chunk) for all
// four phases (it was read four times, one grid.z slice per phase). The
// masked bias table and bc are added in the epilogue, and each result is
// stored from registers to its interleaved high-res position, so the phase
// tensor never exists in memory.
//
// Chunk depth, ring and occupancy: a K2 stage multiplies 4 of K1's 9 taps
// on the same slab, so it takes 64 channels to give each warp as many
// products between barriers (512 mma.sync) as K1's 32. A stage is the slab
// (324 pixels x 72 bf16, 46,656 B) and the 4 taps' tiles of 64 x 128 bf16
// (65,536 B, swizzled rather than padded: padded rows would not fit); the
// two stages are 224,384 B of the 227 KB, so one block (8 warps) an SM.
#pragma once

#include "conv_core.cuh"

namespace seedvr2 {

struct FoldArgs {
  const bf16* x;      // [B, Tp+kt-1, H, W, C]
  const bf16* K;      // [kt, 2, 2, C, A*4*C]
  const float* btab;  // [2, 2, A*4*C]
  const float* bc;    // [C]
  bf16* y;            // [B, Tp*A, 2H, 2W, C]
  int Tp, kt, A, H, W, C;
};

// grid = B * ceil(H/16) * ceil(W/16) * Tp * A * C/32 blocks.
struct FoldPolicy {
  using Args = FoldArgs;
  static constexpr int kBK = 64;
  // tap rows dy = u + dh (slab row offsets 0..2) x tap columns dw; column
  // half u of a warp (spatial phase row u) takes tap rows u and u + 1. The
  // stage holds the 4 taps' tiles (dh, dw), columns 64 u + 32 v + channel.
  static constexpr int kDY = 3, kDX = 2, kTiles = 4;
  static constexpr bool kPrepare = false;
  __host__ __device__ static constexpr bool uses(int dy, int u) { return dy >= u && dy <= u + 1; }
  __host__ __device__ static constexpr int b_tile(int dy, int dx, int u) { return (dy - u) * 2 + dx; }
  // warp wn = v: 16-column group np of phase (u, v) = (np >> 1, wn) at unit 8 u + 4 v + 2 (np & 1)
  __host__ __device__ static constexpr int b_unit(int wn, int np) { return (np >> 1) * 8 + wn * 4 + (np & 1) * 2; }
  using L = conv::Layout<kBK, kTiles>;

  const Args a;  // a copy: the compiler reads its fields from the parameter space
  int h0_, w0_, c0, ph;  // c0: the block's first output channel; ph: temporal phase
  long P, frame0, out_frame;

  // blockIdx.x = (((b * tiles + tile) * Tp + tp) * A + ph) * (C / 32) + channel
  // block: the blocks that read the same input (a frame's channel blocks and
  // temporal phases, and the frames whose temporal taps overlap) run side by
  // side and share it in L2
  __device__ explicit FoldPolicy(const Args& args) : a(args) {
    const int tiles_w = (a.W + conv::kPW - 1) / conv::kPW;
    const int tiles = (a.H + conv::kPH - 1) / conv::kPH * tiles_w;
    const int ncb = a.C / 32;
    int idx = blockIdx.x;
    c0 = (idx % ncb) * 32;
    idx /= ncb;
    ph = idx % a.A;
    idx /= a.A;
    const int tp = idx % a.Tp;
    idx /= a.Tp;
    const int tile = idx % tiles, b = idx / tiles;
    h0_ = (tile / tiles_w) * conv::kPH;
    w0_ = (tile % tiles_w) * conv::kPW;
    frame0 = (long)b * (a.Tp + a.kt - 1) + tp;
    out_frame = ((long)b * a.Tp + tp) * a.A + ph;
    P = (long)a.A * 4 * a.C;
  }
  __device__ int H() const { return a.H; }
  __device__ int W() const { return a.W; }
  __device__ int h0() const { return h0_; }
  __device__ int w0() const { return w0_; }
  __device__ int cin() const { return a.C; }
  __device__ int temporal_taps() const { return a.kt; }
  __device__ const bf16* frame(int dt) const { return a.x + (frame0 + dt) * a.H * a.W * a.C; }
  // spatial phase (u, v)'s column block of the folded weight, from channel c0
  __device__ long phase_col(int u, int v) const { return (long)((ph * 2 + u) * 2 + v) * a.C + c0; }
  // tile (dh, dw) = tap dh * 2 + dw of temporal tap dt; column col = 64 u + 32 v + channel
  __device__ const bf16* weight(int dt, int tap, int k, int col) const {
    return a.K + ((long)(dt * 4 + tap) * a.C + k) * P + phase_col(col >> 6, (col >> 5) & 1) + (col & 31);
  }
  __device__ int ox(int wn) const { return wn; }

  // accumulator (mi, ni, c) of warp (wm, wn): low-res pixel (i, j) = (h0 +
  // 4*wm + mi, w0 + g [+8 for c2, c3]) of spatial phase (u, v) = (ni >> 2,
  // wn), channel c0 + 8*(ni & 3) + 2t [+1]; it goes to output pixel
  // (2i+u, 2j+v) of frame out_frame.
  __device__ void store(const conv::Acc& acc, int wm, int wn, int lane) const {
    const int g = lane >> 2, t = lane & 3;
    const int v = wn;
    const long row0 = out_frame * 2 * a.H;
#pragma unroll
    for (int ni = 0; ni < 8; ++ni) {
      const int u = ni >> 2;
      const int c = c0 + (ni & 3) * 8 + 2 * t;
      const long pcol = phase_col(u, v) + (ni & 3) * 8 + 2 * t;
      float bt[4][2];
#pragma unroll
      for (int tap = 0; tap < 4; ++tap) {
        bt[tap][0] = a.btab[tap * P + pcol];
        bt[tap][1] = a.btab[tap * P + pcol + 1];
      }
      const float bc0 = a.bc[c], bc1 = a.bc[c + 1];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int i = h0_ + 4 * wm + mi;
        if (i >= a.H) continue;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int j = w0_ + g + 8 * half;
          if (j >= a.W) continue;
          float v0 = acc[mi][ni][2 * half] + bc0, v1 = acc[mi][ni][2 * half + 1] + bc1;
#pragma unroll
          for (int dh = 0; dh < 2; ++dh) {
            const int hh = i + u + dh - 1;
            if (hh < 0 || hh >= a.H) continue;
#pragma unroll
            for (int dw = 0; dw < 2; ++dw) {
              const int ww = j + v + dw - 1;
              if (ww < 0 || ww >= a.W) continue;
              v0 += bt[dh * 2 + dw][0];
              v1 += bt[dh * 2 + dw][1];
            }
          }
          bf16* out = a.y + ((row0 + 2 * i + u) * 2 * a.W + 2 * j + v) * a.C + c;
          *reinterpret_cast<uint32_t*>(out) = pack_bf16(v0, v1);
        }
      }
    }
  }
};

}  // namespace seedvr2

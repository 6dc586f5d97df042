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
// (out-of-frame taps read zero, so they must not add their expansion bias),
// with phase block ((a*2+u)*2+v)*C .. + C of the folded weight's A*4*C
// columns.
//
// What bounds it on the H100: like K1, tensor-core work (kt*4*C*2 FLOPs per
// output value); on top, its output is four times the input's spatial
// size, so the store must not add a pass. The kernel is conv_pipeline.cuh's
// with this policy: a tile is one phase (a, u, v) of a 256-pixel low-res
// patch x 128 of its C channels, and its 2 x 2 spatial taps read one halo'd
// slab [64 ch, pw + 8, ph + 1] at pixel (h0 - 1 + u, w0 - 1 + v) of frame
// tp + dt, tap (dh, dw) at shift (dh, dw); the weight is K viewed flat
// [kt*4*C, A*4*C], tap (dt, dh, dw) at rows (dt*4 + dh*2 + dw) * C, the
// tile's columns at its phase block. So no zero tap is multiplied, and each
// product is a full m64n128k16 (a tile over the four phases at 32 channels
// each would run products of 32 to 128 columns, the narrow ones bound by
// shared-memory reads of the slab, for the same slab and weight bytes a
// tile). Tiles walk channel blocks fastest, then spatial phase, temporal
// phase, patch column, patch row, frame, batch: blocks in flight at once
// share a patch's slabs in L2. The epilogue adds bc and the masked bias
// table (interior pixels: bc + all four taps, read once a tile; a pixel on
// the frame's edge subtracts the taps that fall outside) and stores each
// result from registers to its interleaved high-res position, so the phase
// tensor never exists in memory. C % 128 == 64 is taken too: the last
// channel block's upper 64 columns are computed and not stored.
#pragma once

#include "conv_pipeline.cuh"

namespace seedvr2 {

struct FoldPolicy {
  static constexpr int kTaps = 4;       // (dh, dw), dh * 2 + dw
  static constexpr int kHalo = 1;       // the slab is ph + 1 pixel rows
  static constexpr bool kTransform = false;
  static constexpr int kSlabStages = 2, kWStages = 6;  // a slab a stage ahead (3 and 4) ran no faster

  conv::Geometry g;   // g.cin = C
  int Tp, kt, A, tiles_n;
  int P;              // A * 4 * C, the folded weight's columns
  const float* btab;  // [2, 2, P]
  const float* bc;    // [C]
  bf16* y;            // [B, Tp*A, 2H, 2W, C]

  struct Tile {
    int b, tp, h0, w0, a, u, v, n0;
    int pcol;  // the tile's first column of the folded weight
  };

  __device__ Tile tile(int i) const {
    Tile c;
    c.n0 = (i % tiles_n) * conv::kBN;
    i /= tiles_n;
    c.u = (i >> 1) & 1;
    c.v = i & 1;
    i >>= 2;
    c.a = i % A;
    i /= A;
    c.w0 = (i % g.tiles_w) * g.pw;
    i /= g.tiles_w;
    c.h0 = (i % g.tiles_h) * g.ph;
    i /= g.tiles_h;
    c.tp = i % Tp;
    c.b = i / Tp;
    c.pcol = ((c.a * 2 + c.u) * 2 + c.v) * g.cin + c.n0;
    return c;
  }
  __device__ int temporal_taps() const { return kt; }
  // the box [64 ch, pw + 8, ph + 1] at channel ch * 64, pixel (h0 - 1 + u, w0 - 1 + v) of frame tp + dt
  __device__ void slab(const Tile& c, int dt, int ch, int (&o)[5]) const {
    o[0] = ch * conv::kBK;
    o[1] = c.w0 - 1 + c.v;
    o[2] = c.h0 - 1 + c.u;
    o[3] = c.tp + dt;
    o[4] = c.b;
  }
  __device__ int weight_col(const Tile& c) const { return c.pcol; }
  __device__ int weight_row(const Tile&, int dt, int tap) const { return (dt * 4 + tap) * g.cin; }
  __device__ static int2 tap_offset(int tap) { return make_int2(tap >> 1, tap & 1); }

  __device__ bool column_ok(const Tile& c, int col) const { return c.n0 + col < g.cin; }
  // bc + the four taps' expansion bias of columns col, col + 1
  __device__ float2 col_bias(const Tile& c, int col) const {
    if (!column_ok(c, col)) return make_float2(0.f, 0.f);
    float2 s = __ldg(reinterpret_cast<const float2*>(bc + c.n0 + col));
#pragma unroll
    for (int tap = 0; tap < 4; ++tap) {
      const float2 t = __ldg(reinterpret_cast<const float2*>(btab + (long)tap * P + c.pcol + col));
      s.x += t.x;
      s.y += t.y;
    }
    return s;
  }
  // low-res pixel (i, j) of the tile's frame and phase -> output pixel (2i+u, 2j+v) of frame tp*A+a
  __device__ bf16* out(const Tile& c, int i, int j) const {
    const long frame = ((long)c.b * Tp + c.tp) * A + c.a;
    return y + (((frame * 2 * g.H + 2 * i + c.u) * 2 * g.W) + 2 * j + c.v) * g.cin + c.n0;
  }
  // bit dh * 2 + dw: low-res tap (i+u+dh-1, j+v+dw-1) lies outside the frame
  __device__ uint32_t edge(const Tile& c, int i, int j) const {
    const uint32_t rows = (i + c.u - 1 < 0 ? 1u : 0u) | (i + c.u >= g.H ? 2u : 0u);  // bit dh
    const uint32_t cols = (j + c.v - 1 < 0 ? 1u : 0u) | (j + c.v >= g.W ? 2u : 0u);  // bit dw
    uint32_t out = 0;
#pragma unroll
    for (int tap = 0; tap < 4; ++tap)
      if (((rows >> (tap >> 1)) | (cols >> (tap & 1))) & 1u) out |= 1u << tap;
    return out;
  }
  __device__ float2 fix_bias(const Tile& c, uint32_t edge, int col, float2 b) const {
    if (!column_ok(c, col)) return b;
#pragma unroll
    for (int tap = 0; tap < 4; ++tap)
      if ((edge >> tap) & 1u) {
        const float2 t = __ldg(reinterpret_cast<const float2*>(btab + (long)tap * P + c.pcol + col));
        b.x -= t.x;
        b.y -= t.y;
      }
    return b;
  }
};

}  // namespace seedvr2

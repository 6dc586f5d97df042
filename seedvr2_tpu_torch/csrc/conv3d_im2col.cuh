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
// in time, fp32 accumulation, bias in fp32, one rounding to bf16.
//
// What bounds it on the H100: tensor-core work, 2 * 27 * Cin FLOPs per
// output value against ~4 bytes of device-memory traffic, far above the
// ~295 FLOP/byte ridge. What holds a kernel below the bf16 peak is how the
// tensor cores are fed: mma.sync from registers tops out near half of it
// (K1, PERF.md), and the column matrix is never materialised, so its
// panels come from L2, whose bandwidth into shared memory is the next
// limit. The design is Hopper's GEMM pipeline over the folded K axis:
// - Tile. A block owns M = 256 output pixels, a ph x pw patch of one frame
//   (16 x 16, 8 x 32 or 4 x 64: the entry picks the one with the fewest
//   tiles), x N = 128 output columns (every VAE Cout is a multiple of 128).
// - Operands by TMA, folded K in stages of 64. The K axis walks (kt,
//   64-channel chunk, kh, kw); Cin % 64 == 0, so a stage never crosses a
//   tap. A: once per (kt, chunk), one TMA box [64 ch, pw + 8, ph + 2, 1, 1]
//   of the 5-D NDHWC input at (c0, w0 - 1, h0 - 1, t + kt, b): the patch's
//   halo'd slab, pixel rows of 128 bytes, 128-byte swizzled (K-major, the
//   layout wgmma reads). Coordinates off the image come back as zeros:
//   that is the SAME padding and the ragged patch, with no predicate in the
//   kernel. The 9 spatial taps read the one slab through descriptors that
//   start (kh, kw) pixels further in, so the input goes from L2 into shared
//   memory once per 9 taps, not 9 times (a box per tap made K6 L2-bound:
//   PERF.md). The slab is pw + 8 pixels wide, not pw + 2, so that a row of
//   8-pixel core matrices is a multiple of 1024 bytes and every core matrix
//   of a descriptor sits at the same phase (kw) of the swizzle atom. B: per tap, two boxes [64 cols, 64 k
//   rows] of Wf [27*Cin, Cout] (K1's stored weight viewed flat), N-major,
//   which wgmma reads transposed (tnspB); no copy of the weight is made.
// - Pipeline. Two rings with a full and an empty mbarrier per stage: 2
//   slab stages (54 KB) and 6 weight stages (16 KB). Warpgroup 0 is the
//   producer: one thread arms a full barrier with the bytes a stage will
//   receive (zero-filled ones included) and issues its TMA loads, slab
//   first, then the 9 taps' weights; it keeps both rings full across tiles,
//   so the next tile's loads overlap this tile's epilogue (the grid is
//   persistent: one block an SM walks tiles blockIdx.x, + gridDim.x, ...).
// - Products. Warpgroups 1 and 2 each own two 64-row operands of the tile
//   (8 core matrices of 8 pixels at one stride in the slab): per tap 8
//   wgmma.m64n128k16 (2 operands x 4 k16 steps). Each tap's group is
//   committed and the group before it waited for (wait_group 1), so one
//   group is always queued behind the running one; only then are the
//   earlier weight stage, and after a slab's last tap the slab, released
//   (one arrival per warpgroup). setmaxnreg gives the consumers 232
//   registers (128 accumulators a thread) and the producer 40.
// - Epilogue from registers: the fp32 bias is added, each pair rounded to
//   bf16, a 4 x 4 transpose inside each lane quad turns four 4-byte pairs
//   into one 16-byte run of 8 columns, and pixels past the frame are
//   masked. No fp32 tile goes through shared memory.
#pragma once

#include "common.cuh"
#include "hopper.cuh"

namespace seedvr2 {
namespace im2col {

constexpr int kBM = 256;         // output pixels per tile (ph * pw)
constexpr int kBN = 128;         // output columns per tile
constexpr int kBK = 64;          // folded-K depth of a stage: 64 channels of one tap
constexpr int kConsumers = 2;    // consumer warpgroups, two 64-row operands each
constexpr int kThreads = 128 * (1 + kConsumers);
constexpr int kSlabStages = 2;
constexpr int kWStages = 6;
constexpr int kSlabRows = 432;   // the largest slab, (ph + 2) * (pw + 8) pixels: 18 x 24 or 6 x 72
constexpr int kSlabBytes = kSlabRows * 128;
constexpr int kWHalfBytes = kBK * 64 * 2;    // 64 k rows of 64 columns
constexpr int kWBytes = 2 * kWHalfBytes;
constexpr int kBarrierBytes = 2 * (kSlabStages + kWStages) * 8;
constexpr int kSmemBytes = kSlabStages * kSlabBytes + kWStages * kWBytes + kBarrierBytes + 1024;  // + alignment slack
static_assert(kSlabBytes % 1024 == 0 && kWBytes % 1024 == 0, "stages stay 1024-byte aligned for the swizzle");

struct Args {
  const float* bias;  // [cout] fp32
  bf16* y;            // [B, T, H, W, cout]
  int T, H, W, cin, cout;
  int ph, pw;         // patch, ph * pw == kBM; the slab is (ph + 2) x (pw + 8) pixels
  int tiles_h, tiles_w, tiles_n, num_tiles;
};

struct Tile {
  int b, t, h0, w0, n0;
};

// Tile i of the walk: output columns fastest, then patch column, patch row,
// frame; blocks in flight at once share their input halos and weights in L2.
__device__ __forceinline__ Tile tile_at(const Args& a, int i) {
  Tile c;
  c.n0 = (i % a.tiles_n) * kBN;
  i /= a.tiles_n;
  c.w0 = (i % a.tiles_w) * a.pw;
  i /= a.tiles_w;
  c.h0 = (i % a.tiles_h) * a.ph;
  i /= a.tiles_h;
  c.t = i % a.T;
  c.b = i / a.T;
  return c;
}

// 64-row operand m (0..3) of a tile: core matrix j (rows 8j .. 8j+7) is the
// 8 pixels (py0 + j dy, px0 + j dx + 0..7) of the patch. With ph >= 8 an
// operand is 8 patch rows of one 8-pixel column group; at 4 x 64 it is one
// patch row.
struct Operand {
  int py0, px0, dy, dx;
};

__device__ __forceinline__ Operand operand(const Args& a, int m) {
  if (a.ph < 8) return Operand{m, 0, 0, 8};
  const int groups = a.pw / 8;
  return Operand{8 * (m / groups), 8 * (m % groups), 1, 0};
}

__device__ __forceinline__ uint32_t pick4(const uint32_t (&v)[4], int i) {
  return i == 0 ? v[0] : i == 1 ? v[1] : i == 2 ? v[2] : v[3];
}

// One consumer warpgroup's operands of a finished tile: + bias, bf16, stored.
// Lane (g, q) = (lane / 4, lane % 4) holds columns 8j + 2q, +1 of rows g and
// g + 8 of each 16-row warp slice, i.e. pixel g of core matrices 2 warp and
// 2 warp + 1; four 8-column blocks at a time, the quad swaps pairs so that
// lane q ends with all 8 columns of block 4 j4 + q.
__device__ __forceinline__ void epilogue(const Args& a, const Tile& c, float (&acc)[2][64], const Operand (&op)[2]) {
  const int tid = threadIdx.x & 127;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, q = lane & 3;
  float2 bias[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) bias[j] = __ldg(reinterpret_cast<const float2*>(a.bias + c.n0 + 8 * j + 2 * q));
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int rh = 0; rh < 2; ++rh) {
      const int j = 2 * warp + rh;
      const int h = c.h0 + op[mi].py0 + j * op[mi].dy, w = c.w0 + op[mi].px0 + j * op[mi].dx + g;
      const bool ok = h < a.H && w < a.W;
      bf16* dst = a.y + ((((long)c.b * a.T + c.t) * a.H + h) * a.W + w) * a.cout + c.n0 + 8 * q;
#pragma unroll
      for (int j4 = 0; j4 < 4; ++j4) {
        uint32_t v[4], x[4];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int n = 4 * j4 + jj;
          v[jj] = pack_bf16(acc[mi][4 * n + 2 * rh] + bias[n].x, acc[mi][4 * n + 2 * rh + 1] + bias[n].y);
        }
        // x[s] = lane (q ^ s)'s pair of block q: it sends v[q ^ s], which is what (q ^ s) needs of us
        x[0] = pick4(v, q);
#pragma unroll
        for (int s = 1; s < 4; ++s) x[s] = __shfl_xor_sync(0xffffffffu, pick4(v, q ^ s), s);
        uint4 out;
        out.x = pick4(x, q);
        out.y = pick4(x, q ^ 1);
        out.z = pick4(x, q ^ 2);
        out.w = pick4(x, q ^ 3);
        if (ok) *reinterpret_cast<uint4*>(dst + 32 * j4) = out;
      }
    }
  }
}

__device__ __forceinline__ void advance(int& stage, uint32_t& phase, int stages) {
  if (++stage == stages) {
    stage = 0;
    phase ^= 1;
  }
}

// tmx: x_ext [B, T+2, H, W, cin] bf16 as a 5-D map (box [64, pw + 8, ph + 2,
// 1, 1], 128-byte swizzle, zero fill); tmw: Wf [27*cin, cout] bf16 as a 2-D
// map (box [64, 64], 128-byte swizzle). grid = min(num_tiles, SMs), kThreads
// threads, kSmemBytes of dynamic shared memory.
__global__ void __launch_bounds__(kThreads, 1)
    conv3d_im2col_kernel(const __grid_constant__ CUtensorMap tmx, const __grid_constant__ CUtensorMap tmw,
                         const Args a) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* slab = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* wt = slab + kSlabStages * kSlabBytes;
  uint64_t* slab_full = reinterpret_cast<uint64_t*>(wt + kWStages * kWBytes);
  uint64_t* slab_empty = slab_full + kSlabStages;
  uint64_t* w_full = slab_empty + kSlabStages;
  uint64_t* w_empty = w_full + kWStages;
  const int chunks = a.cin / kBK;
  const int sw = a.pw + 8;  // slab width, pixels

  if (threadIdx.x == 0) {
    for (int s = 0; s < kSlabStages; ++s) {
      sm90::mbar_init(slab_full + s, 1);
      sm90::mbar_init(slab_empty + s, kConsumers);
    }
    for (int s = 0; s < kWStages; ++s) {
      sm90::mbar_init(w_full + s, 1);
      sm90::mbar_init(w_empty + s, kConsumers);
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer: one thread keeps both rings full ----
    sm90::setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      sm90::tma_prefetch(&tmx);
      sm90::tma_prefetch(&tmw);
      const uint32_t slab_bytes = 128u * sw * (a.ph + 2);
      int ss = 0, ws = 0;
      uint32_t sph = 0, wph = 0;
      for (int i = blockIdx.x; i < a.num_tiles; i += gridDim.x) {
        const Tile c = tile_at(a, i);
        for (int kt = 0; kt < 3; ++kt) {
          for (int ch = 0; ch < chunks; ++ch) {
            sm90::mbar_wait(slab_empty + ss, sph ^ 1);
            sm90::mbar_arrive_expect_tx(slab_full + ss, slab_bytes);
            sm90::tma_load_5d(slab + ss * kSlabBytes, &tmx, slab_full + ss, ch * kBK, c.w0 - 1, c.h0 - 1, c.t + kt,
                              c.b);
            advance(ss, sph, kSlabStages);
            for (int tap = 9 * kt; tap < 9 * kt + 9; ++tap) {
              const int krow = tap * a.cin + ch * kBK;
              sm90::mbar_wait(w_empty + ws, wph ^ 1);
              sm90::mbar_arrive_expect_tx(w_full + ws, kWBytes);
              sm90::tma_load_2d(wt + ws * kWBytes, &tmw, w_full + ws, c.n0, krow);
              sm90::tma_load_2d(wt + ws * kWBytes + kWHalfBytes, &tmw, w_full + ws, c.n0 + 64, krow);
              advance(ws, wph, kWStages);
            }
          }
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg - 1 owns operands 2 (wg - 1) and 2 (wg - 1) + 1 ----
    sm90::setmaxnreg_inc<232>();
    const bool leader = (threadIdx.x & 127) == 0;
    const Operand op[2] = {operand(a, 2 * (wg - 1)), operand(a, 2 * (wg - 1) + 1)};
    int row0[2];   // slab row of core matrix 0 at tap (0, 0)
    uint32_t sbo[2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      row0[mi] = op[mi].py0 * sw + op[mi].px0;
      sbo[mi] = 128u * (op[mi].dy * sw + op[mi].dx);  // a multiple of 1024
    }
    float acc[2][64];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int e = 0; e < 64; ++e) acc[mi][e] = 0.f;
    int ss = 0, ws = 0;
    uint32_t sph = 0, wph = 0;
    int prev_w = -1, prev_s = -1;  // released after the next wait_group 1
    for (int i = blockIdx.x; i < a.num_tiles; i += gridDim.x) {
      const Tile c = tile_at(a, i);
      bool first = true;
      for (int kc = 0; kc < 3 * chunks; ++kc) {
        sm90::mbar_wait(slab_full + ss, sph);
        const uint32_t sa = smem_addr(slab + ss * kSlabBytes);
        for (int tap = 0; tap < 9; ++tap) {
          const int shift = (tap / 3) * sw + tap % 3;  // (kh, kw) in slab rows
          sm90::mbar_wait(w_full + ws, wph);
          const uint32_t sb = smem_addr(wt + ws * kWBytes);
          sm90::wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < kBK / 16; ++kk) {
            const uint64_t db = sm90::desc_sw128(sb + kk * 16 * 128, kWHalfBytes, 1024);
#pragma unroll
            for (int mi = 0; mi < 2; ++mi)
              sm90::wgmma_m64n128k16_bf16(acc[mi], sm90::desc_sw128(sa + (row0[mi] + shift) * 128 + kk * 32, 16, sbo[mi]),
                                          db, !(first && kk == 0));
          }
          first = false;
          sm90::wgmma_commit();
          sm90::wgmma_wait<1>();  // the group before this one has retired: release its stages
          if (leader) {
            if (prev_w >= 0) sm90::mbar_arrive(w_empty + prev_w);
            if (prev_s >= 0) sm90::mbar_arrive(slab_empty + prev_s);
          }
          prev_w = ws;
          prev_s = tap == 8 ? ss : -1;
          advance(ws, wph, kWStages);
        }
        advance(ss, sph, kSlabStages);
      }
      sm90::wgmma_wait<0>();
      if (leader) {
        sm90::mbar_arrive(w_empty + prev_w);
        sm90::mbar_arrive(slab_empty + prev_s);
      }
      prev_w = prev_s = -1;
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int e = 0; e < 64; ++e) sm90::fence_operand(acc[mi][e]);
      epilogue(a, c, acc, op);
    }
  }
}

}  // namespace im2col
}  // namespace seedvr2

// The implicit-GEMM main loop shared by K1/K4 (conv3d.cuh) and K2
// (fold_upsample.cuh): one block of 8 warps owns M = 256 output pixels (a
// 16 x 16 patch of one frame) x N = 128 output columns.
//
// What bounds these convolutions on the H100 is tensor-core issue (27*Cin*2
// FLOPs per K1 output value against ~4 bytes of activation traffic, far
// above the ~295 FLOP/byte ridge), so the design keeps the tensor cores fed
// from shared memory and the accumulators in registers; what holds them
// below the bf16 peak is mma.sync itself and the L2 -> shared memory
// traffic of the weight and slab tiles (PERF.md):
// - Tile. Warps are 4 (M: 4 patch rows = 64 pixels each) x 2 (N: 64 columns
//   each); a warp's 64 x 64 fp32 accumulator lives in registers, 128 a
//   lane, in the mma.m16n8k16 layout (ptx.cuh). Each m16 fragment is one
//   patch row of 16 pixels. A 256-row tile feeds 256 FLOPs per weight byte
//   read from L2: a block reads 27 * Cin * 128 * 2 bytes of K1 weights (3.5
//   MB at Cin 512), which at 40% of the bf16 peak is ~1.5 TB/s across the
//   card (a 128-row tile asks twice that); the weights of a whole conv (<=
//   14 MB) stay in the 50 MB L2. 128 accumulators a lane leave the tap
//   walk's fragments and addresses ~120 registers: one block an SM.
// - Operands. The input is read as a halo'd slab of the patch, kSH x kSW =
//   18 x 18 pixels, one channel chunk at a time (out-of-image pixels zero:
//   SAME padding, and the ragged last tile). A fragments come from the slab
//   with ldmatrix, each lane giving its own pixel's row address, so every
//   spatial tap reads the slab at a shifted offset with no copy; a slab
//   pixel is (BK + 8) * 2 bytes, an odd number of 16-byte units, so the 8
//   row addresses of an ldmatrix phase (8 consecutive pixels, whatever the
//   shift) fall on 8 distinct bank groups. B fragments come from the stage's
//   weight tiles ([tile][BK][128], rows of 256 bytes whose 16-byte units
//   are XOR-swizzled by the row, wt_offset) through ldmatrix.trans. A warp
//   walks a kDY x kDX rectangle of taps: for each column shift it holds the
//   kDY tap rows' B fragments and reads each of its 4 + kDY - 1 slab rows
//   once, feeding every patch row that tap row reaches: 18 ldmatrix per 96
//   mma.sync of K1 (shared memory delivers 128 bytes a clock, a quarter of
//   an ldmatrix.x4).
// - Pipeline. A stage is one (temporal tap, BK-channel chunk): the slab
//   chunk and every tap's [BK x 128] weight tile for it, filled by cp.async
//   (16 bytes a thread, zero-fill out of the image) into one of two
//   buffers. One __syncthreads at the top of stage s says that stage s has
//   landed and that every warp is done with the other buffer; the next
//   stage's slab then goes out at once and its weight tiles in kDX parts,
//   one before each column shift of the tap walk, so that the copies
//   interleave with the products rather than leave as one burst of ~24
//   cp.async a thread behind the barrier.
// - Prepare. A policy with kPrepare transforms each slab chunk in place
//   before it is multiplied (K4's GroupNorm + SiLU: cp.async cannot
//   transform data in flight). Each thread transforms the units it copied
//   itself, so its own cp.async wait orders the pass and the barrier at the
//   top of the next stage publishes it. The pass for stage s+1 runs inside
//   stage s, in warps 0-3 before its last column shift and in warps 4-7
//   before the one ahead of it, so that on each SM sub-partition (warps w
//   and w + 4) one warp multiplies while the other prepares, rather than
//   between two barriers with the tensor cores idle.
// - Epilogue from registers: the policy adds its bias in fp32, rounds to
//   bf16 and stores the accumulator pairs straight to their output pixels
//   (K2: to the interleaved high-resolution positions).
//
// A policy P provides (all const):
//   P(args)                         block coordinates from blockIdx
//   kBK                             chunk depth (input channels a stage)
//   kDY, kDX                        the warp's tap rectangle (rows dy, column
//                                   shifts dx)
//   kTiles                          [BK x 128] weight tiles a stage holds
//   uses(dy, nh)                    (constexpr) whether the warp's column
//                                   half nh (32 columns) takes tap row dy
//   b_tile(dy, dx, nh)              (constexpr) the tile it then reads
//   b_unit(wn, np)                  the 16-byte column unit where warp wn's
//                                   16-column group np starts in a tile
//   kPrepare                        whether the slab chunks are prepared
//   int H(), W(), h0(), w0()        frame size and the patch's first pixel
//   int cin()                       input channels (chunks of kBK)
//   int temporal_taps()             stages = temporal_taps() * cin() / kBK
//   const bf16* frame(tt)           the input frame of temporal tap tt
//   const bf16* weight(tt, tile, k, col)  8 weights of row k (input channel,
//                                   absolute) of a tile, columns col..col+7
//   Prep prep(tt, c)                (kPrepare) the transform of channels
//                                   c..c+7 of temporal tap tt: uint4 -> uint4
//   int ox(wn)                      the warp's first tap column in the slab
//   void store(acc, wm, wn, lane)   the epilogue
#pragma once

#include "common.cuh"
#include "ptx.cuh"

namespace seedvr2 {
namespace conv {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kPH = 16, kPW = 16;            // output patch, kPH * kPW = 256 pixels (M)
constexpr int kSH = kPH + 2, kSW = kPW + 2;  // halo'd input slab
constexpr int kSlabPix = kSH * kSW;
constexpr int kBN = 128;                     // output columns per block (N), a weight tile row

// Accumulators of a warp: [patch row mi][8 columns ni][mma.m16n8 c0..c3].
using Acc = float[4][8][4];

template <int BK, int TILES>
struct Layout {
  static_assert(BK % 16 == 0, "a chunk is whole k16 steps");
  static constexpr int kLdS = BK + 8;  // slab pixel: (BK + 8) * 2 bytes, an odd count of 16-byte units
  static constexpr int kSlabBytes = kSlabPix * kLdS * 2;
  static constexpr int kWBytes = TILES * BK * kBN * 2;
  static constexpr int kStageBytes = kSlabBytes + kWBytes;
  static constexpr int kSmemBytes = 2 * kStageBytes;  // the two-stage ring
  static_assert(kSlabBytes % 16 == 0 && kWBytes % 16 == 0, "16-byte aligned regions");
};

// The slab of one stage (temporal tap tt, channels c0 .. c0+BK) into buffer
// st by cp.async, as one group. Each thread copies a fixed 16-byte unit u =
// tid % kUnits of the slab pixels tid / kUnits + i * kPixPerPass, so the
// loop has a constant trip count, and prepare_slab() finds the same units.
template <class P, class L>
__device__ __forceinline__ void fetch_slab(const P& p, unsigned char* st, int tt, int c0) {
  constexpr int kUnits = P::kBK / 8;              // 16-byte units of a slab pixel's chunk
  constexpr int kPixPerPass = kThreads / kUnits;  // slab pixels a pass of the block covers
  static_assert(kThreads % kUnits == 0, "fixed per-thread units");
  const int tid = threadIdx.x;
  bf16* slab = reinterpret_cast<bf16*>(st);
  const int H = p.H(), W = p.W(), cin = p.cin();
  const int u = tid % kUnits;
  const bf16* xf = p.frame(tt) + c0 + u * 8;
#pragma unroll
  for (int i = 0; i < (kSlabPix + kPixPerPass - 1) / kPixPerPass; ++i) {
    const int pix = tid / kUnits + i * kPixPerPass;
    if (kSlabPix % kPixPerPass != 0 && pix >= kSlabPix) break;
    const int hh = p.h0() - 1 + pix / kSW, ww = p.w0() - 1 + pix % kSW;
    const bool ok = hh >= 0 && hh < H && ww >= 0 && ww < W;
    cp_async16(slab + pix * L::kLdS + u * 8, ok ? xf + ((long)hh * W + ww) * cin : xf, ok);
  }
  cp_async_commit();
}

// Weight tile row r keeps its 16-byte column unit c at unit c ^ (r & 7):
// the 8 rows an ldmatrix phase reads (8 consecutive k) then fall on 8
// distinct bank groups with no padding.
__device__ __forceinline__ int wt_offset(int row, int col) { return row * kBN + (((col >> 3) ^ (row & 7)) << 3); }

// Part j (of kDX) of the stage's weight tiles, as one group: a thread copies a
// fixed 16-byte column unit of the rows tid / 16 + 16 i.
template <class P, class L>
__device__ __forceinline__ void fetch_weights(const P& p, unsigned char* st, int tt, int c0, int j) {
  constexpr int BK = P::kBK;
  constexpr int kRowsPerPass = kThreads / (kBN / 8);
  constexpr int kPasses = P::kTiles * BK / kRowsPerPass;
  static_assert(BK % kRowsPerPass == 0 && kPasses % P::kDX == 0, "fixed per-thread units");
  const int tid = threadIdx.x;
  bf16* wt = reinterpret_cast<bf16*>(st + L::kSlabBytes);
  const int col = (tid % (kBN / 8)) * 8, r0 = tid / (kBN / 8);
#pragma unroll
  for (int i = j * kPasses / P::kDX; i < (j + 1) * kPasses / P::kDX; ++i) {
    const int tile = i * kRowsPerPass / BK, k = r0 + (i * kRowsPerPass) % BK;
    cp_async16(wt + wt_offset(tile * BK + k, col), p.weight(tt, tile, c0 + k, col), true);
  }
  cp_async_commit();
}

// kPrepare: transform, in place, the slab units this thread fetched (its own
// copies, so only its own cp.async wait orders them). Out-of-image units
// stay 0.
template <class P, class L>
__device__ __forceinline__ void prepare_slab(const P& p, unsigned char* st, int tt, int c0) {
  constexpr int kUnits = P::kBK / 8, kPixPerPass = kThreads / kUnits;
  const int tid = threadIdx.x, u = tid % kUnits;
  const typename P::Prep prep = p.prep(tt, c0 + u * 8);
  bf16* slab = reinterpret_cast<bf16*>(st);
#pragma unroll
  for (int i = 0; i < (kSlabPix + kPixPerPass - 1) / kPixPerPass; ++i) {
    const int pix = tid / kUnits + i * kPixPerPass;
    if (kSlabPix % kPixPerPass != 0 && pix >= kSlabPix) break;
    const int hh = p.h0() - 1 + pix / kSW, ww = p.w0() - 1 + pix % kSW;
    if (hh < 0 || hh >= p.H() || ww < 0 || ww >= p.W()) continue;
    uint4* v = reinterpret_cast<uint4*>(slab + pix * L::kLdS + u * 8);
    *v = prep(*v);
  }
}

// grid = (the policy's block count), kThreads threads, Layout::kSmemBytes
// of dynamic shared memory.
template <class P>
__global__ void __launch_bounds__(kThreads, 1) conv_kernel(const typename P::Args args) {
  constexpr int BK = P::kBK, DY = P::kDY, DX = P::kDX;
  using L = Layout<BK, P::kTiles>;
  extern __shared__ __align__(128) unsigned char smem[];
  const P p(args);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const int nchunk = p.cin() / BK;
  const int nstage = p.temporal_taps() * nchunk;

  Acc acc;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni) acc[mi][ni][0] = acc[mi][ni][1] = acc[mi][ni][2] = acc[mi][ni][3] = 0.f;

  // stage 0, whole
  fetch_slab<P, L>(p, smem, 0, 0);
#pragma unroll
  for (int j = 0; j < DX; ++j) fetch_weights<P, L>(p, smem, 0, 0, j);
  if constexpr (P::kPrepare) {
    cp_async_wait<DX>();
    prepare_slab<P, L>(p, smem, 0, 0);
  }

  // this lane's ldmatrix rows: A at pixel (lane & 15) of a patch row, B at
  // k row (lane & 15); 16-byte unit lane >> 4 of the 16 columns, for B at
  // its swizzled place: b_unit ^ (lane >> 4) ^ (lane & 7), b_unit even and
  // the tile's rows a multiple of 8
  const int a_lane = ((4 * wm) * kSW + p.ox(wn) + (lane & 15)) * L::kLdS + (lane >> 4) * 8;
  const int b_lane = (lane & 15) * kBN;
  int b_col[4];
#pragma unroll
  for (int np = 0; np < 4; ++np) b_col[np] = (P::b_unit(wn, np) ^ (lane >> 4) ^ (lane & 7)) * 8;

  // kPrepare: warps 0-3 prepare the next slab before the last column shift,
  // warps 4-7 before the one ahead of it, so that on each SM sub-partition
  // (warps w and w + 4) one warp multiplies while the other prepares
  static_assert(!P::kPrepare || DX >= 2, "the prepare pass takes one of the last two column shifts");
  const int prep_dx = DX - 1 - (warp >> 2);

  for (int s = 0; s < nstage; ++s) {
    cp_async_wait<0>();
    __syncthreads();  // stage s landed (and prepared); every warp is done with stage s-1's buffer
    const bool next = s + 1 < nstage;
    const int ntt = (s + 1) / nchunk, nc0 = ((s + 1) % nchunk) * BK;
    unsigned char* nst = smem + ((s + 1) & 1) * L::kStageBytes;
    if (next) fetch_slab<P, L>(p, nst, ntt, nc0);
    const unsigned char* st = smem + (s & 1) * L::kStageBytes;
    const bf16* a_base = reinterpret_cast<const bf16*>(st) + a_lane;
    const bf16* b_base = reinterpret_cast<const bf16*>(st + L::kSlabBytes) + b_lane;
#pragma unroll
    for (int dx = 0; dx < DX; ++dx) {
      // the next stage's weights go out in DX parts, one per column shift,
      // so that the copies interleave with the products
      if (next) fetch_weights<P, L>(p, nst, ntt, nc0, dx);
      if constexpr (P::kPrepare) {
        if (dx == prep_dx && next) {
          cp_async_wait<1>();  // the next slab landed, and every weight part but this one
          prepare_slab<P, L>(p, nst, ntt, nc0);
        }
      }
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        // B fragments of the tap rows at this column shift: [dy][16 columns np]
        uint32_t b[DY][4][4];
#pragma unroll
        for (int dy = 0; dy < DY; ++dy)
#pragma unroll
          for (int np = 0; np < 4; ++np)
            if (P::uses(dy, np >> 1))
              ldsm_x4_trans(b[dy][np], b_base + (P::b_tile(dy, dx, np >> 1) * BK + kk * 16) * kBN + b_col[np]);
        // slab row sr (from the warp's first) feeds patch row mi = sr - dy of tap row dy
#pragma unroll
        for (int sr = 0; sr < 4 + DY - 1; ++sr) {
          uint32_t a[4];
          ldsm_x4(a, a_base + (sr * kSW + dx) * L::kLdS + kk * 16);
#pragma unroll
          for (int dy = 0; dy < DY; ++dy) {
            const int mi = sr - dy;
            if (mi < 0 || mi >= 4) continue;
#pragma unroll
            for (int np = 0; np < 4; ++np) {
              if (!P::uses(dy, np >> 1)) continue;
              mma_bf16(acc[mi][2 * np], a, b[dy][np][0], b[dy][np][1]);
              mma_bf16(acc[mi][2 * np + 1], a, b[dy][np][2], b[dy][np][3]);
            }
          }
        }
      }
    }
  }
  p.store(acc, wm, wn, lane);
}

}  // namespace conv
}  // namespace seedvr2

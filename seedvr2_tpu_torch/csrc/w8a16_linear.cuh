// K7: the W8A16 linear of the int8 DiT, y[M, N] = (x[M, K] @ widen(w[K, N]))
// * scale[N] (+ bias[N]), x and y bf16, w int8 stored [N, K] (K-contiguous),
// scale fp32, bias bf16, the sum in fp32 with one rounding to bf16.
//
// Replaces what XLA does for seedvr2_tpu/models/dit/nadit.py:277-285
// (_apply_linear on an int8 leaf) and seedvr2_tpu/ops/quant.py:43-53
// (linear_apply): a convert of the int8 weight fused into the product, so
// that no dequantized copy of it is ever written. Here the int8 bytes are
// widened to bf16 in registers, exactly (widen_s8x4).
//
// Two regimes, chosen by M in the wrapper (ops/quant.py:regime); both end
// in `finish` (the fp32 sum times the scale plus the bias, one rounding).
//
// 1. Video rows (M > kTextRows: 7200 at 720p, 24,480 on the 1080p long
//    clip). Bound by operations (7B qkv: 0.41 ms at the bf16 peak against
//    0.06 ms of bytes), so the product runs on wgmma, the only way to the
//    card's full tensor rate (mma.sync products alone reach ~44% of it).
//    wgmma reads B from shared memory only, so the weight is A, fed from
//    registers, and the product is the transpose,
//    y^T[N, M] = W[N, K] . x^T[K, M]:
//    - Tile: 128 weight rows (n) x 240 x rows (m). Two consumer warpgroups
//      own 64 n each: wgmma.m64n240k16, 120 fp32 accumulators a thread.
//      240, not wgmma's largest n of 256: the video rows (2 x 45 x 80 =
//      7200 at 720p, 3 x 68 x 120 = 24,480 on the long clip) are multiples
//      of 240, so no m-tile runs part empty (256 leaves 7/8 of the last one
//      empty at 7200, and measured up to 7% slower there).
//    - Loads: one producer thread keeps a 4-stage mbarrier ring full by TMA:
//      x's box [240 rows x 64 k] bf16 with the 128-byte swizzle (K-major B,
//      the layout of K6's A operand) and w's box [128 rows x 64 k] int8,
//      unswizzled. Boxes past M or N land as zeros. The grid is persistent
//      (one block an SM) and walks the tiles in groups of kGroupM m-tiles,
//      so that the blocks in flight share their x and w tiles in L2. (Two
//      CTAs of a cluster sharing the x tile by TMA multicast, 24 KB instead
//      of 40 KB a k-tile from L2, measured 30-40% slower.)
//    - A from registers. wgmma's A fragment gives lane (g, t) k = 2t, 2t + 1
//      (a0: row g, a1: row g + 8) and 8 + 2t, 9 + 2t (a2, a3) of each k16
//      step, in canonical order, since B is read by descriptor in that
//      order. The stored layout stays [N, K]: a lane reads the 16 bytes of
//      a row's k16 step with one shared load, picks its two byte pairs with
//      one byte_perm and widens them. (Permuting K within each 16 at load
//      time would save 6 shared loads a thread per 64-deep k-tile, and
//      change every loader, the GGUF path and the tensor split.) The int8
//      tile is read by generic loads after its full barrier, so there is
//      no proxy fence: wgmma reads only x from shared memory, and only TMA
//      writes it. A k-tile's fragments are built into the second of two
//      register sets while the k-tile before runs; a set is rewritten only
//      after the wgmma group that read it has retired. (A group a k16 step,
//      with the widening of the next k-tile between them, made ptxas
//      serialize the products (C7520: a warpgroup arrive it inserts in a
//      divergent path) and ran 20-45% slower; keep branches out of the
//      issue sequence.) Taking the widening out entirely (conv_ab
//      --ablate) saves ~15%, taking out the TMA loads ~5%.
//    - Epilogue: the accumulator's rows are n, so a thread needs two scales
//      and two biases. The y^T tile is transposed through shared memory by
//      stmatrix .trans (128, then 112 m rows, a 144-byte row pitch: no bank
//      conflict) and stored as 16-byte runs along n of y.
// 2. Text rows (M <= kTextRows: 58 in every run). Bound by the weight's
//    bytes (116 flop a byte at M = 58, under the card's ~295), and N / 128
//    blocks fill only 20-96 of its 132 SMs. Split-K: `splits`
//    (seedvr2_w8a16_splitk_splits) is the fewest that give N / 128 x splits
//    >= kBlocksPerSM x the SM count (two blocks fit an SM; at one block an
//    SM the 7B proj_out weight streamed 1.5x slower). Each block streams the int8 bytes of its 128 weight rows over
//    its 1 / splits of K once and writes fp32 partials to a workspace
//    [splits, M, N]; a second kernel sums them in split order (no atomics:
//    the same bits on every run) and applies `finish`. The product stays on
//    mma.sync m16n8k16 (M pads to 64) on a 4-stage cp.async ring, 8 warps
//    of 32 x 32 outputs (deeper rings measured no faster). Its fragments
//    need no ldmatrix: the k order within a 16-step is free as long as A
//    and B agree, so logical k = 2t, 2t + 1, 8 + 2t, 9 + 2t of lane (g, t)
//    is mapped to physical k = 4t .. 4t + 3. A lane's B fragment (column n
//    = g) is then the 4 contiguous bytes w[n][4t .. 4t + 3] (one 32-bit
//    load, widened: b0 = k 4t, 4t + 1; b1 = k 4t + 2, 4t + 3), its A
//    fragment x[g][4t .. 4t + 3] and x[g + 8][4t .. 4t + 3] (two 64-bit
//    loads: a0, a2 from row g; a1, a3 from row g + 8). Row pitches of 160
//    (x) and 80 (w) bytes keep both free of bank conflicts.
#pragma once

#include "common.cuh"
#include "hopper.cuh"

namespace seedvr2 {
namespace w8a16 {

constexpr int kBK = 64;        // k depth of a pipeline stage, both regimes
constexpr int kTextRows = 64;  // the split-K regime takes M <= kTextRows

struct Args {
  const bf16* x;       // [M, K]
  const int8_t* w;     // [N, K]
  const float* scale;  // [N]
  const bf16* bias;    // [N] or nullptr
  bf16* y;             // [M, N]
  int M, N, K;
};

// Four int8 (k ascending from the low byte) as two bf16 pairs, exactly, without
// the int -> float converts (a quarter-rate unit): each byte v = q + 128 is
// placed in the mantissa of 2^23 (fp32 bits 0x4B0000vv = 2^23 + v), 2^23 + 128
// is subtracted (exact: q), and the upper halves of the fp32 results are the
// bf16 values (|q| <= 128 has at most 8 significant bits: the truncation is
// exact).
__device__ __forceinline__ void widen_s8x4(uint32_t q, uint32_t& lo, uint32_t& hi) {
  const uint32_t v = q ^ 0x80808080u;
  constexpr uint32_t kBase = 0x4B000000u;
  float f[4];
  uint32_t* u = reinterpret_cast<uint32_t*>(f);
  u[0] = __byte_perm(v, kBase, 0x7650);
  u[1] = __byte_perm(v, kBase, 0x7651);
  u[2] = __byte_perm(v, kBase, 0x7652);
  u[3] = __byte_perm(v, kBase, 0x7653);
#pragma unroll
  for (int i = 0; i < 4; ++i) f[i] -= 8388736.f;  // 2^23 + 128
  lo = __byte_perm(u[0], u[1], 0x7632);
  hi = __byte_perm(u[2], u[3], 0x7632);
}

// The epilogue of both regimes: the fp32 sums a0, a1 of output columns with
// scales s0, s1 and biases b0, b1 as one bf16 pair, rounded once.
__device__ __forceinline__ uint32_t finish(float a0, float a1, float s0, float s1, float b0, float b1) {
  return pack_bf16(a0 * s0 + b0, a1 * s1 + b1);
}

__device__ __forceinline__ float bias_at(const bf16* bias, int n) {
  return bias != nullptr ? __bfloat162float(bias[n]) : 0.f;
}

// --------------------------------------------------------------------------
// 1. video rows: TMA + wgmma, the weight as the register-fed A operand
// --------------------------------------------------------------------------
namespace video {

constexpr int kBN = 128;        // weight rows (output columns n) a tile
constexpr int kBM = 240;        // x rows a tile: wgmma's n
constexpr int kStages = 4;
constexpr int kConsumers = 2;   // consumer warpgroups, 64 weight rows each
constexpr int kThreads = 128 * (1 + kConsumers);
constexpr int kGroupM = 8;      // m-tiles a group of the tile walk
constexpr int kXBytes = kBM * kBK * 2;
constexpr int kWBytes = kBN * kBK;
constexpr int kAcc = kBM / 2;           // fp32 accumulators a consumer thread: kBM / 8 blocks of 4
constexpr int kEpiRows = 128;           // m rows of the first epilogue pass (kBM - kEpiRows the second)
constexpr int kEpiPitch = 64 + 8;       // bf16 a row of the transposed tile: 144 bytes
constexpr int kEpiBytes = kEpiRows * kEpiPitch * 2;
constexpr int kSmemBytes = kStages * (kXBytes + kWBytes) + kConsumers * kEpiBytes + 2 * kStages * 8 + 1024;
static_assert(kXBytes % 1024 == 0 && kWBytes % 1024 == 0, "stages stay 1024-byte aligned for the swizzle");
static_assert(kBM % 16 == 0 && kBM > kEpiRows && kBM <= 2 * kEpiRows, "two epilogue passes of 8-row block pairs");
static_assert(kSmemBytes <= 232448, "one block an SM");

struct Grid {
  int tiles_m, tiles_n, num_tiles;
};

// Tile i of the walk: groups of kGroupM m-tiles, m fastest within a group.
__device__ __forceinline__ void tile_at(const Grid& gr, int i, int& m0, int& n0) {
  const int per_group = kGroupM * gr.tiles_n;
  const int first = (i / per_group) * kGroupM;
  const int rows = min(kGroupM, gr.tiles_m - first);
  const int r = i % per_group;
  m0 = (first + r % rows) * kBM;
  n0 = (r / rows) * kBN;
}

// One k-tile's A fragments (4 k16 steps) of weight rows `row` and `row` + 8
// of the stage's int8 tile wt [kBN rows x 64 bytes]. `word` = t / 2 is the
// word of a 16-byte step that holds bytes 2t, 2t + 1 (2 + word holds 8 +
// 2t, 9 + 2t); `sel` picks their halves (t even: bytes 0, 1; odd: 2, 3).
__device__ __forceinline__ void load_a(uint32_t (&a)[4][4], const uint8_t* wt, int row, int word, uint32_t sel) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint4 u0 = *reinterpret_cast<const uint4*>(wt + row * kBK + 16 * kk);
    const uint4 u8 = *reinterpret_cast<const uint4*>(wt + (row + 8) * kBK + 16 * kk);
    uint32_t lo0, hi0, lo8, hi8;
    widen_s8x4(__byte_perm(word ? u0.y : u0.x, word ? u0.w : u0.z, sel), lo0, hi0);
    widen_s8x4(__byte_perm(word ? u8.y : u8.x, word ? u8.w : u8.z, sel), lo8, hi8);
    a[kk][0] = lo0;
    a[kk][1] = lo8;
    a[kk][2] = hi0;
    a[kk][3] = hi8;
  }
}

__device__ __forceinline__ void fence_fragments(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) sm90::fence_operand(a[kk][r]);
}

// The consumer's state across k-tiles: the ring position and the stage of
// the k-tile whose wgmma group is still in flight (-1: none).
struct Ring {
  int stage;
  uint32_t phase;
  int in_flight;
};

// Issue k-tile kt on `cur` (its stage is full, its fragments built), retire
// k-tile kt - 1 (release its stage; `next`, which it read, is free), then
// build `next` from k-tile kt + 1's stage.
__device__ __forceinline__ void k_step(float (&acc)[kAcc], uint32_t (&cur)[4][4], uint32_t (&next)[4][4], int kt,
                                       int KT, Ring& ring, const unsigned char* xs, const uint8_t* ws,
                                       uint64_t* full, uint64_t* empty, bool leader, int row, int word,
                                       uint32_t sel) {
  const uint32_t xa = smem_addr(xs + ring.stage * kXBytes);
  sm90::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    sm90::wgmma_m64n240k16_rs_bf16(acc, cur[kk], sm90::desc_sw128(xa + 32 * kk, 16, 1024), kt > 0 || kk > 0);
  sm90::wgmma_commit();
  sm90::wgmma_wait<1>();  // k-tile kt - 1 has retired
  fence_fragments(next);
  if (leader && ring.in_flight >= 0) sm90::mbar_arrive(empty + ring.in_flight);
  ring.in_flight = ring.stage;
  sm90::advance(ring.stage, ring.phase, kStages);
  if (kt + 1 < KT) {
    sm90::mbar_wait(full + ring.stage, ring.phase);
    load_a(next, ws + ring.stage * kWBytes, row, word, sel);
  }
}

// A consumer warpgroup's finished tile: finish() on its 64 n x kBM m
// accumulators, transposed through `tile` (kEpiRows x kEpiPitch bf16) in two
// passes (m rows 0-127, then 128 .. kBM - 1), stored to y as 16-byte runs
// along n.
__device__ __forceinline__ void epilogue(const Args& a, float (&acc)[kAcc], bf16* tile, int m0, int n0, int cw) {
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31, g = lane >> 2;
  const int nb = n0 + 64 * cw;  // this warpgroup's first output column
  if (nb >= a.N) return;        // the half-full last n-tile: its rows past N (uniform in the warpgroup)
  const int n = nb + 16 * warp + g;
  const float s0 = a.scale[n], s1 = a.scale[n + 8];
  const float b0 = bias_at(a.bias, n), b1 = bias_at(a.bias, n + 8);
  // lane 8i + r addresses row r of matrix i: block 2jj + i / 2 (8 m rows), n half i % 2
  const int mat = lane >> 3;
  bf16* dst = tile + (8 * (mat >> 1) + (lane & 7)) * kEpiPitch + 16 * warp + 8 * (mat & 1);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int rows = h == 0 ? kEpiRows : kBM - kEpiRows;  // m rows of this pass
    sm90::named_barrier_sync(1 + cw, 128);  // the last pass's reads of the tile are done
#pragma unroll
    for (int jj = 0; jj < rows / 16; ++jj) {
      const int j = kEpiRows / 8 * h + 2 * jj;  // accumulator blocks j, j + 1: m 8j .. 8j + 15
      sm90::stmatrix_x4_trans(dst + 16 * jj * kEpiPitch, finish(acc[4 * j], acc[4 * j + 1], s0, s0, b0, b0),
                              finish(acc[4 * j + 2], acc[4 * j + 3], s1, s1, b1, b1),
                              finish(acc[4 * j + 4], acc[4 * j + 5], s0, s0, b0, b0),
                              finish(acc[4 * j + 6], acc[4 * j + 7], s1, s1, b1, b1));
    }
    sm90::named_barrier_sync(1 + cw, 128);
#pragma unroll
    for (int k = 0; k < rows * 8 / 128; ++k) {  // 8 runs of 16 bytes a row
      const int c = tid + 128 * k, r = c >> 3, col = c & 7;
      const int m = m0 + kEpiRows * h + r;
      if (m < a.M)
        *reinterpret_cast<uint4*>(a.y + (size_t)m * a.N + nb + 8 * col) =
            *reinterpret_cast<const uint4*>(tile + r * kEpiPitch + 8 * col);
    }
  }
}

// tmx: x [M, K] bf16 (box [64 k, kBM rows], 128-byte swizzle); tmw: w [N, K]
// int8 (box [64 k, 128 rows], no swizzle). grid = min(num_tiles, SMs),
// kThreads threads, kSmemBytes of dynamic shared memory.
__global__ void __launch_bounds__(kThreads, 1)
    w8a16_video_kernel(const __grid_constant__ CUtensorMap tmx, const __grid_constant__ CUtensorMap tmw, const Args a,
                       const Grid gr) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* xs = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* ws = xs + kStages * kXBytes;
  bf16* epi = reinterpret_cast<bf16*>(ws + kStages * kWBytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(reinterpret_cast<unsigned char*>(epi) + kConsumers * kEpiBytes);
  uint64_t* empty = full + kStages;
  const int KT = a.K / kBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(full + s, 1);
      sm90::mbar_init(empty + s, kConsumers);
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer: one thread keeps the ring full ----
    sm90::setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      sm90::tma_prefetch(&tmx);
      sm90::tma_prefetch(&tmw);
      int s = 0;
      uint32_t ph = 0;
      for (int i = blockIdx.x; i < gr.num_tiles; i += gridDim.x) {
        int m0, n0;
        tile_at(gr, i, m0, n0);
        for (int kt = 0; kt < KT; ++kt) {
          sm90::mbar_wait(empty + s, ph ^ 1);
          sm90::mbar_arrive_expect_tx(full + s, kXBytes + kWBytes);
          sm90::tma_load_2d(xs + s * kXBytes, &tmx, full + s, kt * kBK, m0);
          sm90::tma_load_2d(ws + s * kWBytes, &tmw, full + s, kt * kBK, n0);
          sm90::advance(s, ph, kStages);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup cw owns weight rows 64 cw .. 64 cw + 63 of each tile ----
    sm90::setmaxnreg_inc<232>();
    const int cw = wg - 1;
    const int lane = threadIdx.x & 31, t = lane & 3;
    const int row = 64 * cw + 16 * ((threadIdx.x & 127) >> 5) + (lane >> 2);
    const int word = t >> 1;
    const uint32_t sel = (t & 1) ? 0x7632u : 0x5410u;
    const bool leader = (threadIdx.x & 127) == 0;
    bf16* tile = epi + cw * (kEpiBytes / 2);
    float acc[kAcc];
    uint32_t f0[4][4], f1[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) f0[kk][r] = f1[kk][r] = 0u;
    Ring ring{0, 0, -1};
    for (int i = blockIdx.x; i < gr.num_tiles; i += gridDim.x) {
      int m0, n0;
      tile_at(gr, i, m0, n0);
      sm90::mbar_wait(full + ring.stage, ring.phase);
      load_a(f0, ws + ring.stage * kWBytes, row, word, sel);
      for (int kt = 0; kt < KT; kt += 2) {
        k_step(acc, f0, f1, kt, KT, ring, xs, ws, full, empty, leader, row, word, sel);
        if (kt + 1 < KT) k_step(acc, f1, f0, kt + 1, KT, ring, xs, ws, full, empty, leader, row, word, sel);
      }
      sm90::wgmma_wait<0>();
      fence_fragments(f0);
      fence_fragments(f1);
#pragma unroll
      for (int e = 0; e < kAcc; ++e) sm90::fence_operand(acc[e]);
      if (leader) sm90::mbar_arrive(empty + ring.in_flight);
      ring.in_flight = -1;
      epilogue(a, acc, tile, m0, n0, cw);
    }
  }
}

}  // namespace video

// --------------------------------------------------------------------------
// 2. text rows: split-K on mma.sync, then a fixed-order reduce
// --------------------------------------------------------------------------
namespace text {

constexpr int kBM = kTextRows, kBN = 128;
constexpr int kStages = 4;
constexpr int kThreads = 256;            // 8 warps: 2 along M x 4 along N
constexpr int kBlocksPerSM = 2;          // the occupancy the split count aims at
constexpr int kWM = 32, kWN = 32;        // one warp's outputs
constexpr int kMF = kWM / 16, kNF = kWN / 8;
constexpr int kXPitch = kBK + 16;        // bf16 elements per x row in shared memory (160 bytes)
constexpr int kWPitch = kBK + 16;        // bytes per w row (80)
constexpr int kXStage = kBM * kXPitch;   // bf16 elements
constexpr int kWStage = kBN * kWPitch;   // bytes
constexpr int kXBytes = kStages * kXStage * 2;
constexpr int kSmemBytes = kXBytes + kStages * kWStage;
constexpr int kReduceThreads = 256;

// One k-tile of x (rows past M zero-filled) and of w (rows past N
// zero-filled: the last n-tile of an N that is a multiple of 64 only).
__device__ __forceinline__ void load_tile(const Args& a, bf16* xs, uint8_t* ws, int n0, int k0, int tid) {
#pragma unroll
  for (int i = 0; i < kBM * kBK / 8 / kThreads; ++i) {  // 16-byte chunks of x: 8 a row
    const int c = tid + i * kThreads;
    const int row = c / (kBK / 8), col = (c % (kBK / 8)) * 8;
    const bool ok = row < a.M;
    cp_async16(xs + row * kXPitch + col, a.x + (ok ? (size_t)row * a.K + k0 + col : 0), ok);
  }
#pragma unroll
  for (int i = 0; i < kBN * kBK / 16 / kThreads; ++i) {  // 16-byte chunks of w: 4 a row
    const int c = tid + i * kThreads;
    const int row = c / (kBK / 16), col = (c % (kBK / 16)) * 16;
    const bool ok = n0 + row < a.N;
    cp_async16(ws + row * kWPitch + col, a.w + (ok ? (size_t)(n0 + row) * a.K + k0 + col : 0), ok);
  }
}

// Block (n-tile blockIdx.x, split blockIdx.y): the fp32 partial product of
// its 128 columns over k-tiles [split KT / splits, (split + 1) KT / splits)
// into part[split][M][N].
__global__ void __launch_bounds__(kThreads, kBlocksPerSM) w8a16_splitk_kernel(const Args a, float* part, int splits) {
  extern __shared__ __align__(16) uint8_t smem[];
  bf16* xs0 = reinterpret_cast<bf16*>(smem);
  uint8_t* ws0 = smem + kXBytes;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp / (kBN / kWN), wn = warp % (kBN / kWN);
  const int n0 = blockIdx.x * kBN, split = blockIdx.y;
  const int KT = a.K / kBK;
  const int kt0 = (int)((long)split * KT / splits);
  const int nk = (int)((long)(split + 1) * KT / splits) - kt0;

  float acc[kMF][kNF][4];
#pragma unroll
  for (int i = 0; i < kMF; ++i)
#pragma unroll
    for (int j = 0; j < kNF; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load_tile(a, xs0 + s * kXStage, ws0 + s * kWStage, n0, (kt0 + s) * kBK, tid);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStages - 2>();  // this thread's copies of tile kt have landed
    __syncthreads();               // everyone's have, and stage (kt - 1) % kStages is free
    const int next = kt + kStages - 1;
    if (next < nk)
      load_tile(a, xs0 + (next % kStages) * kXStage, ws0 + (next % kStages) * kWStage, n0, (kt0 + next) * kBK, tid);
    cp_async_commit();
    const bf16* xs = xs0 + (kt % kStages) * kXStage;
    const uint8_t* ws = ws0 + (kt % kStages) * kWStage;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t b[kNF][2];
#pragma unroll
      for (int j = 0; j < kNF; ++j) {
        const int n = wn * kWN + j * 8 + g;
        widen_s8x4(*reinterpret_cast<const uint32_t*>(ws + n * kWPitch + kk + 4 * t), b[j][0], b[j][1]);
      }
#pragma unroll
      for (int i = 0; i < kMF; ++i) {
        const int m = wm * kWM + i * 16 + g;
        const uint2 r0 = *reinterpret_cast<const uint2*>(xs + m * kXPitch + kk + 4 * t);
        const uint2 r8 = *reinterpret_cast<const uint2*>(xs + (m + 8) * kXPitch + kk + 4 * t);
        const uint32_t af[4] = {r0.x, r8.x, r0.y, r8.y};
#pragma unroll
        for (int j = 0; j < kNF; ++j) mma_bf16(acc[i][j], af, b[j][0], b[j][1]);
      }
    }
  }
  cp_async_wait_all();

  // lane (g, t) holds rows g, g + 8 and columns 2t, 2t + 1 of each 16 x 8 fragment
  if (n0 + wn * kWN >= a.N) return;  // this warp's columns lie past N (N % 64 == 0: all or none of them)
  float* out = part + (size_t)split * a.M * a.N;
#pragma unroll
  for (int j = 0; j < kNF; ++j) {
    const int n = n0 + wn * kWN + j * 8 + 2 * t;
#pragma unroll
    for (int i = 0; i < kMF; ++i) {
      const int m = wm * kWM + i * 16 + g;
      if (m < a.M) *reinterpret_cast<float2*>(out + (size_t)m * a.N + n) = make_float2(acc[i][j][0], acc[i][j][1]);
      if (m + 8 < a.M)
        *reinterpret_cast<float2*>(out + (size_t)(m + 8) * a.N + n) = make_float2(acc[i][j][2], acc[i][j][3]);
    }
  }
}

// y[m, n .. n + 3] = finish(sum over splits in order of part[s][m][n .. n + 3]),
// one thread per 4 outputs.
__global__ void __launch_bounds__(kReduceThreads) w8a16_splitk_reduce_kernel(const Args a, const float* part,
                                                                             int splits) {
  const int q = a.N / 4;
  const long i = (long)blockIdx.x * kReduceThreads + threadIdx.x;
  if (i >= (long)a.M * q) return;
  const long m = i / q;
  const int n = (int)(i % q) * 4;
  float4 s = *reinterpret_cast<const float4*>(part + m * a.N + n);
  for (int p = 1; p < splits; ++p) {
    const float4 v = *reinterpret_cast<const float4*>(part + ((long)p * a.M + m) * a.N + n);
    s.x += v.x;
    s.y += v.y;
    s.z += v.z;
    s.w += v.w;
  }
  const float4 sc = *reinterpret_cast<const float4*>(a.scale + n);
  uint2 o;
  o.x = finish(s.x, s.y, sc.x, sc.y, bias_at(a.bias, n), bias_at(a.bias, n + 1));
  o.y = finish(s.z, s.w, sc.z, sc.w, bias_at(a.bias, n + 2), bias_at(a.bias, n + 3));
  *reinterpret_cast<uint2*>(a.y + m * a.N + n) = o;
}

}  // namespace text

}  // namespace w8a16
}  // namespace seedvr2

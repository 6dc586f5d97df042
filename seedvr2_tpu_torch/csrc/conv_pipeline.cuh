// The convolution pipeline of the VAE on Hopper: K1 / K4 / K6 (conv3d.cuh)
// and K2 (fold_upsample.cuh) are one kernel template, conv_kernel<Policy>,
// on the primitives of hopper.cuh. A policy says which output tile a tile
// index is, where the tile's input slab and weight rows lie, which spatial
// taps read the slab at which shift, and how a finished tile is stored;
// this file holds everything they share.
//
// What bounds them on the H100: tensor-core work (2 * taps * Cin FLOPs per
// output value against ~4 bytes of device-memory traffic, far above the
// ~295 FLOP/byte ridge). What holds a kernel below the bf16 peak is how the
// tensor cores are fed: mma.sync from registers tops out near half of it
// (the register-resident conv core these kernels had before), and the
// implicit column matrix is never materialised, so its panels come from L2,
// whose bandwidth into shared memory is the next limit. The design is
// Hopper's GEMM pipeline:
// - Tile. A block owns M = 256 output pixels, a ph x pw patch of one frame
//   (16 x 16, 8 x 32 or 4 x 64: pick_patch takes the one with the fewest
//   tiles), x N = 128 output columns.
// - Operands by TMA, K in stages of 64 channels. A: once per (temporal
//   tap, 64-channel chunk), one TMA box [64 ch, pw + 8, ph + kHalo, 1, 1]
//   of the 5-D NDHWC input at the policy's slab origin: the patch's halo'd
//   slab, pixel rows of 128 bytes, 128-byte swizzled (K-major, the layout
//   wgmma reads). Coordinates off the image come back as zeros: that is the
//   SAME padding and the ragged patch, with no predicate in the kernel. The
//   policy's kTaps spatial taps read the one slab through descriptors that
//   start (dy, dx) pixels further in, so the input goes from L2 into shared
//   memory once per kTaps taps, not kTaps times (a box per tap made the
//   first K6 L2-bound). The slab is pw + 8 pixels wide, not pw + 2, so that a
//   row of 8-pixel core matrices is a multiple of 1024 bytes and every core
//   matrix of a descriptor sits at the same phase (dx) of the swizzle atom.
//   B: per tap, two boxes [64 cols, 64 k rows] of the flat weight [rows,
//   cols] (N-major), which wgmma reads transposed (tnspB); no copy of the
//   weight is made.
// - Pipeline. Two rings with a full and an empty mbarrier per stage: slab
//   stages (54 KB) and weight stages (16 KB), 2 and 6 (K1 / K6, K2) or 3
//   and 3 (K4; Rings). Warpgroup 0 is the producer: one thread arms a full
//   barrier with the bytes a stage will receive (zero-filled ones
//   included) and issues its TMA loads, the taps' weights and, after tap
//   kSlabAt's, the next stage's slab; it keeps both rings full across
//   tiles, so the next tile's loads overlap this tile's epilogue (the grid
//   is persistent: one block an SM walks tiles blockIdx.x, + gridDim.x, ...).
// - A pass on the landed slab (policies with kTransform: K4). TMA cannot
//   transform data, so warps 1-3 of the producer warpgroup, idle
//   otherwise, wait for each slab's full barrier, rewrite its in-image
//   elements in place (the policy's transform), make their generic-proxy
//   writes visible to wgmma's async proxy (fence.proxy.async.shared::cta)
//   and arrive on the slab's ready barrier, which is what the consumers
//   wait for instead of the full one. With 3 slab stages the producer
//   loads slab s + 1 while the consumers multiply slab s - 1, so the pass
//   on it runs while they multiply slab s.
// - Products. Warpgroups 1 and 2 each own two 64-row operands of the tile
//   (8 core matrices of 8 pixels at one stride in the slab): per tap 8
//   wgmma.m64n128k16 (2 operands x 4 k16 steps). Each tap's group is
//   committed and the group before it waited for (wait_group 1), so one
//   group is always queued behind the running one; only then are the
//   earlier weight stage, and after a slab's last tap the slab, released
//   (one arrival per warpgroup). setmaxnreg gives the consumers 232
//   registers (128 accumulators a thread) and the producer warpgroup 40;
//   with the pass, 216 and 72.
// - Epilogue from registers: the policy's fp32 bias is added, each pair
//   rounded to bf16, a 4 x 4 transpose inside each lane quad turns four
//   4-byte pairs into one 16-byte run of 8 columns, stored where the policy
//   says; pixels past the frame are masked. No fp32 tile goes through
//   shared memory.
//
// A policy P provides: kTaps, kHalo, kTransform, its ring depths
// (kSlabStages, kWStages); a Geometry g (filled by its entry); Tile
// tile(i); temporal_taps(); slab(tile, kt, ch, c[5]) (the
// 5-D box origin); weight_col(tile); weight_row(tile, kt, tap) (of channel
// 0 of the chunk); tap_offset(tap) (dy, dx of the tap in the slab); float2
// col_bias(tile, col) (the columns col, col + 1 of the tile); bf16* out(tile,
// h, w) (column 0 of the tile at output pixel (h, w) of the patch's frame);
// uint32_t edge(tile, h, w) and fix_bias(tile, edge, col, float2) (a per-pixel
// bias correction, K2's masked bias table); column_ok(tile, col) (a
// 32-column block inside the output); with kTransform, transform(tile, kt,
// ch, slab, thread), run by kPassThreads threads.
#pragma once

#include "common.cuh"
#include "hopper.cuh"

namespace seedvr2 {
namespace conv {

constexpr int kBM = 256;         // output pixels per tile (ph * pw)
constexpr int kBN = 128;         // output columns per tile
constexpr int kBK = 64;          // K depth of a stage: 64 channels of one tap
constexpr int kConsumers = 2;    // consumer warpgroups, two 64-row operands each
constexpr int kThreads = 128 * (1 + kConsumers);
constexpr int kPassThreads = 96;  // warps 1-3 of the producer warpgroup run K4's pass (kTransform)
constexpr int kSlabRows = 432;   // the largest slab, (ph + kHalo) * (pw + 8) pixels: 18 x 24 or 6 x 72
constexpr int kSlabBytes = kSlabRows * 128;
constexpr int kWHalfBytes = kBK * 64 * 2;    // 64 k rows of 64 columns
constexpr int kWBytes = 2 * kWHalfBytes;
static_assert(kSlabBytes % 1024 == 0 && kWBytes % 1024 == 0, "stages stay 1024-byte aligned for the swizzle");

// The two rings of a policy, from its kSlabStages and kWStages. The
// producer loads the next slab after tap kSlabAt's weights: with 2 slab
// stages, after tap 6 (by then the consumers have released the stage it goes
// into, at tap 0) or the last; with 3, at once, a whole stage ahead.
template <class P>
struct Rings {
  static constexpr int kSlabStages = P::kSlabStages, kWStages = P::kWStages;
  static constexpr int kSlabAt = kSlabStages > 2 ? 0 : (P::kTaps - 1 < 6 ? P::kTaps - 1 : 6);
  static constexpr int kBarrierBytes = (3 * kSlabStages + 2 * kWStages) * 8;
  static constexpr int kSmemBytes = kSlabStages * kSlabBytes + kWStages * kWBytes + kBarrierBytes + 1024;  // + alignment slack
  static_assert(kSmemBytes <= 232448, "the 227 KB a block may have");
};

// What every policy's entry fills in: the input frame, its channels, the
// patch and the tile count.
struct Geometry {
  int H, W, cin;      // input frame rows, columns; channels (a multiple of kBK)
  int ph, pw;         // patch, ph * pw == kBM
  int tiles_h, tiles_w, num_tiles;
};

// 64-row operand m (0..3) of a tile: core matrix j (rows 8j .. 8j+7) is the
// 8 pixels (py0 + j dy, px0 + j dx + 0..7) of the patch. With ph >= 8 an
// operand is 8 patch rows of one 8-pixel column group; at 4 x 64 it is one
// patch row.
struct Operand {
  int py0, px0, dy, dx;
};

__device__ __forceinline__ Operand operand(const Geometry& g, int m) {
  if (g.ph < 8) return Operand{m, 0, 0, 8};
  const int groups = g.pw / 8;
  return Operand{8 * (m / groups), 8 * (m % groups), 1, 0};
}

// One consumer warpgroup's operands of a finished tile: + bias, bf16, stored.
// Lane (g, q) = (lane / 4, lane % 4) holds columns 8j + 2q, +1 of rows g and
// g + 8 of each 16-row warp slice, i.e. pixel g of core matrices 2 warp and
// 2 warp + 1; four 8-column blocks at a time, the quad swaps pairs so that
// lane q ends with all 8 columns of block 4 j4 + q.
template <class P>
__device__ __forceinline__ void epilogue(const P& p, const typename P::Tile& c, float (&acc)[2][64],
                                         const Operand (&op)[2]) {
  const int tid = threadIdx.x & 127;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, q = lane & 3;
  float2 bias[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) bias[j] = p.col_bias(c, 8 * j + 2 * q);
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int rh = 0; rh < 2; ++rh) {
      const int j = 2 * warp + rh;
      const int h = c.h0 + op[mi].py0 + j * op[mi].dy, w = c.w0 + op[mi].px0 + j * op[mi].dx + g;
      const bool ok = h < p.g.H && w < p.g.W;
      const uint32_t edge = ok ? p.edge(c, h, w) : 0u;
      bf16* dst = p.out(c, h, w) + 8 * q;
#pragma unroll
      for (int j4 = 0; j4 < 4; ++j4) {
        uint32_t v[4];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int n = 4 * j4 + jj;
          float2 bb = bias[n];
          if (edge) bb = p.fix_bias(c, edge, 8 * n + 2 * q, bb);
          v[jj] = pack_bf16(acc[mi][4 * n + 2 * rh] + bb.x, acc[mi][4 * n + 2 * rh + 1] + bb.y);
        }
        const uint4 out = quad_transpose(v, q);
        if (ok && p.column_ok(c, 32 * j4)) *reinterpret_cast<uint4*>(dst + 32 * j4) = out;
      }
    }
  }
}

// tmx: the NDHWC input as a 5-D map (box [64, pw + 8, ph + P::kHalo, 1, 1],
// 128-byte swizzle, zero fill); tmw: the flat weight as a 2-D map (box [64,
// 64], 128-byte swizzle). grid = min(num_tiles, SMs), kThreads threads,
// Rings<P>::kSmemBytes of dynamic shared memory.
template <class P>
__global__ void __launch_bounds__(kThreads, 1)
    conv_kernel(const __grid_constant__ CUtensorMap tmx, const __grid_constant__ CUtensorMap tmw, const P p) {
  constexpr int kSlabStages = Rings<P>::kSlabStages, kWStages = Rings<P>::kWStages, kSlabAt = Rings<P>::kSlabAt;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* slab = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* wt = slab + kSlabStages * kSlabBytes;
  uint64_t* slab_full = reinterpret_cast<uint64_t*>(wt + kWStages * kWBytes);
  uint64_t* slab_empty = slab_full + kSlabStages;
  uint64_t* slab_ready = slab_empty + kSlabStages;  // the pass is done (kTransform)
  uint64_t* w_full = slab_ready + kSlabStages;
  uint64_t* w_empty = w_full + kWStages;
  const int chunks = p.g.cin / kBK;
  const int sw = p.g.pw + 8;  // slab width, pixels
  const int stages = p.temporal_taps() * chunks;
  // K4's pass runs in the producer warpgroup: 72 registers there (two
  // pixels' chains unspilled), 216 for the consumers
  constexpr int kProducerRegs = P::kTransform ? 72 : 40, kConsumerRegs = P::kTransform ? 216 : 232;
  static_assert(128 * kProducerRegs + 128 * kConsumers * kConsumerRegs <= kThreads * 168, "the launch bound's pool");

  if (threadIdx.x == 0) {
    for (int s = 0; s < kSlabStages; ++s) {
      sm90::mbar_init(slab_full + s, 1);
      sm90::mbar_init(slab_empty + s, kConsumers);
      sm90::mbar_init(slab_ready + s, kPassThreads);
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
    sm90::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      // ---- producer: one thread keeps both rings full ----
      sm90::tma_prefetch(&tmx);
      sm90::tma_prefetch(&tmw);
      const uint32_t slab_bytes = 128u * sw * (p.g.ph + P::kHalo);
      int ss = 0, ws = 0;
      uint32_t sph = 0, wph = 0;
      auto load_slab = [&](const typename P::Tile& c, int kc) {
        int o[5];
        p.slab(c, kc / chunks, kc % chunks, o);
        sm90::mbar_wait(slab_empty + ss, sph ^ 1);
        sm90::mbar_arrive_expect_tx(slab_full + ss, slab_bytes);
        sm90::tma_load_5d(slab + ss * kSlabBytes, &tmx, slab_full + ss, o[0], o[1], o[2], o[3], o[4]);
        sm90::advance(ss, sph, kSlabStages);
      };
      load_slab(p.tile(blockIdx.x), 0);
      for (int i = blockIdx.x; i < p.g.num_tiles; i += gridDim.x) {
        const typename P::Tile c = p.tile(i);
        const int col = p.weight_col(c);
        for (int kc = 0; kc < stages; ++kc) {
          const int kt = kc / chunks, ch = kc % chunks;
          for (int tap = 0; tap < P::kTaps; ++tap) {
            const int krow = p.weight_row(c, kt, tap) + ch * kBK;
            sm90::mbar_wait(w_empty + ws, wph ^ 1);
            sm90::mbar_arrive_expect_tx(w_full + ws, kWBytes);
            sm90::tma_load_2d(wt + ws * kWBytes, &tmw, w_full + ws, col, krow);
            sm90::tma_load_2d(wt + ws * kWBytes + kWHalfBytes, &tmw, w_full + ws, col + 64, krow);
            sm90::advance(ws, wph, kWStages);
            if (tap == kSlabAt) {  // the next stage's slab: this tile's next, or the next tile's first
              if (kc + 1 < stages)
                load_slab(c, kc + 1);
              else if (i + (int)gridDim.x < p.g.num_tiles)
                load_slab(p.tile(i + gridDim.x), 0);
            }
          }
        }
      }
    } else if (threadIdx.x >= 128 - kPassThreads) {
      if constexpr (P::kTransform) {
        // ---- the pass: each landed slab rewritten in place, then released to the consumers ----
        const int pt = threadIdx.x - (128 - kPassThreads);
        int ss = 0;
        uint32_t sph = 0;
        for (int i = blockIdx.x; i < p.g.num_tiles; i += gridDim.x) {
          const typename P::Tile c = p.tile(i);
          for (int kc = 0; kc < stages; ++kc) {
            sm90::mbar_wait(slab_full + ss, sph);
            p.transform(c, kc / chunks, kc % chunks, slab + ss * kSlabBytes, pt);
            sm90::fence_proxy_async();  // this thread's writes, visible to wgmma
            sm90::mbar_arrive(slab_ready + ss);
            sm90::advance(ss, sph, kSlabStages);
          }
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg - 1 owns operands 2 (wg - 1) and 2 (wg - 1) + 1 ----
    sm90::setmaxnreg_inc<kConsumerRegs>();
    const bool leader = (threadIdx.x & 127) == 0;
    const Operand op[2] = {operand(p.g, 2 * (wg - 1)), operand(p.g, 2 * (wg - 1) + 1)};
    uint64_t* landed = P::kTransform ? slab_ready : slab_full;
    int row0[2];   // slab row of core matrix 0 at shift (0, 0)
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
    for (int i = blockIdx.x; i < p.g.num_tiles; i += gridDim.x) {
      const typename P::Tile c = p.tile(i);
      bool first = true;
      for (int kc = 0; kc < stages; ++kc) {
        sm90::mbar_wait(landed + ss, sph);
        const uint32_t sa = smem_addr(slab + ss * kSlabBytes);
        for (int tap = 0; tap < P::kTaps; ++tap) {
          const int2 d = P::tap_offset(tap);
          const int shift = d.x * sw + d.y;  // (dy, dx) in slab rows
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
          prev_s = tap == P::kTaps - 1 ? ss : -1;
          sm90::advance(ws, wph, kWStages);
        }
        sm90::advance(ss, sph, kSlabStages);
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
      epilogue(p, c, acc, op);
    }
  }
}

// ---- host side ----

constexpr int kEncodeError = 1 << 20;  // + CUresult of a failed cuTensorMapEncodeTiled
constexpr int kMaxDevices = 64;

// The patch (ph, pw), ph * pw == kBM, with the fewest tiles over H x W;
// ties go to the first, the squarest (the smallest slab).
inline void pick_patch(int H, int W, int* ph, int* pw) {
  static const int kPatches[3][2] = {{16, 16}, {8, 32}, {4, 64}};
  long best = -1;
  for (const auto& p : kPatches) {
    const long n = (long)((H + p[0] - 1) / p[0]) * ((W + p[1] - 1) / p[1]);
    if (best < 0 || n < best) {
      best = n;
      *ph = p[0];
      *pw = p[1];
    }
  }
}

// The geometry of a conv over frames H x W of cin channels with `per_patch`
// tiles for each patch of each of `frames` output frames (0 and err set
// when the tile count does not fit an int).
inline Geometry geometry(int H, int W, int cin, long frames, long per_patch, int* err) {
  Geometry g{H, W, cin, 0, 0, 0, 0, 0};
  pick_patch(H, W, &g.ph, &g.pw);
  g.tiles_h = (H + g.ph - 1) / g.ph;
  g.tiles_w = (W + g.pw - 1) / g.pw;
  const long tiles = frames * g.tiles_h * g.tiles_w * per_patch;
  *err = tiles > 0x7fffffff ? (int)cudaErrorInvalidValue : 0;
  g.num_tiles = (int)(tiles > 0x7fffffff ? 0 : tiles);
  return g;
}

// The launch helpers have internal linkage: a static local of a function
// template with external linkage is one object in the whole process (a
// unique symbol), so two libraries of these kernels loaded side by side
// (conv_ab builds other trees) would share the opt-in flags below.
namespace {

// Encodes the two maps and launches conv_kernel<P> on `stream`: x [B,
// frames, H, W, cin] and the weight [wrows, wcols], bf16, 16-byte aligned.
// Returns 0, a cudaError_t, or kEncodeError + a CUresult.
template <class P>
int launch(const P& p, const void* x, int B, int frames, const void* w, long wrows, long wcols, cudaStream_t stream) {
  cudaError_t err = cudaSuccess;
  const auto encode = sm90::tensor_map_encoder(&err);
  if (encode == nullptr) return (int)err;
  const Geometry& g = p.g;
  const cuuint64_t e = 2;  // bytes of a bf16
  CUtensorMap tmx, tmw;
  const cuuint64_t xdim[5] = {(cuuint64_t)g.cin, (cuuint64_t)g.W, (cuuint64_t)g.H, (cuuint64_t)frames, (cuuint64_t)B};
  const cuuint64_t xstride[4] = {g.cin * e, (cuuint64_t)g.W * g.cin * e, (cuuint64_t)g.H * g.W * g.cin * e,
                                 (cuuint64_t)frames * g.H * g.W * g.cin * e};
  const cuuint32_t xbox[5] = {(cuuint32_t)kBK, (cuuint32_t)g.pw + 8, (cuuint32_t)(g.ph + P::kHalo), 1, 1};  // the slab
  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  CUresult r = encode(&tmx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, const_cast<void*>(x), xdim, xstride, xbox, ones,
                      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);  // NONE fills zeros (NAN_REQUEST_ZERO_FMA gives NaN)
  if (r != CUDA_SUCCESS) return kEncodeError + (int)r;
  const cuuint64_t wdim[2] = {(cuuint64_t)wcols, (cuuint64_t)wrows};
  const cuuint64_t wstride[1] = {wcols * e};
  const cuuint32_t wbox[2] = {64, (cuuint32_t)kBK};
  r = encode(&tmw, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(w), wdim, wstride, wbox, ones,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return kEncodeError + (int)r;

  // once per device and kernel: the shared-memory opt-in above 48 KB; the SM count
  static bool opted[kMaxDevices] = {false};
  static int sms[kMaxDevices] = {0};
  int dev = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!opted[dev]) {
    err = cudaFuncSetAttribute(conv_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize, Rings<P>::kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    int n = 0;
    if ((err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return (int)err;
    sms[dev] = n;
    opted[dev] = true;
  }
  const int grid = g.num_tiles < sms[dev] ? g.num_tiles : sms[dev];
  constexpr int smem = Rings<P>::kSmemBytes;
  conv_kernel<P><<<grid, kThreads, smem, stream>>>(tmx, tmw, p);
  return (int)cudaGetLastError();
}

// What the runtime holds for conv_kernel<P>: registers a thread, local
// memory (spills) a thread, and the dynamic shared memory it launches with.
template <class P>
int attributes(int* regs, int* local_bytes, int* smem_bytes) {
  cudaFuncAttributes f;
  const cudaError_t err = cudaFuncGetAttributes(&f, conv_kernel<P>);
  if (err != cudaSuccess) return (int)err;
  *regs = f.numRegs;
  *local_bytes = (int)f.localSizeBytes;
  *smem_bytes = Rings<P>::kSmemBytes;
  return 0;
}

}  // namespace

}  // namespace conv
}  // namespace seedvr2

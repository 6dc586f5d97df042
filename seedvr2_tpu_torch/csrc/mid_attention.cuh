// K10: the VAE's mid attention, softmax(Q K^T / sqrt(C)) V over all n
// pixels of a frame, one head of width C, for every frame of [F, n, C] bf16
// in one launch, without writing the n x n logits anywhere.
//
// Replaces no TPU kernel: the JAX package leaves _mid_attention
// (seedvr2_tpu/models/vae/model.py:168) to XLA's einsums: bf16 q and k with
// fp32 logits (preferred_element_type), an fp32 softmax, the probabilities
// cast to bf16 before P V. The same math here: bf16 wgmma with fp32
// accumulators (a product of two bf16 values is exact in fp32, as in the
// einsum), an online fp32 softmax in the log2 domain, P rounded to bf16 as
// P V's A operand, 1 / denominator in the epilogue. n is any positive
// integer: keys past n (zeros from TMA) are -inf in the last key tile, out
// of the max and the denominator, which counts exactly n keys.
//
// What bounds it on the H100: 4 n^2 C operations a frame on 8 n C bytes of
// q, k, v and o (~n / 2 operations a byte; n = 32,400 at 1080p), so the
// tensor cores' 989 TFLOP/s. K5's loop (attention_pipeline.cuh) does not
// fit C = 512: one warp group's 64 x 512 fp32 O takes 256 registers a
// thread (255 is the most), and its two 64-row query tiles plus one stage
// of K and V are 256 KB of the 227 KB a block may have.
//
// Design:
// - Block: a producer warp group (setmaxnreg down to 40; warp 0's lane 0
//   issues Q and the K ring, warp 1's lane 0 the V ring, so neither ring
//   waits behind the other) and two consumer warp groups (232 registers)
//   that share one 64-row query tile. Consumer g owns output columns
//   [g C / 2, (g + 1) C / 2): 128 fp32 registers a thread at C = 512.
// - S = Q K^T: consumer g multiplies its half of Q's columns by the same
//   half of K's (wgmma m64n32k16, both operands K-major in shared memory),
//   the two 64 x kBN fp32 partials are exchanged through shared memory
//   behind one named barrier (two buffers, a tile's parity picks one), and
//   each consumer adds them (a + b == b + a: both hold the same bits), so
//   Q K^T is done once, not twice.
// - Both consumers run the same online softmax on the same S and get the
//   same P; P V runs as wgmma m64n(C/2)k16 with P re-packed from the score
//   registers as bf16 A fragments and V MN-major (tnspB = 1).
// - Overlap inside a consumer: the Q K^T of tile j is issued, then the P V
//   of tile j - 1; the exchange and the softmax of tile j run while that
//   P V does, and O is rescaled once it has retired (skipped in a row whose
//   max did not move: a factor of exactly 1).
// - Rings: Q (one full / empty pair, released after the item's last Q K^T,
//   so the next item's Q lands under the last P V and the epilogue), and
//   K and V rings of two stages with their own barriers, so K of tile
//   j + 1 lands while V of tile j is still read. Each lands by TMA from a
//   3-D map (C, n, F) in the 128-byte swizzle as C / 64 boxes of 64
//   columns; rows past n of a frame land as zeros.
// - The grid is persistent over (frame, 64-row query tile) items, frame
//   major, so the blocks in flight read the same frame's K and V from L2.
// - Epilogue from registers: 1 / denominator, bf16, the quad transpose of
//   attention_pipeline.cuh so that every lane stores 16 contiguous bytes.
// No atomics: every output row is written once, by one thread, in a fixed
// order of operations, so two launches give the same bits.
//
// What holds it (H100 80GB HBM3 at 700 W, 2 x 32,400 pixels at C = 512:
// 9.42 ms, 46% of the bound; each part taken out of a copy, PERF.md §6): with
// the Q K^T products taken out 7.25 ms, the exchange 8.13, the P V
// products 8.66, the K and V reloads 9.11. Not L2 and not the tensor
// cores: the consumers' own instruction stream a 32-key tile (the 16
// wgmma issues of Q K^T, the exchange and its barrier, the softmax that
// both warp groups run in lockstep on the same scores) sets the pace.
#pragma once

#include <math.h>

#include "common.cuh"
#include "hopper.cuh"

namespace seedvr2 {
namespace midattn {

constexpr int kBM = 64;           // query rows an item
constexpr int kConsumers = 2;
constexpr int kThreads = 128 * (1 + kConsumers);
constexpr int kBarFull = 1;       // the two consumer warp groups' named barrier (0 is __syncthreads')
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kEncodeError = 1 << 20;  // + CUresult of a failed cuTensorMapEncodeTiled
constexpr int kMaxDevices = 64;

constexpr int kStages = 2;        // of K and of V

// Keys a tile, at both widths: at C = 512 two stages of 32-key K and V tiles
// fit beside Q (64 KB); one stage of 64 keys took 10.67 ms against 9.54 at
// 1080p (2 x 32,400 pixels, H100 80GB HBM3, 700 W).
constexpr int kBN = 32;

// Shared memory of a block at head width kC: Q, the K ring, the V ring, the
// exchanged partial scores, the barriers.
template <int kC>
struct Geometry {
  static constexpr int kBoxes = kC / 64;          // 64-column boxes of a row
  static constexpr int kHalfBoxes = kBoxes / 2;   // a consumer's
  static constexpr int kHalf = kC / 2;            // output columns a consumer
  static constexpr int kQBox = kBM * 128;         // 64 rows of 64 bf16
  static constexpr int kKBox = kBN * 128;         // kBN keys of 64 bf16
  static constexpr int kQBytes = kBoxes * kQBox;
  static constexpr int kKVBytes = kBoxes * kKBox;
  static constexpr int kOffK = kQBytes;
  static constexpr int kOffV = kOffK + kStages * kKVBytes;
  static constexpr int kOffX = kOffV + kStages * kKVBytes;
  static constexpr int kXBytes = kConsumers * kBM * kBN * 4;  // one tile's partial scores
  static constexpr int kOffBar = kOffX + 2 * kXBytes;
  static constexpr int kSmemBytes = kOffBar + (2 + 4 * kStages) * 8 + 1024;  // + alignment slack
  static_assert(kC % 128 == 0, "whole 64-column boxes a consumer");
  static_assert(kKBox % 1024 == 0, "swizzled tiles stay 1024-byte aligned");
  static_assert(kSmemBytes <= 232448, "the 227 KB a block may have");
};

// q, k, v [F, n, C] as (C, n, F).
struct Maps {
  CUtensorMap q, k, v;
  __device__ void prefetch() const {
    sm90::tma_prefetch(&q);
    sm90::tma_prefetch(&k);
    sm90::tma_prefetch(&v);
  }
};

struct Params {
  int F, n, nqt, nk;  // frames, pixels a frame, 64-row query tiles, key tiles
  float scale_l2;     // log2(e) / sqrt(C)
  bf16* o;            // [F, n, C]
};

// 2^x by one MUFU op, attention_pipeline.cuh's fast_exp2 (conv_ab's K3 and
// K5 ablations patch that copy in place, so it stays in that file).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void pv_step(float (&o)[128], const uint32_t (&pa)[4], uint64_t b) {
  sm90::wgmma_m64n256k16_rs_bf16(o, pa, b, 1);
}
__device__ __forceinline__ void pv_step(float (&o)[64], const uint32_t (&pa)[4], uint64_t b) {
  sm90::wgmma_m64n128k16_rs_bf16(o, pa, b, 1);
}

// A consumer's partial S = Q[:, half] K[:, half]^T of one key tile, issued
// and committed: k16 step kk reads box kk / 4 of the consumer's half of both
// tiles (qa, ka: its first box) at byte kk % 4 * 32 of their rows.
template <class G>
__device__ __forceinline__ void qk_product(float (&s)[kBN / 2], uint32_t qa, uint32_t ka) {
#pragma unroll
  for (int kk = 0; kk < G::kHalf / 16; ++kk) {
    const uint32_t col = (kk & 3) * 32;
    sm90::wgmma_m64n32k16_bf16_kmajor(s, sm90::desc_sw128(qa + (kk >> 2) * G::kQBox + col, 16, 1024),
            sm90::desc_sw128(ka + (kk >> 2) * G::kKBox + col, 16, 1024), kk > 0);
  }
  sm90::wgmma_commit();
}

// O[:, half] += P V[:, half] of one key tile, issued and committed: V is
// MN-major, the half's 64-column boxes kKBox apart, a k16 step 16 key rows
// (2 KB) further.
template <class G, int NO, int NP>
__device__ __forceinline__ void pv_product(float (&o)[NO], const uint32_t (&pa)[NP][4], uint32_t va) {
#pragma unroll
  for (int kk = 0; kk < NP; ++kk) pv_step(o, pa[kk], sm90::desc_sw128(va + kk * 16 * 128, G::kKBox, 1024));
  sm90::wgmma_commit();
}

// After wait_group 0: O and P's registers of the retired P V are the
// compiler's again.
template <int NO, int NP>
__device__ __forceinline__ void retire_pv(float (&o)[NO], uint32_t (&pa)[NP][4]) {
#pragma unroll
  for (int e = 0; e < NO; ++e) sm90::fence_operand(o[e]);
#pragma unroll
  for (int kk = 0; kk < NP; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) sm90::fence_operand(pa[kk][e]);
}

// The full scores of a retired Q K^T, in place and in the log2 domain: this
// consumer's partial plus the other's, through shared memory (x: the
// tile's buffer, [consumer][N / 4][128 threads] float4s). The barrier
// publishes both partials. A consumer writes a buffer again two tiles
// later, after the other consumer has passed the next tile's barrier, so
// after its read of this one. Keys past n (the last tile's tail) are -inf.
template <int N>
__device__ __forceinline__ void full_scores(float (&s)[N], float4* x, int c, int tid, float scale_l2, int key0, int n) {
#pragma unroll
  for (int e = 0; e < N; ++e) sm90::fence_operand(s[e]);
  float4* mine = x + c * (N / 4) * 128;
  const float4* other = x + (1 - c) * (N / 4) * 128;
#pragma unroll
  for (int e4 = 0; e4 < N / 4; ++e4)
    mine[e4 * 128 + tid] = make_float4(s[4 * e4], s[4 * e4 + 1], s[4 * e4 + 2], s[4 * e4 + 3]);
  sm90::named_barrier_sync(kBarFull, 128 * kConsumers);
#pragma unroll
  for (int e4 = 0; e4 < N / 4; ++e4) {
    const float4 y = other[e4 * 128 + tid];
    s[4 * e4] = (s[4 * e4] + y.x) * scale_l2;
    s[4 * e4 + 1] = (s[4 * e4 + 1] + y.y) * scale_l2;
    s[4 * e4 + 2] = (s[4 * e4 + 2] + y.z) * scale_l2;
    s[4 * e4 + 3] = (s[4 * e4 + 3] + y.w) * scale_l2;
  }
  if (key0 + 2 * N > n) {  // a tile that reaches past the frame's last pixel
    const int t = tid & 3;
#pragma unroll
    for (int e = 0; e < N; ++e)
      if (key0 + 8 * (e >> 2) + 2 * t + (e & 1) >= n) s[e] = -INFINITY;
  }
}

// The online softmax of one key tile on its scores s (rows g: e % 4 = 0,
// 1; g + 8: 2, 3): the new running max, the probabilities, then, once the
// previous tile's P V has retired (not at the first tile), its V stage
// released, O and the sums rescaled and the probabilities packed as the
// next P V's A fragments.
template <int N, int NO>
__device__ __forceinline__ void softmax_tile(float (&s)[N], float (&m)[2], float (&l)[2], uint32_t (&pa)[N / 8][4],
                                             float (&o)[NO], bool first, uint64_t* release, bool leader) {
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int e = 0; e < N; ++e) mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], s[e]);
  float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = quad_max(mx[r]);
    alpha[r] = fast_exp2(m[r] - mx[r]);  // 0 at the first tile (m = -inf)
    m[r] = mx[r];
  }
#pragma unroll
  for (int e = 0; e < N; ++e) {
    s[e] = fast_exp2(s[e] - m[(e >> 1) & 1]);
    sum[(e >> 1) & 1] += s[e];
  }
  if (!first) {
    sm90::wgmma_wait<0>();  // the previous tile's P V has retired
    retire_pv(o, pa);
    if (leader) sm90::mbar_arrive(release);
    if (alpha[0] != 1.f || alpha[1] != 1.f) {
#pragma unroll
      for (int n = 0; n < NO / 4; ++n) {
        o[4 * n] *= alpha[0];
        o[4 * n + 1] *= alpha[0];
        o[4 * n + 2] *= alpha[1];
        o[4 * n + 3] *= alpha[1];
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + sum[r];
#pragma unroll
  for (int kk = 0; kk < N / 8; ++kk) {
    pa[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
    pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

template <int kC>
__global__ void __launch_bounds__(kThreads, 1) mid_attention_kernel(const __grid_constant__ Maps maps, const Params p) {
  using G = Geometry<kC>;
  constexpr int N = kBN / 2;        // score accumulators a thread
  constexpr int NO = G::kHalf / 2;  // output accumulators a thread
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + G::kOffBar);
  uint64_t* q_empty = q_full + 1;
  uint64_t* k_full = q_full + 2;
  uint64_t* k_empty = k_full + kStages;
  uint64_t* v_full = k_empty + kStages;
  uint64_t* v_empty = v_full + kStages;
  const int items = p.F * p.nqt;

  if (threadIdx.x == 0) {
    sm90::mbar_init(q_full, 1);
    sm90::mbar_init(q_empty, kConsumers);
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(k_full + s, 1);
      sm90::mbar_init(k_empty + s, kConsumers);
      sm90::mbar_init(v_full + s, 1);
      sm90::mbar_init(v_empty + s, kConsumers);
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producers: warp 0 lane 0 loads Q and the K ring, warp 1 lane 0 the V ring ----
    sm90::setmaxnreg_dec<40>();
    const int warp = threadIdx.x / 32;
    if (warp < 2 && (threadIdx.x & 31) == 0) {
      const bool keys = warp == 0;
      if (keys) maps.prefetch();
      const CUtensorMap* map = keys ? &maps.k : &maps.v;
      uint64_t* full = keys ? k_full : v_full;
      uint64_t* empty = keys ? k_empty : v_empty;
      unsigned char* ring = smem + (keys ? G::kOffK : G::kOffV);
      int stage = 0;
      uint32_t phase = 0, qph = 0;
      for (int i = blockIdx.x; i < items; i += gridDim.x) {
        const int f = i / p.nqt;
        if (keys) {
          sm90::mbar_wait(q_empty, qph ^ 1);
          qph ^= 1;
          sm90::mbar_arrive_expect_tx(q_full, G::kQBytes);
          for (int b = 0; b < G::kBoxes; ++b)
            sm90::tma_load_3d(smem + b * G::kQBox, &maps.q, q_full, 64 * b, (i % p.nqt) * kBM, f);
        }
        for (int j = 0; j < p.nk; ++j) {
          sm90::mbar_wait(empty + stage, phase ^ 1);
          sm90::mbar_arrive_expect_tx(full + stage, G::kKVBytes);
          for (int b = 0; b < G::kBoxes; ++b)
            sm90::tma_load_3d(ring + stage * G::kKVBytes + b * G::kKBox, map, full + stage, 64 * b, kBN * j, f);
          sm90::advance(stage, phase, kStages);
        }
      }
    }
    return;
  }

  // ---- consumers: warp group c + 1 owns output columns [c C / 2, (c + 1) C / 2) ----
  sm90::setmaxnreg_inc<232>();
  const int c = wg - 1;
  const int tid = threadIdx.x & 127, warp = tid >> 5, g = (tid & 31) >> 2, t = tid & 3;
  const bool leader = tid == 0;
  const uint32_t qa = smem_addr(smem) + c * G::kHalfBoxes * G::kQBox;
  const uint32_t ka = smem_addr(smem + G::kOffK) + c * G::kHalfBoxes * G::kKBox;
  const uint32_t va = smem_addr(smem + G::kOffV) + c * G::kHalfBoxes * G::kKBox;
  float4* x = reinterpret_cast<float4*>(smem + G::kOffX);
  int ks = 0, vs = 0, xb = 0;  // xb: the exchange buffer, alternating tile by tile across items
  uint32_t kph = 0, vph = 0, qph = 0;
  for (int i = blockIdx.x; i < items; i += gridDim.x) {
    const int f = i / p.nqt, row0 = (i % p.nqt) * kBM;
    float o[NO];
#pragma unroll
    for (int e = 0; e < NO; ++e) o[e] = 0.f;
    float m[2] = {-INFINITY, -INFINITY};  // running max of rows g, g + 8 (log2 domain)
    float l[2] = {0.f, 0.f};              // this lane's part of their sums
    uint32_t pa[N / 8][4];                // the last tile's probabilities as P V's A fragments
    float s[N];                           // a tile's scores, then its probabilities
    sm90::mbar_wait(q_full, qph);
    qph ^= 1;

    // The first key tile: Q K^T alone. Each later one: Q K^T of tile j, then
    // P V of the tile before; the exchange and the softmax of tile j run
    // under that P V. No wgmma is issued in a branch.
    sm90::mbar_wait(k_full + ks, kph);
    sm90::wgmma_fence();
    qk_product<G>(s, qa, ka + ks * G::kKVBytes);
    sm90::wgmma_wait<0>();
    if (leader) {
      sm90::mbar_arrive(k_empty + ks);
      if (p.nk == 1) sm90::mbar_arrive(q_empty);
    }
    sm90::advance(ks, kph, kStages);
    full_scores(s, x + xb * (G::kXBytes / 16), c, tid, p.scale_l2, 0, p.n);
    xb ^= 1;
    softmax_tile(s, m, l, pa, o, true, nullptr, leader);
    for (int j = 1; j < p.nk; ++j) {
      sm90::mbar_wait(k_full + ks, kph);
      sm90::wgmma_fence();
      qk_product<G>(s, qa, ka + ks * G::kKVBytes);
      sm90::mbar_wait(v_full + vs, vph);
      pv_product<G>(o, pa, va + vs * G::kKVBytes);
      sm90::wgmma_wait<1>();  // Q K^T of tile j has retired
      if (leader) {
        sm90::mbar_arrive(k_empty + ks);
        if (j == p.nk - 1) sm90::mbar_arrive(q_empty);
      }
      sm90::advance(ks, kph, kStages);
      full_scores(s, x + xb * (G::kXBytes / 16), c, tid, p.scale_l2, kBN * j, p.n);
      xb ^= 1;
      softmax_tile(s, m, l, pa, o, false, v_empty + vs, leader);
      sm90::advance(vs, vph, kStages);
    }
    sm90::mbar_wait(v_full + vs, vph);
    sm90::wgmma_fence();
    pv_product<G>(o, pa, va + vs * G::kKVBytes);
    sm90::wgmma_wait<0>();
    retire_pv(o, pa);
    if (leader) sm90::mbar_arrive(v_empty + vs);
    sm90::advance(vs, vph, kStages);

    // epilogue: lane (g, t) holds columns 8n + 2t, +1 of rows g and g + 8;
    // four 8-column blocks at a time the quad swaps pairs so that lane t
    // ends with all 8 columns of block 4 j4 + t
#pragma unroll
    for (int rh = 0; rh < 2; ++rh) {
      const float inv = 1.f / quad_sum(l[rh]);
      const int r = row0 + 16 * warp + g + 8 * rh;
      bf16* dst = r < p.n ? p.o + ((long)f * p.n + r) * kC + c * G::kHalf : nullptr;
#pragma unroll
      for (int j4 = 0; j4 < NO / 16; ++j4) {
        uint32_t v[4];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int n = 4 * j4 + jj;
          v[jj] = pack_bf16(o[4 * n + 2 * rh] * inv, o[4 * n + 2 * rh + 1] * inv);
        }
        const uint4 out = quad_transpose(v, t);
        if (dst != nullptr) *reinterpret_cast<uint4*>(dst + 32 * j4 + 8 * t) = out;
      }
    }
  }
}

// ---- host side ----
// Internal linkage: conv_ab loads libraries of other trees beside this one
// (see conv_pipeline.cuh).
namespace {

// A 3-D map over [F, n, C] bf16 as (C, n, F), boxes of 64 columns x `rows`
// rows of one frame, 128-byte swizzle, zeros past the end.
inline CUresult encode(PFN_cuTensorMapEncodeTiled_v12000 fn, CUtensorMap* map, const void* ptr, int F, int n, int C,
                       int rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)C, (cuuint64_t)n, (cuuint64_t)F};
  const cuuint64_t strides[2] = {(cuuint64_t)C * 2, (cuuint64_t)n * C * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)rows, 1};
  const cuuint32_t ones[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides, box, ones,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);  // NONE fills zeros
}

// Encodes the maps and launches the kernel on `stream` over min(items, SMs)
// blocks. Returns 0, a cudaError_t, or kEncodeError + a CUresult.
template <int kC>
int launch(const void* q, const void* k, const void* v, void* o, int F, int n, float scale, cudaStream_t stream) {
  cudaError_t err = cudaSuccess;
  const auto fn = sm90::tensor_map_encoder(&err);
  if (fn == nullptr) return (int)err;
  Maps m;
  CUresult r;
  if ((r = encode(fn, &m.q, q, F, n, kC, kBM)) != CUDA_SUCCESS) return kEncodeError + (int)r;
  if ((r = encode(fn, &m.k, k, F, n, kC, kBN)) != CUDA_SUCCESS) return kEncodeError + (int)r;
  if ((r = encode(fn, &m.v, v, F, n, kC, kBN)) != CUDA_SUCCESS) return kEncodeError + (int)r;

  // once per device: the shared-memory opt-in above 48 KB; the SM count
  static bool opted[kMaxDevices] = {false};
  static int sms[kMaxDevices] = {0};
  int dev = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  constexpr int smem = Geometry<kC>::kSmemBytes;
  const auto kernel = mid_attention_kernel<kC>;
  if (!opted[dev]) {
    if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem)) != cudaSuccess)
      return (int)err;
    int count = 0;
    if ((err = cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return (int)err;
    sms[dev] = count;
    opted[dev] = true;
  }
  Params p;
  p.F = F;
  p.n = n;
  p.nqt = (n + kBM - 1) / kBM;
  p.nk = (n + kBN - 1) / kBN;
  p.scale_l2 = scale * kLog2e;
  p.o = (bf16*)o;
  const long items = (long)p.nqt * F;
  if (items > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const int grid = items < sms[dev] ? (int)items : sms[dev];
  kernel<<<grid, kThreads, smem, stream>>>(m, p);
  return (int)cudaGetLastError();
}

// Registers a thread, local memory (spills) a thread and the dynamic shared
// memory of the kernel.
template <int kC>
int attributes(int* regs, int* local_bytes, int* smem_bytes) {
  cudaFuncAttributes f;
  const cudaError_t err = cudaFuncGetAttributes(&f, mid_attention_kernel<kC>);
  if (err != cudaSuccess) return (int)err;
  *regs = f.numRegs;
  *local_bytes = (int)f.localSizeBytes;
  *smem_bytes = Geometry<kC>::kSmemBytes;
  return 0;
}

}  // namespace

}  // namespace midattn
}  // namespace seedvr2

// The flash-attention loop of K3 / K3q and K5 on Hopper's pipeline (TMA,
// mbarrier rings, wgmma; the primitives of hopper.cuh, the producer /
// consumer shape of conv_pipeline.cuh). A policy says which rows a query
// tile and a key tile are, and where they lie: the window attention's
// (window_attention.cuh; q and k arrive prepared by window_qk_prepare.cuh,
// key codes and key-tile flags in scratch) and the masked attention's over
// strided [B, S, H, D] rows (flash_attention.cuh; the key codes made from
// kv_valid in the producer warp). The loop does no per-tile work besides
// the softmax.
//
// - Block: one producer warp group (one thread issues every TMA and bulk
//   copy, after setmaxnreg down to 40 registers; with P::kProducerCodes its
//   warp's 32 lanes also find an item's live key tiles and write each
//   stage's key codes) and two consumer warp
//   groups (232 registers), each owning one 64-row query tile of the
//   block's work item; both consume the same key tiles, so a key tile is
//   loaded once for 128 query rows. The grid is persistent (one block an
//   SM walks items blockIdx.x, + gridDim.x, ...): the producer loads the
//   next item's Q tiles and first key tiles while the consumers finish the
//   current item's last tile and epilogue.
// - Rings: each consumer's Q tile (one full / empty barrier pair a
//   consumer, the empty one released after the item's last Q K^T) and a
//   kStages ring of [K | V | key codes | K3q key scales] stages. Q, K and V
//   land by TMA in the 128-byte swizzle: bf16 rows as two 64-column boxes
//   of 64 rows (8 KB each), K3q's int8 codes as one box of 64 rows of 128
//   bytes; the 64-key chunks of the codes and scales by bulk copy. A box
//   past the end of its rows lands as zeros.
// - S = Q K^T: wgmma m64n64k16 bf16 (8 k16 steps) or m64n64k32 s8 (4 k32
//   steps), both operands K-major from shared memory.
// - Softmax in registers, in the log2 domain: the logit scale (K3q: s_q *
//   scale * log2(e) a row, then s_k a key), the key code (0, or -inf for a
//   key that does not count), the row max and sum over the 4 lanes of a
//   quad, the running max starting at the JAX masked logit (finite, so a
//   tile of masked keys rescales nothing; a row whose keys are all masked
//   ends at that max, and the policy's extra_den adds the terms of keys it
//   never loaded).
// - O += P V: wgmma m64n128k16 with P from registers (the score
//   accumulators re-packed as bf16 A fragments) and V MN-major (tnspB = 1).
// - Overlap inside a consumer: the Q K^T of tile j is issued, then the P V
//   of tile j - 1; the softmax of tile j runs while that P V does, and O is
//   rescaled once it has retired (the order of FlashAttention-3's
//   intra-warpgroup pipelining). The other consumer warp group's products
//   fill the tensor cores while this one is in its softmax.
// - Epilogue from registers: 1 / denominator, bf16, a 4 x 4 transpose in
//   each lane quad so that every lane stores 16 contiguous bytes.
// No atomics: every output row is written once, by one thread, in a fixed
// order of operations, so two launches give the same bits and a rank's
// launch on a slice of the windows gives the unsharded launch's rows.
//
// What holds it (conv_ab --ablate on an H100 80GB HBM3 at 700 W, 3B 720p
// plain; PERF.md): with the products taken out the loop keeps most of its
// time, with the TMA and bulk loads or the exponentials taken out nearly
// all of it. The consumer warp groups' own instruction stream (the
// softmax's dependent max and sum chains, the quad shuffles, O's rescale,
// the waits between a tile's Q K^T and its softmax) sets the pace; two
// consumer warp groups are too few warps to hide its latencies.
//
// A policy P provides (all const): kQuant, kProducerCodes; int items(),
// Item item(i), int key_tiles(), uint64_t live_tiles(item) (with
// kProducerCodes: called by the producer warp's 32 lanes together, and
// handed to the consumers through shared memory beside their Q tile), int
// next_tile(live, j) (the key tile after j that holds a key: a tile of
// masked keys adds exactly 0 to the sums and to O, so it is not loaded) and
// int last_tile(live); QTile q_tile(item, c) (kind 0: none, 1: video, 2:
// text; first row, rows); load_q(maps, item, qtile, dst, bar) and uint32_t
// kv_bytes(j), load_kv(maps, item, j, k, v, code, scale, bar) (the copies
// of one stage); with kProducerCodes, float2 key_codes(item, j, lane) (the
// codes of keys 64 j + lane and + 32, written to the stage by that lane);
// bool video_tile(j) (its codes are in the stage), float text_code(j, col)
// (the code of a key that has none there); float q_scale(item, qtile, r)
// (K3q); bf16* out_row(item, qtile, r) (null past the tile's rows), bool
// keep(item, qtile, r) (false: the row is written as zeros); float
// extra_den(m) (denominator terms of keys never loaded, at the row's final
// max m).
#pragma once

#include <math.h>

#include "common.cuh"
#include "hopper.cuh"

namespace seedvr2 {
namespace flash {

constexpr int kD = 128;           // head dim (3B and 7B)
constexpr int kBM = 64;           // query rows a consumer warp group
constexpr int kBN = 64;           // keys a tile
constexpr int kConsumers = 2;
constexpr int kThreads = 128 * (1 + kConsumers);
constexpr int kStages = 4;
constexpr int kBox = 64 * 128;    // one TMA box: 64 rows of 128 bytes
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kMaskedL2 = -1e30f * kLog2e;  // the JAX masked logit -1e30 in the log2 domain

template <bool kQuant>
struct Layout {
  static constexpr int kQBytes = kQuant ? kBox : 2 * kBox;  // a Q tile; a K tile is the same
  static constexpr int kVBytes = 2 * kBox;
  static constexpr int kOffK = kConsumers * kQBytes;
  static constexpr int kOffV = kOffK + kStages * kQBytes;
  static constexpr int kOffCode = kOffV + kStages * kVBytes;
  static constexpr int kOffScale = kOffCode + kStages * kBN * 4;
  static constexpr int kOffBar = kOffScale + kStages * kBN * 4;
  static constexpr int kOffLive = kOffBar + (2 * kConsumers + 2 * kStages) * 8;  // each consumer's item's live tiles
  static constexpr int kSmemBytes = kOffLive + kConsumers * 8 + 1024;            // + alignment slack
  static_assert(kOffK % 1024 == 0 && kOffV % 1024 == 0, "swizzled tiles stay 1024-byte aligned");
  static_assert(kSmemBytes <= 232448, "the 227 KB a block may have");
};

struct QTile {
  int kind, row0, rows;  // kind 0: no tile, 1: video rows, 2: text rows
};

// 2^x by one MUFU op (ex2.approx.ftz): exp2f adds a fix-up for subnormal
// results, which here are probabilities under 2^-126 beside a row maximum's
// 1; flushed to 0 they change no sum (conv_ab --ablate times the loop with
// exp2f in its place).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// S = Q K^T of one key tile, issued and committed (not waited for). bf16:
// k16 step kk reads 64-column half kk / 4 of both tiles at byte kk % 4 * 32
// of their rows; s8: one 128-byte row, k32 step kk at byte 32 kk.
__device__ __forceinline__ void qk_product(float (&s)[32], uint32_t qa, uint32_t ka) {
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    const uint32_t off = (kk >> 2) * kBox + (kk & 3) * 32;
    sm90::wgmma_m64n64k16_bf16_kmajor(s, sm90::desc_sw128(qa + off, 16, 1024), sm90::desc_sw128(ka + off, 16, 1024),
                                      kk > 0);
  }
  sm90::wgmma_commit();
}

__device__ __forceinline__ void qk_product(int (&s)[32], uint32_t qa, uint32_t ka) {
#pragma unroll
  for (int kk = 0; kk < kD / 32; ++kk)
    sm90::wgmma_m64n64k32_s8(s, sm90::desc_sw128(qa + kk * 32, 16, 1024), sm90::desc_sw128(ka + kk * 32, 16, 1024),
                             kk > 0);
  sm90::wgmma_commit();
}

// O += P V of one key tile (P: the tile's 4 k16 steps of A fragments),
// issued and committed. V is MN-major: two 64-column atoms kBox apart, a
// k16 step 16 rows (2 KB) further.
__device__ __forceinline__ void pv_product(float (&o)[64], const uint32_t (&pa)[4][4], uint32_t va) {
#pragma unroll
  for (int kk = 0; kk < kBN / 16; ++kk)
    sm90::wgmma_m64n128k16_rs_bf16(o, pa[kk], sm90::desc_sw128(va + kk * 16 * 128, kBox, 1024), 1);
  sm90::wgmma_commit();
}

template <bool kQuant>
struct Acc {
  using T = float;
};
template <>
struct Acc<true> {
  using T = int;
};

// After wait_group 0: the accumulators and P's registers of the retired
// P V are the compiler's again (and stay where wgmma left them until now).
__device__ __forceinline__ void retire_pv(float (&o)[64], uint32_t (&pa)[kBN / 16][4]) {
#pragma unroll
  for (int e = 0; e < 64; ++e) sm90::fence_operand(o[e]);
#pragma unroll
  for (int kk = 0; kk < kBN / 16; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) sm90::fence_operand(pa[kk][e]);
}

// A retired Q K^T as log2-domain logits: bf16 times scale * log2(e); K3q
// float(dot) * (s_q * scale * log2(e)) * s_k (ks: the tile's key scales).
__device__ __forceinline__ void logits(float (&acc)[32], float (&s)[32], const float (&)[2], const float*,
                                       float scale_l2) {
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    sm90::fence_operand(acc[e]);
    s[e] = acc[e] * scale_l2;
  }
}

__device__ __forceinline__ void logits(int (&acc)[32], float (&s)[32], const float (&qs)[2], const float* ks, float) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int e = 0; e < 32; ++e) sm90::fence_operand(acc[e]);
#pragma unroll
  for (int n = 0; n < kBN / 8; ++n) {
    const float2 k2 = *reinterpret_cast<const float2*>(ks + 8 * n + 2 * t);
#pragma unroll
    for (int e = 0; e < 4; ++e) s[4 * n + e] = __fmul_rn(__fmul_rn((float)acc[4 * n + e], qs[e >> 1]), (e & 1) ? k2.y : k2.x);
  }
}

// The online softmax of key tile j on its logits s (rows g: e % 4 = 0, 1;
// g + 8: 2, 3; cd: the tile's key codes when it is a video tile): the
// masked keys' codes, the new running max, the probabilities, then, once
// the previous tile's P V has retired (not at the first tile), its stage
// released, O and the sums rescaled and the probabilities packed as the
// next P V's A fragments.
template <class P>
__device__ __forceinline__ void softmax_tile(const P& p, int j, const float* cd, int t, float (&s)[32], float (&m)[2],
                                             float (&l)[2], uint32_t (&pa)[kBN / 16][4], float (&o)[64], bool first,
                                             uint64_t* release = nullptr, bool leader = false) {
  const bool vid = p.video_tile(j);
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int n = 0; n < kBN / 8; ++n) {
    const int col = 8 * n + 2 * t;
    const float2 c2 =
        vid ? *reinterpret_cast<const float2*>(cd + col) : make_float2(p.text_code(j, col), p.text_code(j, col + 1));
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float code = (e & 1) ? c2.y : c2.x;
      if (code != 0.f) s[4 * n + e] = code;
      mx[e >> 1] = fmaxf(mx[e >> 1], s[4 * n + e]);
    }
  }
  float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = quad_max(mx[r]);
    alpha[r] = fast_exp2(m[r] - mx[r]);
    m[r] = mx[r];
  }
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    s[e] = fast_exp2(s[e] - m[(e >> 1) & 1]);
    sum[(e >> 1) & 1] += s[e];
  }
  if (!first) {
    sm90::wgmma_wait<0>();  // the previous tile's P V has retired
    retire_pv(o, pa);
    if (leader) sm90::mbar_arrive(release);
#pragma unroll
    for (int n = 0; n < kD / 8; ++n) {
      o[4 * n] *= alpha[0];
      o[4 * n + 1] *= alpha[0];
      o[4 * n + 2] *= alpha[1];
      o[4 * n + 3] *= alpha[1];
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + sum[r];
#pragma unroll
  for (int kk = 0; kk < kBN / 16; ++kk) {
    pa[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
    pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

template <class Maps, class P>
__global__ void __launch_bounds__(kThreads, 1) flash_kernel(const __grid_constant__ Maps maps, const P p) {
  using L = Layout<P::kQuant>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* kbuf = smem + L::kOffK;
  unsigned char* vbuf = smem + L::kOffV;
  float* codes = reinterpret_cast<float*>(smem + L::kOffCode);
  float* kscales = reinterpret_cast<float*>(smem + L::kOffScale);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::kOffBar);
  uint64_t* q_empty = q_full + kConsumers;
  uint64_t* full = q_empty + kConsumers;
  uint64_t* empty = full + kStages;
  uint64_t* q_live = reinterpret_cast<uint64_t*>(smem + L::kOffLive);
  const int nk = p.key_tiles();
  constexpr int kLanes = P::kProducerCodes ? 32 : 1;  // the producer's threads

  if (threadIdx.x == 0) {
    for (int c = 0; c < kConsumers; ++c) {
      sm90::mbar_init(q_full + c, 1);
      sm90::mbar_init(q_empty + c, 1);
    }
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(full + s, kLanes);
      sm90::mbar_init(empty + s, kConsumers);
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    sm90::setmaxnreg_dec<40>();
    if (threadIdx.x < kLanes) {
      // ---- producer: lane 0 keeps the Q buffers and the key ring full; with
      // kProducerCodes every lane writes its two key codes of each stage and
      // arrives on the stage's barrier, lane 0 with the stage's bytes ----
      const int lane = threadIdx.x;
      if (lane == 0) maps.prefetch();
      int stage = 0;
      uint32_t phase = 0, qph = 0;
      for (int i = blockIdx.x; i < p.items(); i += gridDim.x) {
        const typename P::Item it = p.item(i);
        const uint64_t live = p.live_tiles(it);  // read before the waits below, which hide its latency
        if (lane == 0) {
          for (int c = 0; c < kConsumers; ++c) {
            const QTile qt = p.q_tile(it, c);
            sm90::mbar_wait(q_empty + c, qph ^ 1);
            if constexpr (P::kProducerCodes) q_live[c] = live;  // released to the consumer by the arrival below
            if (qt.kind != 0) {
              sm90::mbar_arrive_expect_tx(q_full + c, L::kQBytes);
              p.load_q(maps, it, qt, smem + c * L::kQBytes, q_full + c);
            } else {
              sm90::mbar_arrive(q_full + c);  // no tile: the consumer passes the item's key tiles through
            }
          }
        }
        qph ^= 1;
        for (int j = p.next_tile(live, -1); j < nk; j = p.next_tile(live, j)) {
          float2 cd;
          if constexpr (P::kProducerCodes) cd = p.key_codes(it, j, lane);  // loaded before the wait, which hides it
          sm90::mbar_wait(empty + stage, phase ^ 1);
          if constexpr (P::kProducerCodes) {
            codes[stage * kBN + lane] = cd.x;
            codes[stage * kBN + 32 + lane] = cd.y;
          }
          if (lane == 0) {
            sm90::mbar_arrive_expect_tx(full + stage, p.kv_bytes(j));
            p.load_kv(maps, it, j, kbuf + stage * L::kQBytes, vbuf + stage * L::kVBytes, codes + stage * kBN,
                      kscales + stage * kBN, full + stage);
          } else {
            sm90::mbar_arrive(full + stage);  // releases this lane's codes
          }
          sm90::advance(stage, phase, kStages);
        }
      }
    }
    return;
  }

  // ---- consumers: warp group c + 1 owns query tile c of each item ----
  sm90::setmaxnreg_inc<232>();
  const int c = wg - 1;
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const bool leader = tid == 0;
  const uint32_t qa = smem_addr(smem + c * L::kQBytes);
  int stage = 0;
  uint32_t phase = 0, qph = 0;
  for (int i = blockIdx.x; i < p.items(); i += gridDim.x) {
    const typename P::Item it = p.item(i);
    const QTile qt = p.q_tile(it, c);
    uint64_t live = 0;
    if constexpr (!P::kProducerCodes) live = p.live_tiles(it);  // read before the wait for Q, which hides its latency
    const bool keep[2] = {p.keep(it, qt, 16 * warp + g), p.keep(it, qt, 16 * warp + g + 8)};
    sm90::mbar_wait(q_full + c, qph);
    qph ^= 1;
    if constexpr (P::kProducerCodes) live = q_live[c];
    const int last = p.last_tile(live);  // the item's last read of Q
    if (qt.kind == 0) {
      for (int j = p.next_tile(live, -1); j < nk; j = p.next_tile(live, j)) {
        sm90::mbar_wait(full + stage, phase);
        if (leader) sm90::mbar_arrive(empty + stage);
        sm90::advance(stage, phase, kStages);
      }
      if (leader) sm90::mbar_arrive(q_empty + c);
      continue;
    }
    float qs[2] = {0.f, 0.f};  // K3q: s_q * scale * log2(e) of rows g, g + 8
    if constexpr (P::kQuant) {
      qs[0] = __fmul_rn(p.q_scale(it, qt, 16 * warp + g), p.scale) * kLog2e;
      qs[1] = __fmul_rn(p.q_scale(it, qt, 16 * warp + g + 8), p.scale) * kLog2e;
    }
    float o[64];
#pragma unroll
    for (int e = 0; e < 64; ++e) o[e] = 0.f;
    float m[2] = {kMaskedL2, kMaskedL2};  // running max of rows g, g + 8 (log2 domain)
    float l[2] = {0.f, 0.f};              // this lane's part of their sums
    uint32_t pa[kBN / 16][4];             // the last tile's probabilities as P V's A fragments
    typename Acc<P::kQuant>::T acc[32];   // Q K^T of a tile
    float s[32];

    // The first live key tile: Q K^T alone. Each later one: Q K^T of tile j,
    // then P V of the tile before; the softmax of tile j runs under that P V.
    // No wgmma is issued in a branch (ptxas serialises a warp group's
    // products when one is).
    int j = p.next_tile(live, -1);
    sm90::mbar_wait(full + stage, phase);
    sm90::wgmma_fence();
    qk_product(acc, qa, smem_addr(kbuf + stage * L::kQBytes));
    sm90::wgmma_wait<0>();
    if (j == last && leader) sm90::mbar_arrive(q_empty + c);
    logits(acc, s, qs, kscales + stage * kBN, p.scale * kLog2e);
    softmax_tile(p, j, codes + stage * kBN, t, s, m, l, pa, o, true);
    int prev = stage;
    sm90::advance(stage, phase, kStages);
    for (j = p.next_tile(live, j); j < nk; j = p.next_tile(live, j)) {
      sm90::mbar_wait(full + stage, phase);
      sm90::wgmma_fence();
      qk_product(acc, qa, smem_addr(kbuf + stage * L::kQBytes));
      pv_product(o, pa, smem_addr(vbuf + prev * L::kVBytes));
      sm90::wgmma_wait<1>();  // Q K^T of tile j has retired
      if (j == last && leader) sm90::mbar_arrive(q_empty + c);
      logits(acc, s, qs, kscales + stage * kBN, p.scale * kLog2e);
      softmax_tile(p, j, codes + stage * kBN, t, s, m, l, pa, o, false, empty + prev, leader);
      prev = stage;
      sm90::advance(stage, phase, kStages);
    }
    sm90::wgmma_fence();
    pv_product(o, pa, smem_addr(vbuf + prev * L::kVBytes));
    sm90::wgmma_wait<0>();
    retire_pv(o, pa);
    if (leader) sm90::mbar_arrive(empty + prev);

    // epilogue: lane (g, t) holds columns 8n + 2t, +1 of rows g and g + 8;
    // four 8-column blocks at a time the quad swaps pairs so that lane t
    // ends with all 8 columns of block 4 j4 + t
#pragma unroll
    for (int rh = 0; rh < 2; ++rh) {
      const float den = quad_sum(l[rh]) + p.extra_den(m[rh]);
      const float inv = den == 0.f ? 1.f : 1.f / den;
      bf16* dst = p.out_row(it, qt, 16 * warp + g + 8 * rh);
#pragma unroll
      for (int j4 = 0; j4 < 4; ++j4) {
        uint32_t v[4];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int n = 4 * j4 + jj;
          v[jj] = pack_bf16(o[4 * n + 2 * rh] * inv, o[4 * n + 2 * rh + 1] * inv);
        }
        const uint4 out = quad_transpose(v, t);
        if (dst != nullptr) *reinterpret_cast<uint4*>(dst + 32 * j4 + 8 * t) = keep[rh] ? out : make_uint4(0, 0, 0, 0);
      }
    }
  }
}

}  // namespace flash
}  // namespace seedvr2

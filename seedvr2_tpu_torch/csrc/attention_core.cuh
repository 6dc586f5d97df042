// The register-resident flash-attention main loop of K5 (flash_attention.cuh)
// alone: one block of 8 warps per 128 query rows of one (batch, head); each
// warp owns 16 query rows end to end. It is Ampere's design (mma.sync from
// ldmatrix, a cp.async ring, no TMA, mbarrier or wgmma); K3 / K3q left it for
// Hopper's pipeline (attention_pipeline.cuh), which K5 is to move onto next.
//
// Per 64-key tile: Q K^T on mma.sync (bf16 m16n8k16, or s8 m16n8k32 for
// K3q) into fp32 score registers; the online softmax in those registers
// (log2 domain, row max and sum over the 4 lanes of a quad by shuffles,
// the running max and partial sums per lane); the probabilities re-packed
// as bf16 pairs straight into the A operand of P V (the accumulator of
// m16n8 and the A operand of m16n8k16 share the row/column split); O in
// registers (16 x 128 fp32 per warp, 64 a lane), rescaled there and written
// once after the last tile. K and V tiles stream through a two-stage ring
// filled by cp.async, so tile j+1 lands while tile j computes; the loader is
// the policy's. Shared memory ~102 KB a block: two blocks (16 warps) an SM.
//
// A policy P provides (all const):
//   P(args)                      block coordinates from blockIdx
//   int rows()                   query rows = key rows of this block's problem
//   float scale()                the logit scale, 1/sqrt(D)
//   const bf16* row(kind, idx)   row idx < rows() of q (0), k (1), v (2)
//   float key_code(key)          0: a key of the softmax; otherwise the key's
//                                log2-domain logit (kMaskedL2: masked but
//                                counted, as the JAX -1e30; -inf: no key)
//   float extra_den(m)           denominator terms of keys never loaded
//   bf16* out_row(idx), bool keep(idx)   where row idx goes; false: zeros
#pragma once

#include <math.h>

#include "common.cuh"
#include "ptx.cuh"

namespace seedvr2 {
namespace attn {

constexpr int kD = 128;        // head dim (3B and 7B)
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kBM = 16 * kWarps;  // query rows per block
constexpr int kBN = 64;           // keys per tile
constexpr int kLd = kD + 8;       // bf16 tile row stride: 272 bytes, ldmatrix rows on distinct banks
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kMaskedL2 = -1e30f * kLog2e;  // the JAX masked logit -1e30 in the log2 domain

// Shared memory: two stages of [K | V] (64 rows each), the Q tile, then the
// two stages' key codes.
constexpr int kStageBytes = 2 * kBN * kLd * 2;
constexpr int kOffQ = 2 * kStageBytes;
constexpr int kOffF = kOffQ + kBM * kLd * 2;
constexpr int kSmemBytes = kOffF + 2 * kBN * 4;

struct Smem {
  bf16* stage;       // [2][K|V][kBN][kLd]
  bf16* q;           // [kBM][kLd]
  float* code;       // [2][kBN]
  __device__ explicit Smem(unsigned char* p)
      : stage(reinterpret_cast<bf16*>(p)),
        q(reinterpret_cast<bf16*>(p + kOffQ)),
        code(reinterpret_cast<float*>(p + kOffF)) {}
  __device__ bf16* k(int s) const { return stage + s * 2 * kBN * kLd; }
  __device__ bf16* v(int s) const { return stage + s * 2 * kBN * kLd + kBN * kLd; }
};

// Rows [row0, row0 + n) of q/k/v (kind) into dst (stride kLd) by cp.async;
// rows at or past P::rows() are zero-filled.
template <class P>
__device__ __forceinline__ void load_rows(const P& p, int kind, int row0, int n, bf16* dst) {
  const int rows = p.rows();
  const bf16* any = p.row(kind, 0);
  for (int e = threadIdx.x; e < n * (kD / 8); e += kThreads) {
    const int r = e >> 4, c = (e & 15) * 8;
    const int idx = row0 + r;
    const bool ok = idx < rows;
    cp_async16(dst + r * kLd + c, ok ? p.row(kind, idx) + c : any, ok);
  }
}

// Tile j's K and V into stage s, its key codes into code[s].
template <class P>
__device__ __forceinline__ void fetch_tile(const P& p, const Smem& sm, int j, int s) {
  load_rows(p, 1, j * kBN, kBN, sm.k(s));
  load_rows(p, 2, j * kBN, kBN, sm.v(s));
  if (threadIdx.x < kBN) sm.code[s * kBN + threadIdx.x] = p.key_code(j * kBN + threadIdx.x);
  cp_async_commit();
}

// grid = (ceil(rows / kBM), policy's y, policy's z), kThreads threads,
// kSmemBytes of dynamic shared memory.
template <class P>
__global__ void __launch_bounds__(kThreads, 2) attention_kernel(const typename P::Args args) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Smem sm(smem);
  const P p(args);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;  // accumulator row g (and g+8), cols 2t, 2t+1
  const int rw = warp * 16;               // the warp's first row in the block's tile
  const int q0 = blockIdx.x * kBM;
  const int ntiles = (p.rows() + kBN - 1) / kBN;

  load_rows(p, 0, q0, kBM, sm.q);
  fetch_tile(p, sm, 0, 0);

  float o[kD / 8][4];
#pragma unroll
  for (int n = 0; n < kD / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {kMaskedL2, kMaskedL2};  // running max of rows g, g+8 (log2 domain)
  float l[2] = {0.f, 0.f};              // this lane's part of their sums
  const float scale_l2 = p.scale() * kLog2e;

  for (int j = 0; j < ntiles; ++j) {
    const int s = j & 1;
    cp_async_wait_all();
    __syncthreads();  // tile j (and at j = 0 the Q tile) landed; every warp is done with tile j-1
    if (j + 1 < ntiles) fetch_tile(p, sm, j + 1, s ^ 1);

    // S = Q K^T: the warp's 16 rows x 64 keys, 8 accumulators of 16x8
    float sc[kBN / 8][4];
#pragma unroll
    for (int n = 0; n < kBN / 8; ++n) sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
    const bf16* kt = sm.k(s);
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      uint32_t a[4];
      ldsm_x4(a, sm.q + (rw + frag_row(lane)) * kLd + kk * 16 + frag_col(lane) * 8);
#pragma unroll
      for (int np = 0; np < kBN / 16; ++np) {
        uint32_t b[4];
        ldsm_x4(b, kt + (np * 16 + frag_row(lane)) * kLd + kk * 16 + frag_col(lane) * 8);
        mma_bf16(sc[2 * np], a, b[0], b[2]);
        mma_bf16(sc[2 * np + 1], a, b[1], b[3]);
      }
    }
#pragma unroll
    for (int n = 0; n < kBN / 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) sc[n][i] *= scale_l2;

    // online softmax in registers: rows g (i = 0, 1) and g+8 (i = 2, 3)
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < kBN / 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float code = sm.code[s * kBN + n * 8 + 2 * t + (i & 1)];
        if (code != 0.f) sc[n][i] = code;
        mx[i >> 1] = fmaxf(mx[i >> 1], sc[n][i]);
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = quad_max(mx[r]);
      const float alpha = exp2f(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= alpha;
#pragma unroll
      for (int n = 0; n < kD / 8; ++n) {
        o[n][2 * r] *= alpha;
        o[n][2 * r + 1] *= alpha;
      }
    }
#pragma unroll
    for (int n = 0; n < kBN / 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        sc[n][i] = exp2f(sc[n][i] - m[i >> 1]);
        l[i >> 1] += sc[n][i];
      }

    // O += P V: P's accumulators re-packed as bf16 A operands, 16 keys a step
    const bf16* vt = sm.v(s);
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(sc[2 * kk][0], sc[2 * kk][1]), pack_bf16(sc[2 * kk][2], sc[2 * kk][3]),
                             pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
                             pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
#pragma unroll
      for (int np = 0; np < kD / 16; ++np) {
        uint32_t b[4];
        ldsm_x4_trans(b, vt + (kk * 16 + frag_row(lane)) * kLd + np * 16 + frag_col(lane) * 8);
        mma_bf16(o[2 * np], a, b[0], b[1]);
        mma_bf16(o[2 * np + 1], a, b[2], b[3]);
      }
    }
  }

  // 1 / denominator, then O in bf16 through the warp's rows of stage 0 and
  // out in 16-byte stores
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float den = quad_sum(l[r]) + p.extra_den(m[r]);
    inv[r] = den == 0.f ? 1.f : 1.f / den;
  }
  __syncthreads();  // every warp is done with the last tile's stage
  bf16* st = sm.stage + rw * kLd;
#pragma unroll
  for (int n = 0; n < kD / 8; ++n) {
    *reinterpret_cast<uint32_t*>(st + g * kLd + n * 8 + 2 * t) = pack_bf16(o[n][0] * inv[0], o[n][1] * inv[0]);
    *reinterpret_cast<uint32_t*>(st + (g + 8) * kLd + n * 8 + 2 * t) =
        pack_bf16(o[n][2] * inv[1], o[n][3] * inv[1]);
  }
  __syncwarp();
#pragma unroll
  for (int k = 0; k < 16 * (kD / 8) / 32; ++k) {
    const int e = lane + 32 * k;
    const int r = e >> 4, c = (e & 15) * 8;
    const int idx = q0 + rw + r;
    if (idx >= p.rows()) continue;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (p.keep(idx)) v = *reinterpret_cast<const uint4*>(st + r * kLd + c);
    *reinterpret_cast<uint4*>(p.out_row(idx) + c) = v;
  }
}

}  // namespace attn
}  // namespace seedvr2

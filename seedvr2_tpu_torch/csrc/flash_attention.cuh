// K5: masked attention over [B, S, H, D] bf16 (D = 128) with an fp32
// softmax, the DiT's unfused window attention under attention_mode
// flash_attn_2/3.
//
// Replaces the Pallas kernel seedvr2_tpu/ops/flash_attention.py:
// flash_attention (_attn_kernel): logits q.k / sqrt(D) in fp32, masked keys
// at -1e30, fp32 softmax, probabilities in bf16 before PV, the output
// zeroed where q_valid is false. The Pallas version pads S to a multiple of
// 128 and transposes to [B*H, S, D] for the TPU compiler's alignment; here
// the kernel reads the strided [B, S, H, D] layout (each row of a head is
// 256 contiguous bytes) and masks the ragged S itself, so no padded or
// transposed copy exists. The JAX function's padding keys (masked, zero
// value) still count in its softmax denominator, which only a row with no
// valid key can see: the kernel adds their n_pad terms exp(-1e30 - m) at
// the end instead of loading them.
//
// What bounds it on the H100: at the DiT's shapes (S = 463, 7B: B*nW = 32,
// H = 24) a (b, h) does 4*S^2*D flops on 4*S*D*2 bytes of q, k, v and o,
// ~230 flops a byte, under the card's ~295 for bf16, so the least time is
// set by the bytes. This first kernel is far from either: like K3, its
// one-thread-per-row softmax and synchronous loads bound it. Design:
// K3's flash tile without the norm and RoPE (window_attention.cuh): one
// block per (64-query tile, head, batch), 64-key tiles of K and V in shared
// memory, Q as WMMA bf16 fragments in registers, an online fp32 softmax and
// an fp32 output accumulator in shared memory, ~94 KB a block, two blocks
// per SM. Masked keys keep their -1e30 logit through the online max, as in
// the JAX math, so a tile of masked keys is rescaled to zero by the first
// tile with a valid key.
#pragma once

#include "window_attention.cuh"

namespace seedvr2 {

struct FlashArgs {
  const bf16* q;  // [B, S, H, D]
  const bf16* k;
  const bf16* v;
  const uint8_t* kv_valid;  // [B, S]
  const uint8_t* q_valid;   // [B, S] or null
  bf16* o;                  // [B, S, H, D]
  int S, H;
  int n_pad;  // keys the JAX function pads with: max(ceil(S/128)*128, 128) - S
  float scale;
};

// Rows [row0, row0 + 64) of head h of batch b from src [B, S, H, D] into
// dst (row stride kLdT); rows >= S are zero.
__device__ void flash_load_tile(const bf16* src, bf16* dst, int row0, int b, int h, int S, int H) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int e = tid + kThreads * k;
    const int r = e >> 4, dc = (e & 15) * 8;
    const int idx = row0 + r;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (idx < S) x = *reinterpret_cast<const uint4*>(src + (((long)b * S + idx) * H + h) * kD + dc);
    *reinterpret_cast<uint4*>(dst + r * kLdT + dc) = x;
  }
}

// grid = (ceil(S/64), H, B); dynamic shared memory kAttnSmem.
__global__ void __launch_bounds__(kThreads) flash_attention_kernel(const FlashArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem + kOffK);
  bf16* sV = reinterpret_cast<bf16*>(smem + kOffV);
  float* sO = reinterpret_cast<float*>(smem + kOffO);
  float* sS = reinterpret_cast<float*>(smem + kOffS);
  bf16* sP = reinterpret_cast<bf16*>(smem + kOffP);
  float* sAlpha = reinterpret_cast<float*>(smem + kOffRow);
  float* sKey = sAlpha + kTile;  // 1 valid, 0 masked, -1 past S

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * kTile;

  flash_load_tile(a.q, sK, q0, b, h, a.S, a.H);
  __syncthreads();
  FragA qf[kD / 16];
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) wmma::load_matrix_sync(qf[kk], sK + warp * 16 * kLdT + kk * 16, kLdT);
  for (int e = tid; e < kTile * kLdO; e += kThreads) sO[e] = 0.f;
  float m_run = -1e30f, l_run = 0.f;  // row tid's running max and sum (tid < 64)
  __syncthreads();

  for (int j0 = 0; j0 < a.S; j0 += kTile) {
    flash_load_tile(a.k, sK, j0, b, h, a.S, a.H);
    flash_load_tile(a.v, sV, j0, b, h, a.S, a.H);
    if (tid < kTile) {
      const int key = j0 + tid;
      sKey[tid] = key < a.S ? (a.kv_valid[(long)b * a.S + key] ? 1.f : 0.f) : -1.f;
    }
    __syncthreads();

#pragma unroll
    for (int nf = 0; nf < kTile / 16; ++nf) {
      FragC s;
      wmma::fill_fragment(s, 0.f);
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        FragBCol kb;
        wmma::load_matrix_sync(kb, sK + nf * 16 * kLdT + kk * 16, kLdT);
        wmma::mma_sync(s, qf[kk], kb, s);
      }
      wmma::store_matrix_sync(sS + warp * 16 * kLdS + nf * 16, s, kLdS, wmma::mem_row_major);
    }
    __syncthreads();

    // online softmax, one thread per query row; keys past S take no part
    if (tid < kTile) {
      const float* srow = sS + tid * kLdS;
      auto logit = [&](int c) { return sKey[c] > 0.f ? srow[c] * a.scale : -1e30f; };
      float mx = m_run;
      for (int c = 0; c < kTile; ++c)
        if (sKey[c] >= 0.f) mx = fmaxf(mx, logit(c));
      const float alpha = expf(m_run - mx);
      float sum = 0.f;
      for (int c = 0; c < kTile; ++c) {
        const float p = sKey[c] >= 0.f ? expf(logit(c) - mx) : 0.f;
        sP[tid * kLdP + c] = __float2bfloat16(p);
        sum += p;
      }
      l_run = l_run * alpha + sum;
      m_run = mx;
      sAlpha[tid] = alpha;
    }
    __syncthreads();
    for (int e = tid; e < kTile * kD; e += kThreads) sO[(e >> 7) * kLdO + (e & (kD - 1))] *= sAlpha[e >> 7];
    __syncthreads();

    // O += P V
    FragA pf[kTile / 16];
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) wmma::load_matrix_sync(pf[kk], sP + warp * 16 * kLdP + kk * 16, kLdP);
#pragma unroll
    for (int nf = 0; nf < kD / 16; ++nf) {
      FragC o;
      float* op = sO + warp * 16 * kLdO + nf * 16;
      wmma::load_matrix_sync(o, op, kLdO, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk) {
        FragBRow vb;
        wmma::load_matrix_sync(vb, sV + kk * 16 * kLdT + nf * 16, kLdT);
        wmma::mma_sync(o, pf[kk], vb, o);
      }
      wmma::store_matrix_sync(op, o, kLdO, wmma::mem_row_major);
    }
    __syncthreads();
  }

  if (tid < kTile) {
    const float l = l_run + (float)a.n_pad * expf(-1e30f - m_run);  // the JAX padding keys
    sAlpha[tid] = l == 0.f ? 1.f : 1.f / l;
  }
  __syncthreads();
  for (int e = tid; e < kTile * (kD / 8); e += kThreads) {
    const int r = e >> 4, dc = (e & 15) * 8;
    const int idx = q0 + r;
    if (idx >= a.S) continue;
    const bool keep = a.q_valid == nullptr || a.q_valid[(long)b * a.S + idx];
    Pack8 o;
#pragma unroll
    for (int j = 0; j < 8; ++j) o.h[j] = __float2bfloat16(keep ? sO[r * kLdO + dc + j] * sAlpha[r] : 0.f);
    *reinterpret_cast<uint4*>(a.o + (((long)b * a.S + idx) * a.H + h) * kD + dc) = o.u;
  }
}

}  // namespace seedvr2

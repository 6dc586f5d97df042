// K3: the DiT's fused window attention (qk rms-norm + RoPE + per-window
// text keys + masked softmax + PV), head-major.
//
// Replaces the Pallas kernel seedvr2_tpu/ops/fused_window_attention.py:
// fused_window_attention (_kernel, quant_qk=False). Per (batch, window,
// head) the query rows are the window's S video tokens followed by the Lt
// text tokens; the keys/values are [window video ; all text]; padded video
// slots (valid == 0) are masked out of the keys. Cast points follow the
// Pallas kernel: normalised q/k are rounded to bf16, roped in fp32 and
// rounded to bf16 again.
//
// What bounds it on the H100: a window's q, k and v in bf16 are
// 3 * (S+Lt) * 128 * 2 bytes (~355 KB at 3B 720p geometry, S=405, Lt=58),
// above the 227 KB of shared memory a block can have, so the TPU kernel's
// whole-window single pass does not fit. Design: one block per (b, window,
// head, 64-row query tile); the block streams 64-row key/value tiles with an
// online softmax in fp32, normalising and roping q/k as each tile is loaded
// (no normalised copy of q/k is written to memory). Q lives in registers as
// WMMA fragments, the fp32 output accumulator in shared memory (its rows are
// rescaled by the running-max correction each tile), so a block needs ~94 KB
// and two blocks fit on an SM. The text-output mean over windows stays
// outside, in fp32, as in the JAX model.
//
// K3q (template flag kQuant) replaces the same Pallas kernel with
// quant_qk=True, the attention_mode sageattn_2/3: after a q or k tile is
// normalised, roped and rounded to bf16, every row gets an fp32 scale
// s = max|x| * (1/127) + 1e-8 and int8 codes rint(x / s), computed as the
// tile loads (attn_quant_tile), in the Pallas kernel's op order with
// explicit round-to-nearest intrinsics so that no multiply-add is
// contracted and the codes match at ties. QK^T runs on the int8 tensor
// cores (WMMA 16x16x16 s8, int32 accumulation; |dot| <= 128 * 127^2 is
// exact in fp32) and the logit is float(dot) * (s_q * scale) * s_k. The Q
// codes stay in registers as int8 fragments and their scales in shared
// memory for the block; the code tiles and scales add 16.5 KB of shared
// memory, still two blocks per SM. Softmax and PV are those of K3, and so
// is what bounds it: the one-thread-per-row softmax, not the product.
#pragma once

#include "common.cuh"

namespace seedvr2 {

constexpr int kD = 128;        // head dim (3B and 7B)
constexpr int kTile = 64;      // query rows and key rows per tile
constexpr int kLdT = kD + 8;   // bf16 q/k/v tile row stride
constexpr int kLdO = kD + 4;   // fp32 output accumulator row stride
constexpr int kLdS = kTile + 4;
constexpr int kLdP = kTile + 8;
constexpr int kLdPart = 17;
constexpr int kOffK = 0;
constexpr int kOffV = kOffK + kTile * kLdT * 2;
constexpr int kOffO = kOffV + kTile * kLdT * 2;
constexpr int kOffS = kOffO + kTile * kLdO * 4;  // scores; doubles as rms partial sums
constexpr int kOffP = kOffS + kTile * kLdS * 4;
constexpr int kOffRow = kOffP + kTile * kLdP * 2;
constexpr int kAttnSmem = kOffRow + 3 * kTile * 4;
// K3q: int8 codes of the Q and K tiles, chunk-major [kD/16][kTile][16] so
// that every 16x16 fragment starts 32-byte aligned, then the row scales.
constexpr int kOffQ8 = kAttnSmem;
constexpr int kOffK8 = kOffQ8 + kTile * kD;
constexpr int kOffScale = kOffK8 + kTile * kD;
constexpr int kAttnSmemQ = kOffScale + 2 * kTile * 4;

using FragA8 = wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major>;
using FragB8 = wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::col_major>;
using FragCi = wmma::fragment<wmma::accumulator, 16, 16, 16, int>;

struct AttnArgs {
  const bf16* vqkv;    // [B, 3, H, nW, S, D]
  const bf16* tqkv;    // [B, 3, H, Lt, D]
  const float* vcos;   // [nW, S, D]
  const float* vsin;
  const float* tcos;   // [Lt, D]
  const float* tsin;
  const uint8_t* valid;  // [nW, S]
  const float* norms;  // [4, D]: q_vid, k_vid, q_txt, k_txt
  bf16* ovid;          // [B, H, nW, S, D]
  bf16* otxt;          // [B, H, nW, Lt, D]
  int H, nW, S, Lt;
  int rope_txt, qk_norm;
  float eps, scale;
};

// Rows [row0, row0 + 64) of q (kind 0), k (1) or v (2) of window w, head h,
// into dst (bf16, row stride kLdT). Row index i < S is video slot i, then
// text token i - S, then zero. q and k are rms-normalised and roped.
__device__ void attn_load_tile(const AttnArgs& a, bf16* dst, float* part, float* rstd, int kind,
                               int row0, int b, int h, int w) {
  const int tid = threadIdx.x;
  const int R = a.S + a.Lt;
  const bf16* vbase = a.vqkv + ((((long)b * 3 + kind) * a.H + h) * a.nW + w) * (long)a.S * kD;
  const bf16* tbase = a.tqkv + (((long)b * 3 + kind) * a.H + h) * (long)a.Lt * kD;
  Pack8 xv[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int e = tid + kThreads * k;
    const int r = e >> 4, dc = (e & 15) * 8;
    const int idx = row0 + r;
    xv[k].u = make_uint4(0u, 0u, 0u, 0u);
    if (idx < a.S)
      xv[k].u = *reinterpret_cast<const uint4*>(vbase + (long)idx * kD + dc);
    else if (idx < R)
      xv[k].u = *reinterpret_cast<const uint4*>(tbase + (long)(idx - a.S) * kD + dc);
    if (kind == 2) {
      *reinterpret_cast<uint4*>(dst + r * kLdT + dc) = xv[k].u;
    } else {
      float ss = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float x = __bfloat162float(xv[k].h[j]);
        ss += x * x;
      }
      part[r * kLdPart + (e & 15)] = ss;
    }
  }
  if (kind == 2) return;
  __syncthreads();
  if (tid < kTile) {
    float s = 0.f;
    for (int c = 0; c < 16; ++c) s += part[tid * kLdPart + c];
    rstd[tid] = a.qk_norm ? 1.0f / sqrtf(s / kD + a.eps) : 1.0f;
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int e = tid + kThreads * k;
    const int r = e >> 4, dc = (e & 15) * 8;
    const int idx = row0 + r;
    Pack8 o;
    o.u = make_uint4(0u, 0u, 0u, 0u);
    if (idx < R) {
      const bool txt = idx >= a.S;
      const float* nw = a.norms + (kind + (txt ? 2 : 0)) * kD + dc;
      const float rs = rstd[r];
      float nv[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float x = __bfloat162float(xv[k].h[j]);
        nv[j] = a.qk_norm ? round_bf16(x * rs * nw[j]) : x;
      }
      if (!txt || a.rope_txt) {
        const long off = txt ? (long)(idx - a.S) * kD + dc : ((long)w * a.S + idx) * kD + dc;
        const float* cs = (txt ? a.tcos : a.vcos) + off;
        const float* sn = (txt ? a.tsin : a.vsin) + off;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float rot = (j & 1) ? nv[j - 1] : -nv[j + 1];
          // separate roundings, as the plain version's multiply and add (no contracted FMA)
          o.h[j] = __float2bfloat16(__fadd_rn(__fmul_rn(nv[j], cs[j]), __fmul_rn(rot, sn[j])));
        }
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) o.h[j] = __float2bfloat16(nv[j]);
      }
    }
    *reinterpret_cast<uint4*>(dst + r * kLdT + dc) = o.u;
  }
}

// K3q: the 64-row bf16 tile src (row stride kLdT) -> per-row int8 codes in
// dst8 (chunk-major) and fp32 scales in scale[64]. Each thread owns the
// same eight 8-element pieces as in attn_load_tile. Ends synchronised.
__device__ void attn_quant_tile(const bf16* src, signed char* dst8, float* part, float* scale) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int e = tid + kThreads * k;
    const int r = e >> 4, dc = (e & 15) * 8;
    Pack8 x;
    x.u = *reinterpret_cast<const uint4*>(src + r * kLdT + dc);
    float m = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) m = fmaxf(m, fabsf(__bfloat162float(x.h[j])));
    part[r * kLdPart + (e & 15)] = m;
  }
  __syncthreads();
  if (tid < kTile) {
    float m = 0.f;
    for (int c = 0; c < 16; ++c) m = fmaxf(m, part[tid * kLdPart + c]);
    scale[tid] = __fadd_rn(__fmul_rn(m, (float)(1.0 / 127.0)), 1e-8f);
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int e = tid + kThreads * k;
    const int r = e >> 4, dc = (e & 15) * 8;
    Pack8 x;
    x.u = *reinterpret_cast<const uint4*>(src + r * kLdT + dc);
    const float sr = scale[r];
    union {
      uint2 u;
      signed char c[8];
    } q;
#pragma unroll
    for (int j = 0; j < 8; ++j) q.c[j] = (signed char)__float2int_rn(__fdiv_rn(__bfloat162float(x.h[j]), sr));
    *reinterpret_cast<uint2*>(dst8 + (dc >> 4) * (kTile * 16) + r * 16 + (dc & 15)) = q.u;
  }
  __syncthreads();
}

// grid = (ceil((S+Lt)/64), nW*H, B); dynamic shared memory kAttnSmem (K3)
// or kAttnSmemQ (K3q).
template <bool kQuant>
__global__ void __launch_bounds__(kThreads) window_attention_kernel(const AttnArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem + kOffK);
  bf16* sV = reinterpret_cast<bf16*>(smem + kOffV);
  float* sO = reinterpret_cast<float*>(smem + kOffO);
  float* sS = reinterpret_cast<float*>(smem + kOffS);
  bf16* sP = reinterpret_cast<bf16*>(smem + kOffP);
  float* sAlpha = reinterpret_cast<float*>(smem + kOffRow);
  float* sRstd = sAlpha + kTile;
  float* sKeyOk = sRstd + kTile;
  signed char* sQ8 = reinterpret_cast<signed char*>(smem + kOffQ8);  // K3q only
  signed char* sK8 = reinterpret_cast<signed char*>(smem + kOffK8);
  float* sQs = reinterpret_cast<float*>(smem + kOffScale);
  float* sKs = sQs + kTile;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int w = blockIdx.y / a.H, h = blockIdx.y - (blockIdx.y / a.H) * a.H;
  const int b = blockIdx.z;
  const int R = a.S + a.Lt;
  const int q0 = blockIdx.x * kTile;

  // Q tile: normalised and roped into sK, then held as fragments (K3) or as
  // int8 codes in sQ8 with row scales in sQs (K3q).
  attn_load_tile(a, sK, sS, sRstd, 0, q0, b, h, w);
  __syncthreads();
  FragA qf[kQuant ? 1 : kD / 16];
  FragA8 qf8[kQuant ? kD / 16 : 1];
  if constexpr (kQuant) {
    attn_quant_tile(sK, sQ8, sS, sQs);
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk)
      wmma::load_matrix_sync(qf8[kk], sQ8 + kk * (kTile * 16) + warp * 16 * 16, 16);
  } else {
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk)
      wmma::load_matrix_sync(qf[kk], sK + warp * 16 * kLdT + kk * 16, kLdT);
  }
  for (int e = tid; e < kTile * kLdO; e += kThreads) sO[e] = 0.f;
  float m_run = -1e30f, l_run = 0.f;  // row tid's running max and sum (tid < 64)
  const float q_scale = kQuant && tid < kTile ? __fmul_rn(sQs[tid], a.scale) : a.scale;
  __syncthreads();

  for (int j0 = 0; j0 < R; j0 += kTile) {
    attn_load_tile(a, sK, sS, sRstd, 1, j0, b, h, w);
    attn_load_tile(a, sV, sS, sRstd, 2, j0, b, h, w);
    if (tid < kTile) {
      const int key = j0 + tid;
      sKeyOk[tid] = key < a.S ? (a.valid[(long)w * a.S + key] ? 1.f : 0.f) : (key < R ? 1.f : 0.f);
    }
    __syncthreads();

    // scores: warp rows [16*warp, 16*warp+16) x 64 keys
    if constexpr (kQuant) {
      attn_quant_tile(sK, sK8, sS, sKs);
      int* sSi = reinterpret_cast<int*>(sS);
#pragma unroll
      for (int nf = 0; nf < kTile / 16; ++nf) {
        FragCi s;
        wmma::fill_fragment(s, 0);
#pragma unroll
        for (int kk = 0; kk < kD / 16; ++kk) {
          FragB8 kb;
          wmma::load_matrix_sync(kb, sK8 + kk * (kTile * 16) + nf * 16 * 16, 16);
          wmma::mma_sync(s, qf8[kk], kb, s);
        }
        wmma::store_matrix_sync(sSi + warp * 16 * kLdS + nf * 16, s, kLdS, wmma::mem_row_major);
      }
    } else {
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
    }
    __syncthreads();

    // online softmax, one thread per query row
    if (tid < kTile) {
      // K3: dot * scale; K3q: float(int dot) * (s_q * scale) * s_k
      auto logit = [&](int c) {
        if constexpr (kQuant)
          return __fmul_rn(__fmul_rn((float)reinterpret_cast<const int*>(sS)[tid * kLdS + c], q_scale), sKs[c]);
        else
          return sS[tid * kLdS + c] * q_scale;
      };
      float mx = m_run;
      for (int c = 0; c < kTile; ++c)
        if (sKeyOk[c] != 0.f) mx = fmaxf(mx, logit(c));
      const float alpha = expf(m_run - mx);
      float sum = 0.f;
      for (int c = 0; c < kTile; ++c) {
        const float p = sKeyOk[c] != 0.f ? expf(logit(c) - mx) : 0.f;
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
    for (int kk = 0; kk < kTile / 16; ++kk)
      wmma::load_matrix_sync(pf[kk], sP + warp * 16 * kLdP + kk * 16, kLdP);
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

  if (tid < kTile) sAlpha[tid] = l_run == 0.f ? 1.f : 1.f / l_run;
  __syncthreads();
  for (int e = tid; e < kTile * (kD / 8); e += kThreads) {
    const int r = e >> 4, dc = (e & 15) * 8;
    const int idx = q0 + r;
    if (idx >= R) continue;
    Pack8 o;
#pragma unroll
    for (int j = 0; j < 8; ++j) o.h[j] = __float2bfloat16(sO[r * kLdO + dc + j] * sAlpha[r]);
    const long bh = ((long)b * a.H + h) * a.nW + w;
    bf16* dst = idx < a.S ? a.ovid + (bh * a.S + idx) * kD + dc
                          : a.otxt + (bh * a.Lt + (idx - a.S)) * kD + dc;
    *reinterpret_cast<uint4*>(dst) = o.u;
  }
}

}  // namespace seedvr2

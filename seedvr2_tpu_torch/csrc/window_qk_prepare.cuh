// The first of K3's two kernels (window_attention.cuh has the note on the
// pair): every q and k row of the window attention rms-normalised and roped
// once, into scratch that the flash loop (attention_pipeline.cuh) reads by
// TMA; with K3q each row's int8 codes and fp32 scale instead.
//
// Replaces the preparation inside the Pallas kernel
// seedvr2_tpu/ops/fused_window_attention.py:_kernel (norm, _rotate and, with
// quant_qk, _quant), which the TPU kernel repeats per (window, head)
// program in VMEM. Op order and roundings are the Pallas kernel's: q/k
// normalised in fp32 (the sum of squares, then 1 / sqrt(ss / D + eps), then
// x * rs * w) and rounded to bf16, roped in fp32 with separate roundings
// (no contracted FMA, as the plain version's multiply and add) and rounded
// to bf16 again; K3q's scale is max|x| * (1/127) + 1e-8 (rounded product,
// rounded sum) and its codes rint(x / s) by __fdiv_rn and __float2int_rn,
// so that the codes match the plain version's at ties.
//
// What bounds it on the H100: bytes. It reads q and k (bf16) and the fp32
// cos/sin tables once and writes the prepared rows once: at 3B 720p (H 20,
// nW 18, S 405, Lt 58) ~75 MB read, ~75 MB written, ~7.5 MB of tables,
// ~0.047 ms at 3.35 TB/s; nothing is computed twice. Design: one block of
// 256 threads takes 64 rows of one (batch, window), or 64 text rows of one
// batch (blockIdx.y == nW), and kHeads heads: each thread keeps its quarter
// of the row's cos/sin in registers (four threads a row, thread q of them
// on the 8-element chunks q, q + 4, q + 8, q + 12), so a table row is read
// once for 2 kHeads rows; q and k of a head are loaded together (two rows
// in flight a thread). The head groups of a chunk are neighbouring blocks,
// so their table reads after the first come from L2 (all H heads a block
// gave one block an SM at 3B 720p, too few loads in flight). A text row is
// prepared once per (batch, head), not once per window. The rows of the
// last 64-row chunk past S (and past Lt) get
// their K3q scale 0, and the window's key codes (kcode: 0 for a video slot
// that holds a token, -inf otherwise, [nW, Sp]) and key-tile flags
// (tile_live: 1 when any of the 64 slots holds a token, [nW, Sp / 64]) are
// written by the batch-0 blocks of head group 0, so the flash loop reads
// whole 64-key chunks of the codes and scales by bulk copy and skips the
// key tiles that hold no token.
#pragma once

#include <math.h>

#include "common.cuh"

namespace seedvr2 {
namespace prep {

constexpr int kD = 128;       // head dim
constexpr int kRows = 64;     // rows a block (the flash loop's tile height)
constexpr int kThreads = 4 * kRows;
constexpr int kHeads = 4;     // heads a block

struct Args {
  const bf16* vqkv;     // [B, 3, H, nW, S, D]
  const bf16* tqkv;     // [B, 3, H, Lt, D]
  const float* vcos;    // [nW, S, D]
  const float* vsin;
  const float* tcos;    // [Lt, D] (read when rope_txt)
  const float* tsin;
  const uint8_t* valid; // [nW, S]
  const float* norms;   // [4, D]: q_vid, k_vid, q_txt, k_txt
  void* q_vid;          // [B, H, nW, S, D]: bf16 (K3) or int8 codes (K3q)
  void* k_vid;
  void* q_txt;          // [B, H, Lt, D]
  void* k_txt;
  float* qs_vid;        // K3q: [B, H, nW, Sp] row scales, 0 past S
  float* ks_vid;
  float* qs_txt;        // K3q: [B, H, Ltp], 0 past Lt
  float* ks_txt;
  float* kcode;         // [nW, Sp]: 0 (a key) or -inf (a padded slot, or past S)
  uint8_t* tile_live;   // [nW, Sp / kRows]: 1 when a 64-slot chunk holds a token
  int H, nW, S, Lt, Sp, Ltp, groups;  // groups: ceil(H / kHeads)
  int rope_txt, qk_norm;
  float eps;
};

// grid = (max(Sp, Ltp) / kRows * groups, nW + 1, B), kThreads threads;
// blockIdx.x is (chunk, head group), the group fastest. Every lane runs
// every iteration (the quad shuffles take the whole warp); rows past the
// end only skip their loads and stores.
template <bool kQuant>
__global__ void __launch_bounds__(kThreads, 2) qk_prepare_kernel(const Args a) {
  const bool txt = blockIdx.y == (unsigned)a.nW;
  const int w = blockIdx.y, b = blockIdx.z;
  const int chunk = blockIdx.x / a.groups, group = blockIdx.x - chunk * a.groups;
  const int q = threadIdx.x & 3;
  const int idx = chunk * kRows + (threadIdx.x >> 2);
  const int n = txt ? a.Lt : a.S, np = txt ? a.Ltp : a.Sp;
  if (chunk * kRows >= np) return;  // the whole block: no chunk of this kind here
  const bool live = idx < n;
  if (!txt && b == 0 && group == 0) {
    const bool key = live && a.valid[(long)w * a.S + idx] != 0;
    if (q == 0) a.kcode[(long)w * a.Sp + idx] = key ? 0.f : -INFINITY;
    const int any = __syncthreads_or(key);
    if (threadIdx.x == 0) a.tile_live[(long)w * (a.Sp / kRows) + chunk] = any != 0;
  }

  const bool rope = live && (!txt || a.rope_txt);
  float cv[4][8], sv[4][8];
  if (rope) {
    const long toff = txt ? (long)idx * kD : ((long)w * a.S + idx) * kD;
    const float* cs = (txt ? a.tcos : a.vcos) + toff;
    const float* sn = (txt ? a.tsin : a.vsin) + toff;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = (q + 4 * i) * 8;
      *reinterpret_cast<float4*>(cv[i]) = __ldg(reinterpret_cast<const float4*>(cs + c));
      *reinterpret_cast<float4*>(cv[i] + 4) = __ldg(reinterpret_cast<const float4*>(cs + c + 4));
      *reinterpret_cast<float4*>(sv[i]) = __ldg(reinterpret_cast<const float4*>(sn + c));
      *reinterpret_cast<float4*>(sv[i] + 4) = __ldg(reinterpret_cast<const float4*>(sn + c + 4));
    }
  }

  const int h_end = min(a.H, (group + 1) * kHeads);
  for (int h = group * kHeads; h < h_end; ++h) {
    // source and destination rows of q (kind 0) and k (1) of head h
    long src[2], dst[2];
#pragma unroll
    for (int kind = 0; kind < 2; ++kind) {
      src[kind] = txt ? ((((long)b * 3 + kind) * a.H + h) * a.Lt + idx) * kD
                      : (((((long)b * 3 + kind) * a.H + h) * a.nW + w) * a.S + idx) * kD;
      dst[kind] = txt ? (((long)b * a.H + h) * a.Lt + idx) * kD : ((((long)b * a.H + h) * a.nW + w) * a.S + idx) * kD;
    }
    Pack8 x[2][4];
#pragma unroll
    for (int kind = 0; kind < 2; ++kind)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        x[kind][i].u = live ? __ldg(reinterpret_cast<const uint4*>((txt ? a.tqkv : a.vqkv) + src[kind]) + q + 4 * i)
                            : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
    for (int kind = 0; kind < 2; ++kind) {
      float ss = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float f = __bfloat162float(x[kind][i].h[j]);
          ss += f * f;
        }
      ss = quad_sum(ss);
      const float rs = a.qk_norm ? 1.0f / sqrtf(ss / kD + a.eps) : 1.0f;
      const float* nw = a.norms + (kind + (txt ? 2 : 0)) * kD;
      Pack8 o[4];
      float amax = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = (q + 4 * i) * 8;
        float nwv[8];
        *reinterpret_cast<float4*>(nwv) = __ldg(reinterpret_cast<const float4*>(nw + c));
        *reinterpret_cast<float4*>(nwv + 4) = __ldg(reinterpret_cast<const float4*>(nw + c + 4));
        float nv[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float f = __bfloat162float(x[kind][i].h[j]);
          nv[j] = a.qk_norm ? round_bf16(f * rs * nwv[j]) : f;
        }
        if (rope) {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float rot = (j & 1) ? nv[j - 1] : -nv[j + 1];
            // separate roundings, as the plain version's multiply and add
            o[i].h[j] = __float2bfloat16(__fadd_rn(__fmul_rn(nv[j], cv[i][j]), __fmul_rn(rot, sv[i][j])));
          }
        } else {
#pragma unroll
          for (int j = 0; j < 8; ++j) o[i].h[j] = __float2bfloat16(live ? nv[j] : 0.f);
        }
        if constexpr (kQuant) {
#pragma unroll
          for (int j = 0; j < 8; ++j) amax = fmaxf(amax, fabsf(__bfloat162float(o[i].h[j])));
        }
      }
      void* out = kind == 0 ? (txt ? a.q_txt : a.q_vid) : (txt ? a.k_txt : a.k_vid);
      if constexpr (!kQuant) {
        if (live) {
          bf16* row = reinterpret_cast<bf16*>(out) + dst[kind];
#pragma unroll
          for (int i = 0; i < 4; ++i) *reinterpret_cast<uint4*>(row + (q + 4 * i) * 8) = o[i].u;
        }
      } else {
        const float sc = __fadd_rn(__fmul_rn(quad_max(amax), (float)(1.0 / 127.0)), 1e-8f);
        float* scales = kind == 0 ? (txt ? a.qs_txt : a.qs_vid) : (txt ? a.ks_txt : a.ks_vid);
        if (q == 0 && idx < np)
          scales[(txt ? (long)b * a.H + h : ((long)b * a.H + h) * a.nW + w) * np + idx] = live ? sc : 0.f;
        if (live) {
          signed char* row = reinterpret_cast<signed char*>(out) + dst[kind];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            union {
              uint2 u;
              signed char b[8];
            } code;
#pragma unroll
            for (int j = 0; j < 8; ++j)
              code.b[j] = (signed char)__float2int_rn(__fdiv_rn(__bfloat162float(o[i].h[j]), sc));
            *reinterpret_cast<uint2*>(row + (q + 4 * i) * 8) = code.u;
          }
        }
      }
    }
  }
}

}  // namespace prep
}  // namespace seedvr2

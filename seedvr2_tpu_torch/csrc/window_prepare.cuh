// K11: the operands of K5 for the DiT's unfused window attention ("pallas",
// attention_mode flash_attn_2 / 3), prepared in one pass.
//
// Not a TPU kernel: it replaces the unfused route's elementwise ops around
// the Pallas flash attention (seedvr2_tpu/models/dit/nadit.py:360
// _window_attention: the window gather, rms_norm of q and k, apply_rotary,
// the text appended to every window), which XLA fuses on the TPU and
// PyTorch runs as ~25 passes (fp32 copies of q and k among them). It reads
// the qkv projection's token-major output once through the plan's index and
// writes K5's bf16 q, k, v [B * per, mL + Lt, H, D] once: window w's video
// slots first (slot i holds token index[w * mL + i]; padding slots read the
// token their index names, as the gather does), then the Lt text rows.
//
// Op order and roundings are the route's (ops/window_prepare.py:
// window_prepare_plain): q/k normalised in fp32 (the sum of squares, then
// 1 / sqrt(ss / D + eps), then x * rs * w) and rounded to bf16, roped in
// fp32 with separate roundings (no contracted FMA, as the plain version's
// multiply and add) and rounded to bf16 again; text rows roped only with
// rope_txt; v copied. The sum of squares is the one value summed in another
// order than the plain version's reduction, so a bf16 code may move by one
// step where rs lands on the other side of a rounding boundary.
//
// What bounds it on the H100: bytes. At the 7B 1080p batch (latent 2 x 68 x
// 120, 58 text tokens, 24 heads) it reads q, k, v once (~0.30 GB) and the
// fp32 cos/sin tables (~0.02 GB), and writes the operands once (~0.43 GB):
// ~0.22 ms at 3.35 TB/s. Design (window_qk_prepare.cuh's, K3's first
// kernel): one block of 256 threads takes 64 operand rows of one (batch,
// window) and kHeads heads; four threads a row, thread q of them on the
// 8-element chunks q, q + 4, q + 8, q + 12 (16-byte loads and stores); a
// q/k block keeps its quarter of each row's cos/sin in registers across its
// heads, and the head groups of a chunk are neighbouring blocks, so their
// table reads after the first come from L2. Beside the 64 words of tables a
// thread holds one 16-word row at a time: q is loaded, prepared and stored,
// then k, each chunk stored when done, in the 128 registers that two blocks
// an SM leave (q and k loaded together spilled; one block an SM, or the
// tables read from L1 a head, ran 10-14% slower at the 7B's shapes). v is
// copied by blocks of its own (blockIdx.x's group >= groups), which need
// no tables. Text rows are normalised in each window's block from the text
// qkv (~1 MB, in L2): one block a (batch, head group) storing every
// window's copy would run per times longer than the others.
#pragma once

#include <math.h>

#include "common.cuh"

namespace seedvr2 {
namespace wprep {

constexpr int kD = 128;       // head dim
constexpr int kRows = 64;     // operand rows a block
constexpr int kThreads = 4 * kRows;
constexpr int kHeads = 4;     // heads a block

struct Args {
  const bf16* vqkv;      // [B, Lv, 3, H, D]: the qkv projection's output, token-major
  const bf16* tqkv;      // [B, Lt, 3, H, D]
  const int64_t* index;  // [per * mL]: the token of each window slot
  const float* vcos;     // [per, mL, D]
  const float* vsin;
  const float* tcos;     // [Lt, D] (read when rope_txt)
  const float* tsin;
  const float* norms;    // [4, D]: q_vid, k_vid, q_txt, k_txt
  bf16* out;             // [3, B * per, S, H, D]: q, k, v
  long plane;            // B * per * S * H * D: from q to k to v in out
  int Lv, H, per, mL, Lt, S, groups;  // S = mL + Lt; groups = ceil(H / kHeads)
  int rope_txt, qk_norm;
  float eps;
};

// grid = (ceil(S / kRows) * 2 * groups, per, B), kThreads threads;
// blockIdx.x is (chunk, role and head group), the group fastest: groups
// [0, groups) prepare q and k, [groups, 2 groups) copy v. Every lane runs
// every iteration (the quad shuffles take the whole warp); rows past S only
// skip their loads and stores.
__global__ void __launch_bounds__(kThreads, 2) window_prepare_kernel(const Args a) {
  const int w = blockIdx.y, b = blockIdx.z;
  const int chunk = blockIdx.x / (2 * a.groups);
  int group = blockIdx.x - chunk * 2 * a.groups;
  const bool copy_v = group >= a.groups;
  if (copy_v) group -= a.groups;
  const int q = threadIdx.x & 3;
  const int r = chunk * kRows + (threadIdx.x >> 2);
  const bool live = r < a.S;
  const bool txt = r >= a.mL;
  const int t = r - a.mL;
  const long row = 3L * a.H * kD;  // elements of one token's q, k, v
  long src = 0;
  if (live) src = txt ? ((long)b * a.Lt + t) * row : ((long)b * a.Lv + a.index[(long)w * a.mL + r]) * row;
  const bf16* in = (txt ? a.tqkv : a.vqkv) + src;
  bf16* dst = a.out + (((long)b * a.per + w) * a.S + r) * a.H * kD;
  const int h_end = min(a.H, (group + 1) * kHeads);

  if (copy_v) {
    if (!live) return;  // no shuffles on this path
    for (int h = group * kHeads; h < h_end; ++h) {
      const uint4* s = reinterpret_cast<const uint4*>(in + (2L * a.H + h) * kD);
      uint4* d = reinterpret_cast<uint4*>(dst + 2 * a.plane + (long)h * kD);
      uint4 v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) v[i] = __ldg(s + q + 4 * i);
#pragma unroll
      for (int i = 0; i < 4; ++i) d[q + 4 * i] = v[i];
    }
    return;
  }

  const bool rope = live && (!txt || a.rope_txt);
  float cv[4][8], sv[4][8];
  if (rope) {
    const long toff = txt ? (long)t * kD : ((long)w * a.mL + r) * kD;
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

  for (int h = group * kHeads; h < h_end; ++h) {
#pragma unroll 1
    for (int kind = 0; kind < 2; ++kind) {
      Pack8 x[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        x[i].u = live ? __ldg(reinterpret_cast<const uint4*>(in + ((long)kind * a.H + h) * kD) + q + 4 * i)
                      : make_uint4(0u, 0u, 0u, 0u);
      float ss = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float f = __bfloat162float(x[i].h[j]);
          ss = __fadd_rn(ss, __fmul_rn(f, f));  // rounded squares, as the plain version's x * x
        }
      ss = quad_sum(ss);
      const float rs = a.qk_norm ? 1.0f / sqrtf(ss / kD + a.eps) : 1.0f;
      const float* nw = a.norms + (kind + (txt ? 2 : 0)) * kD;
      uint4* d = reinterpret_cast<uint4*>(dst + kind * a.plane + (long)h * kD);
#pragma unroll
      for (int i = 0; i < 4; ++i) {  // each 8-element chunk stored as soon as it is done: fewer live registers
        const int c = (q + 4 * i) * 8;
        float nwv[8];
        *reinterpret_cast<float4*>(nwv) = __ldg(reinterpret_cast<const float4*>(nw + c));
        *reinterpret_cast<float4*>(nwv + 4) = __ldg(reinterpret_cast<const float4*>(nw + c + 4));
        float nv[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float f = __bfloat162float(x[i].h[j]);
          nv[j] = a.qk_norm ? round_bf16(__fmul_rn(__fmul_rn(f, rs), nwv[j])) : f;
        }
        Pack8 o;
        if (rope) {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float rot = (j & 1) ? nv[j - 1] : -nv[j + 1];
            // separate roundings, as the plain version's multiply and add
            o.h[j] = __float2bfloat16(__fadd_rn(__fmul_rn(nv[j], cv[i][j]), __fmul_rn(rot, sv[i][j])));
          }
        } else {
#pragma unroll
          for (int j = 0; j < 8; ++j) o.h[j] = __float2bfloat16(nv[j]);
        }
        if (live) d[q + 4 * i] = o.u;
      }
    }
  }
}

}  // namespace wprep
}  // namespace seedvr2

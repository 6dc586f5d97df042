// K3: the DiT's fused window attention (qk rms-norm + RoPE + per-window
// text keys + masked softmax + PV), head-major; K3q: the same with int8 q/k.
//
// Replaces the Pallas kernel seedvr2_tpu/ops/fused_window_attention.py:
// fused_window_attention (_kernel; quant_qk=True is K3q, the attention_mode
// sageattn_2/3). Per (batch, window, head) the query rows are the window's S
// video tokens followed by the Lt text tokens; the keys/values are [window
// video ; all text]; padded video slots (valid == 0) are masked out of the
// keys. Cast points follow the Pallas kernel: normalised q/k are rounded to
// bf16, roped in fp32 (separate roundings, no contracted FMA) and rounded
// to bf16 again. K3q then gives every q and k row an fp32 scale
// s = max|x| * (1/127) + 1e-8 and int8 codes rint(x / s), in the Pallas op
// order with explicit round-to-nearest intrinsics so that the codes match
// at ties; the logit is float(int dot) * (s_q * scale) * s_k
// (|dot| <= 128 * 127^2 is exact in fp32).
//
// What bounds it on the H100: a (window, head)'s q, k, v and outputs in
// bf16 are 4 * 463 * 256 bytes against 4 * 463^2 * 128 flops, ~230 flops a
// byte, under the card's ~295 for bf16, and the fp32 RoPE tables add
// bytes: the least time is set by the bytes. The kernel is ~8x that: it
// re-reads K, V and the tables once per 128-row query block (4 per window
// at R = 463) and normalises and ropes every K row there on the CUDA cores
// (~44% of its time on an H100, from a K3 head against a K5 head at the
// same R); the tensor cores and the softmax's exp2 take the rest.
// Design: the shared register-resident flash core (attention_core.cuh:
// mma.sync scores and O in registers, softmax by quad shuffles, cp.async
// double-buffered K/V); this policy loads raw rows from the video/text
// layout and, after each raw tile lands in shared memory, normalises and
// ropes it there cooperatively (4 threads a row, the rms sum by shuffles),
// and for K3q quantises it into int8 codes for the s8 mma. Nothing
// normalised is written to device memory, as in the TPU kernel. The
// text-output mean over windows stays outside, in fp32, as in the JAX model.
#pragma once

#include "attention_core.cuh"

namespace seedvr2 {

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

namespace attn {

// grid = (ceil((S + Lt) / kBM), nW * H, B)
template <bool kQuant_>
struct WindowPolicy {
  using Args = AttnArgs;
  static constexpr bool kQuant = kQuant_;
  static constexpr bool kPrepare = true;
  const AttnArgs a;  // a copy: the compiler reads its fields from the parameter space
  int b, w, h;

  __device__ explicit WindowPolicy(const AttnArgs& args)
      : a(args), b(blockIdx.z), w(blockIdx.y / args.H), h(blockIdx.y - (blockIdx.y / args.H) * args.H) {}

  __device__ int rows() const { return a.S + a.Lt; }
  __device__ float scale() const { return a.scale; }

  // row idx: video slot idx < S, then text token idx - S
  __device__ const bf16* row(int kind, int idx) const {
    if (idx < a.S) return a.vqkv + (((((long)b * 3 + kind) * a.H + h) * a.nW + w) * a.S + idx) * kD;
    return a.tqkv + ((((long)b * 3 + kind) * a.H + h) * a.Lt + (idx - a.S)) * kD;
  }

  __device__ float key_code(int key) const {
    const bool ok = key < a.S ? a.valid[(long)w * a.S + key] != 0 : key < rows();
    return ok ? 0.f : -INFINITY;  // text keys always count, so a row always has a key
  }

  __device__ float extra_den(float) const { return 0.f; }

  __device__ bf16* out_row(int idx) const {
    const long bh = ((long)b * a.H + h) * a.nW + w;
    return idx < a.S ? a.ovid + (bh * a.S + idx) * kD : a.otxt + (bh * a.Lt + (idx - a.S)) * kD;
  }

  __device__ bool keep(int) const { return true; }

  __device__ void prologue(float* norm_w) const {
    for (int e = threadIdx.x; e < 4 * kD; e += kThreads) norm_w[e] = a.norms[e];
  }

  // Rows [row0, row0 + n) of q (kind 0) or k (1), raw in buf (stride kLd),
  // normalised and roped in place; rows at or past S + Lt become zero. Four
  // threads a row, thread q of them on the 8-element chunks q, q+4, q+8,
  // q+12. With kQuant also each row's int8 codes into dst8 (stride kLd8)
  // and its scale into scale[row]. Reads the norm weights from norm_w.
  __device__ void prepare(bf16* buf, int n, int row0, int kind, signed char* dst8, float* scale_out,
                          const float* norm_w) const {
    const int q = threadIdx.x & 3;
    for (int r = threadIdx.x >> 2; r < n; r += kThreads / 4) {
      const int idx = row0 + r;
      bf16* rp = buf + r * kLd;
      Pack8 x[4];
      float ss = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        x[i].u = *reinterpret_cast<const uint4*>(rp + (q + 4 * i) * 8);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float f = __bfloat162float(x[i].h[j]);
          ss += f * f;
        }
      }
      ss = quad_sum(ss);
      const bool live = idx < rows();
      const bool txt = idx >= a.S;
      const float rs = a.qk_norm ? 1.0f / sqrtf(ss / kD + a.eps) : 1.0f;
      const float* nw = norm_w + (kind + (txt ? 2 : 0)) * kD;
      const bool rope = live && (!txt || a.rope_txt);
      const long toff = txt ? (long)(idx - a.S) * kD : ((long)w * a.S + idx) * kD;
      const float* cs = (txt ? a.tcos : a.vcos) + toff;
      const float* sn = (txt ? a.tsin : a.vsin) + toff;
      float amax = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = (q + 4 * i) * 8;
        float nv[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float f = __bfloat162float(x[i].h[j]);
          nv[j] = a.qk_norm ? round_bf16(f * rs * nw[c + j]) : f;
        }
        Pack8 o;
        if (rope) {
          float cv[8], sv[8];
          *reinterpret_cast<float4*>(cv) = __ldg(reinterpret_cast<const float4*>(cs + c));
          *reinterpret_cast<float4*>(cv + 4) = __ldg(reinterpret_cast<const float4*>(cs + c + 4));
          *reinterpret_cast<float4*>(sv) = __ldg(reinterpret_cast<const float4*>(sn + c));
          *reinterpret_cast<float4*>(sv + 4) = __ldg(reinterpret_cast<const float4*>(sn + c + 4));
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float rot = (j & 1) ? nv[j - 1] : -nv[j + 1];
            // separate roundings, as the plain version's multiply and add
            o.h[j] = __float2bfloat16(__fadd_rn(__fmul_rn(nv[j], cv[j]), __fmul_rn(rot, sv[j])));
          }
        } else {
#pragma unroll
          for (int j = 0; j < 8; ++j) o.h[j] = __float2bfloat16(live ? nv[j] : 0.f);
        }
        *reinterpret_cast<uint4*>(rp + c) = o.u;
        if constexpr (kQuant) {
#pragma unroll
          for (int j = 0; j < 8; ++j) amax = fmaxf(amax, fabsf(__bfloat162float(o.h[j])));
        }
      }
      if constexpr (kQuant) {
        const float sc = __fadd_rn(__fmul_rn(quad_max(amax), (float)(1.0 / 127.0)), 1e-8f);
        if (q == 0) scale_out[r] = sc;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int c = (q + 4 * i) * 8;
          Pack8 y;
          y.u = *reinterpret_cast<const uint4*>(rp + c);
          union {
            uint2 u;
            signed char b[8];
          } code;
#pragma unroll
          for (int j = 0; j < 8; ++j)
            code.b[j] = (signed char)__float2int_rn(__fdiv_rn(__bfloat162float(y.h[j]), sc));
          *reinterpret_cast<uint2*>(dst8 + r * kLd8 + c) = code.u;
        }
      }
    }
  }
};

}  // namespace attn
}  // namespace seedvr2

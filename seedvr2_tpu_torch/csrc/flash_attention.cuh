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
// the end instead of loading them. Masked keys keep their -1e30 logit
// through the online max, as in the JAX math, so a row whose keys are all
// masked comes out as sum(v) / Sp.
//
// What bounds it on the H100: at the DiT's shapes (S = 463, 7B: B*nW = 32,
// H = 24) a (b, h) does 4*S^2*D flops on 4*S*D*2 bytes of q, k, v and o,
// ~230 flops a byte, under the card's ~295 for bf16, so the least time is
// set by the bytes. The kernel reads K and V once per 128-row query block
// (4 per (b, h)), from L2 after the first, so the tensor cores and the
// softmax's exp2 on the CUDA cores are what it runs into. Design: the
// register-resident flash core (attention_core.cuh, now K5's alone) with a
// loader policy for the strided layout; no per-tile preparation.
#pragma once

#include "attention_core.cuh"

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

namespace attn {

// grid = (ceil(S / kBM), H, B)
struct FlashPolicy {
  using Args = FlashArgs;
  const FlashArgs a;  // a copy: the compiler reads its fields from the parameter space
  int b, h;

  __device__ explicit FlashPolicy(const FlashArgs& args) : a(args), b(blockIdx.z), h(blockIdx.y) {}

  __device__ int rows() const { return a.S; }
  __device__ float scale() const { return a.scale; }

  __device__ const bf16* row(int kind, int idx) const {
    const bf16* base = kind == 0 ? a.q : kind == 1 ? a.k : a.v;
    return base + (((long)b * a.S + idx) * a.H + h) * kD;
  }

  __device__ float key_code(int key) const {
    if (key >= a.S) return -INFINITY;
    return a.kv_valid[(long)b * a.S + key] ? 0.f : kMaskedL2;
  }

  // the JAX padding keys: n_pad terms exp(-1e30 - m), nonzero only when m is -1e30
  __device__ float extra_den(float m) const { return (float)a.n_pad * exp2f(kMaskedL2 - m); }

  __device__ bf16* out_row(int idx) const { return a.o + (((long)b * a.S + idx) * a.H + h) * kD; }

  __device__ bool keep(int idx) const { return a.q_valid == nullptr || a.q_valid[(long)b * a.S + idx]; }

};

}  // namespace attn
}  // namespace seedvr2

// Plain C entry points of K5 (flash_attention.cuh on attention_pipeline.cuh);
// see conv3d.cu for the conventions every entry follows. The three tensor
// maps hold the data pointers, so they are encoded on each call.
#include "flash_attention.cuh"

using namespace seedvr2;

namespace {

bool misaligned(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; }

}  // namespace

extern "C" {

int seedvr2_flash_attention(const void* q, const void* k, const void* v, const void* kv_valid,
                            const void* q_valid, void* o, int B, int S, int H, int n_pad,
                            float scale, void* stream) {
  if (B < 1 || S < 1 || H < 1 || kv_valid == nullptr || misaligned(q) || misaligned(k) || misaligned(v) ||
      misaligned(o))
    return (int)cudaErrorInvalidValue;
  masked::FlashTiles p;
  p.B = B;
  p.S = S;
  p.H = H;
  p.nqb = (S + 127) / 128;
  p.nk = (S + flash::kBN - 1) / flash::kBN;
  p.n_pad = n_pad;
  p.scale = scale;
  p.kv_valid = (const uint8_t*)kv_valid;
  p.q_valid = (const uint8_t*)q_valid;
  p.o = (bf16*)o;
  return masked::launch(p, q, k, v, (cudaStream_t)stream);
}

int seedvr2_flash_attention_attributes(int* regs, int* local_bytes, int* smem_bytes) {
  return masked::attributes(regs, local_bytes, smem_bytes);
}

}  // extern "C"

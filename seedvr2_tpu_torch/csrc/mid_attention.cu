// Plain C entry points of K10 (mid_attention.cuh); see conv3d.cu for the
// conventions every entry follows. The three tensor maps hold the data
// pointers, so they are encoded on each call.
#include "mid_attention.cuh"

using namespace seedvr2;

namespace {

bool misaligned(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; }

}  // namespace

extern "C" {

// q, k, v, o [F, n, C] bf16, contiguous, 16-byte aligned; C = 512 or 256;
// scale 1 / sqrt(C).
int seedvr2_mid_attention(const void* q, const void* k, const void* v, void* o, int F, int n, int C, float scale,
                          void* stream) {
  if (F < 1 || n < 1 || misaligned(q) || misaligned(k) || misaligned(v) || misaligned(o))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (C == 512) return midattn::launch<512>(q, k, v, o, F, n, scale, s);
  if (C == 256) return midattn::launch<256>(q, k, v, o, F, n, scale, s);
  return (int)cudaErrorInvalidValue;
}

int seedvr2_mid_attention_attributes(int C, int* regs, int* local_bytes, int* smem_bytes) {
  if (C == 512) return midattn::attributes<512>(regs, local_bytes, smem_bytes);
  if (C == 256) return midattn::attributes<256>(regs, local_bytes, smem_bytes);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"

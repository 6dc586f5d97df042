// Plain C entry point of K11, the unfused window attention's operand
// preparation (window_prepare.cuh); see conv3d.cu for the conventions every
// entry follows.
#include "window_prepare.cuh"

using namespace seedvr2;

namespace {

bool misaligned(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; }

}  // namespace

extern "C" {

int seedvr2_window_prepare(const void* vqkv, const void* tqkv, const void* index, const void* vcos,
                           const void* vsin, const void* tcos, const void* tsin, const void* norms, void* out,
                           int B, int Lv, int H, int per, int mL, int Lt, int rope_txt, int qk_norm, float eps,
                           void* stream) {
  if (B < 1 || Lv < 1 || H < 1 || per < 1 || mL < 1 || Lt < 0 || misaligned(vqkv) || misaligned(tqkv) ||
      misaligned(vcos) || misaligned(vsin) || misaligned(tcos) || misaligned(tsin) || misaligned(norms) ||
      misaligned(out))
    return (int)cudaErrorInvalidValue;
  wprep::Args a;
  a.vqkv = (const bf16*)vqkv;
  a.tqkv = (const bf16*)tqkv;
  a.index = (const int64_t*)index;
  a.vcos = (const float*)vcos;
  a.vsin = (const float*)vsin;
  a.tcos = (const float*)tcos;
  a.tsin = (const float*)tsin;
  a.norms = (const float*)norms;
  a.out = (bf16*)out;
  a.Lv = Lv;
  a.H = H;
  a.per = per;
  a.mL = mL;
  a.Lt = Lt;
  a.S = mL + Lt;
  a.groups = (H + wprep::kHeads - 1) / wprep::kHeads;
  a.plane = (long)B * per * a.S * H * wprep::kD;
  a.rope_txt = rope_txt;
  a.qk_norm = qk_norm;
  a.eps = eps;
  const dim3 grid((a.S + wprep::kRows - 1) / wprep::kRows * 2 * a.groups, per, B);
  wprep::window_prepare_kernel<<<grid, wprep::kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"

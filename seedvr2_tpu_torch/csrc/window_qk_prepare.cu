// Plain C entry point of K3's q/k preparation (window_qk_prepare.cuh); see
// conv3d.cu for the conventions every entry follows.
#include "window_qk_prepare.cuh"

using namespace seedvr2;

extern "C" {

int seedvr2_window_qk_prepare(const void* vqkv, const void* tqkv, const void* vcos, const void* vsin,
                              const void* tcos, const void* tsin, const void* valid, const void* norms, void* q_vid,
                              void* k_vid, void* q_txt, void* k_txt, void* qs_vid, void* ks_vid, void* qs_txt,
                              void* ks_txt, void* kcode, void* tile_live, int B, int H, int nW, int S, int Lt,
                              int rope_txt, int qk_norm, int quant_qk, float eps, void* stream) {
  prep::Args a;
  a.vqkv = (const bf16*)vqkv;
  a.tqkv = (const bf16*)tqkv;
  a.vcos = (const float*)vcos;
  a.vsin = (const float*)vsin;
  a.tcos = (const float*)tcos;
  a.tsin = (const float*)tsin;
  a.valid = (const uint8_t*)valid;
  a.norms = (const float*)norms;
  a.q_vid = q_vid;
  a.k_vid = k_vid;
  a.q_txt = q_txt;
  a.k_txt = k_txt;
  a.qs_vid = (float*)qs_vid;
  a.ks_vid = (float*)ks_vid;
  a.qs_txt = (float*)qs_txt;
  a.ks_txt = (float*)ks_txt;
  a.kcode = (float*)kcode;
  a.tile_live = (uint8_t*)tile_live;
  a.H = H;
  a.nW = nW;
  a.S = S;
  a.Lt = Lt;
  a.Sp = (S + prep::kRows - 1) / prep::kRows * prep::kRows;
  a.Ltp = (Lt + prep::kRows - 1) / prep::kRows * prep::kRows;
  a.groups = (H + prep::kHeads - 1) / prep::kHeads;
  a.rope_txt = rope_txt;
  a.qk_norm = qk_norm;
  a.eps = eps;
  const int chunks = (a.Sp > a.Ltp ? a.Sp : a.Ltp) / prep::kRows;
  const dim3 grid(chunks * a.groups, nW + 1, B);
  if (quant_qk)
    prep::qk_prepare_kernel<true><<<grid, prep::kThreads, 0, (cudaStream_t)stream>>>(a);
  else
    prep::qk_prepare_kernel<false><<<grid, prep::kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"

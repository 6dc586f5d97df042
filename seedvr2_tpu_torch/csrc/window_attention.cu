// Plain C entry points of K3 / K3q's flash loop (window_attention.cuh on
// attention_pipeline.cuh); the preparation that runs before it is
// window_qk_prepare.cu's. See conv3d.cu for the conventions every entry
// follows; the six tensor maps hold the data pointers, so they are encoded
// on each call.
#include "window_attention.cuh"

using namespace seedvr2;

namespace {

bool misaligned(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; }

}  // namespace

extern "C" {

int seedvr2_window_flash(const void* vqkv, const void* tqkv, const void* q_vid, const void* k_vid, const void* q_txt,
                         const void* k_txt, const void* qs_vid, const void* ks_vid, const void* qs_txt,
                         const void* ks_txt, const void* kcode, const void* tile_live, void* ovid, void* otxt, int B,
                         int H, int nW, int S, int Lt, int quant_qk, float scale, void* stream) {
  if (B < 1 || H < 1 || nW < 1 || S < 1 || Lt < 1 || misaligned(vqkv) || misaligned(tqkv) || misaligned(q_vid) ||
      misaligned(k_vid) || misaligned(q_txt) || misaligned(k_txt) || misaligned(kcode) ||
      (quant_qk && (misaligned(qs_vid) || misaligned(ks_vid) || misaligned(qs_txt) || misaligned(ks_txt))))
    return (int)cudaErrorInvalidValue;
  const int nvt = (S + flash::kBN - 1) / flash::kBN, ntt = (Lt + flash::kBN - 1) / flash::kBN;
  const auto fill = [&](auto& p) {
    p.B = B;
    p.H = H;
    p.nW = nW;
    p.S = S;
    p.Lt = Lt;
    p.Sp = nvt * flash::kBN;
    p.Ltp = ntt * flash::kBN;
    p.nvt = nvt;
    p.ntt = ntt;
    p.npairs = (nvt + ntt + 1) / 2;
    p.scale = scale;
    p.kcode = (const float*)kcode;
    p.tile_live = (const uint8_t*)tile_live;
    p.qs_vid = (const float*)qs_vid;
    p.ks_vid = (const float*)ks_vid;
    p.qs_txt = (const float*)qs_txt;
    p.ks_txt = (const float*)ks_txt;
    p.ovid = (bf16*)ovid;
    p.otxt = (bf16*)otxt;
  };
  if (quant_qk) {
    window::WindowTiles<true> p;
    fill(p);
    return window::launch(p, vqkv, tqkv, q_vid, k_vid, q_txt, k_txt, (cudaStream_t)stream);
  }
  window::WindowTiles<false> p;
  fill(p);
  return window::launch(p, vqkv, tqkv, q_vid, k_vid, q_txt, k_txt, (cudaStream_t)stream);
}

int seedvr2_window_flash_attributes(int quant_qk, int* regs, int* local_bytes, int* smem_bytes) {
  return quant_qk ? window::attributes<true>(regs, local_bytes, smem_bytes)
                  : window::attributes<false>(regs, local_bytes, smem_bytes);
}

}  // extern "C"

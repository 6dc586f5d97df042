// Plain C entry points of the hand-written kernels, loaded from Python with
// ctypes (seedvr2_tpu_torch/ops/cuda_lib.py). Each entry launches on the
// caller's stream, allocates nothing and returns cudaGetLastError() right
// after the launch so a refused launch is reported to the caller.
#include "conv3d.cuh"
#include "flash_attention.cuh"
#include "fold_upsample.cuh"
#include "window_attention.cuh"

using namespace seedvr2;

extern "C" {

const char* seedvr2_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

int seedvr2_conv3d_3x3x3(const void* x, const void* w, const void* bias, void* y, int B, int T,
                         int H, int W, int cin, int cout, void* stream) {
  const dim3 grid((H * W + kBM - 1) / kBM, cout / kBN, B * T);
  conv3d_3x3x3_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const bf16*)x, (const bf16*)w, (const float*)bias, (bf16*)y, T, H, W, cin, cout);
  return (int)cudaGetLastError();
}

int seedvr2_fold_upsample(const void* x, const void* K, const void* btab, const void* bc, void* y,
                          int B, int Tp, int kt, int A, int H, int W, int C, void* stream) {
  const dim3 grid((H * W + kBM - 1) / kBM, C / kBN, B * Tp * A * 4);
  fold_upsample_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const bf16*)x, (const bf16*)K, (const float*)btab, (const float*)bc, (bf16*)y, Tp, kt, A, H,
      W, C);
  return (int)cudaGetLastError();
}

int seedvr2_window_attention(const void* vqkv, const void* tqkv, const void* vcos,
                             const void* vsin, const void* tcos, const void* tsin,
                             const void* valid, const void* norms, void* ovid, void* otxt, int B,
                             int H, int nW, int S, int Lt, int rope_txt, int qk_norm, int quant_qk,
                             float eps, float scale, void* stream) {
  // above 48 KB of dynamic shared memory needs an opt-in (per device, so per call)
  const auto kernel = quant_qk ? window_attention_kernel<true> : window_attention_kernel<false>;
  const int smem = quant_qk ? kAttnSmemQ : kAttnSmem;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  AttnArgs a;
  a.vqkv = (const bf16*)vqkv;
  a.tqkv = (const bf16*)tqkv;
  a.vcos = (const float*)vcos;
  a.vsin = (const float*)vsin;
  a.tcos = (const float*)tcos;
  a.tsin = (const float*)tsin;
  a.valid = (const uint8_t*)valid;
  a.norms = (const float*)norms;
  a.ovid = (bf16*)ovid;
  a.otxt = (bf16*)otxt;
  a.H = H;
  a.nW = nW;
  a.S = S;
  a.Lt = Lt;
  a.rope_txt = rope_txt;
  a.qk_norm = qk_norm;
  a.eps = eps;
  a.scale = scale;
  const dim3 grid((S + Lt + kTile - 1) / kTile, nW * H, B);
  kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

int seedvr2_flash_attention(const void* q, const void* k, const void* v, const void* kv_valid,
                            const void* q_valid, void* o, int B, int S, int H, int n_pad,
                            float scale, void* stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kAttnSmem);
  if (err != cudaSuccess) return (int)err;
  FlashArgs a;
  a.q = (const bf16*)q;
  a.k = (const bf16*)k;
  a.v = (const bf16*)v;
  a.kv_valid = (const uint8_t*)kv_valid;
  a.q_valid = (const uint8_t*)q_valid;
  a.o = (bf16*)o;
  a.S = S;
  a.H = H;
  a.n_pad = n_pad;
  a.scale = scale;
  const dim3 grid((S + kTile - 1) / kTile, H, B);
  flash_attention_kernel<<<grid, kThreads, kAttnSmem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"

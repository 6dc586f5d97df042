// Plain C entry points of K7 (w8a16_linear.cuh), one a regime; see conv3d.cu
// for the conventions every entry follows. The video regime's two tensor
// maps hold the data pointers, so they are encoded on each call, as K6's;
// a failed encode returns kEncodeError + its CUresult (ops/cuda_lib.py
// raises on it).
#include "w8a16_linear.cuh"

using namespace seedvr2;

namespace {

constexpr int kEncodeError = 1 << 20;
constexpr int kMaxDevices = 64;

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// Once per device: the shared-memory opt-ins above 48 KB; the SM count.
cudaError_t device_setup(int* sms) {
  static int sm_count[kMaxDevices] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (sm_count[dev] == 0) {
    err = cudaFuncSetAttribute(w8a16::video::w8a16_video_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               w8a16::video::kSmemBytes);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(w8a16::text::w8a16_splitk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 w8a16::text::kSmemBytes);
    int n = 0;
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    sm_count[dev] = n;
  }
  *sms = sm_count[dev];
  return cudaSuccess;
}

}  // namespace

extern "C" {

// The video regime (wgmma): any 0 < M < 2^31 (the wrapper takes it for M >
// 64); N % 64 == 0, K % 64 == 0; x and w 16-byte aligned; bias may be null.
int seedvr2_w8a16_linear(const void* x, const void* w, const void* scale, const void* bias, void* y, int M, int N,
                         int K, void* stream) {
  using namespace w8a16::video;
  if (M < 1 || N < 64 || K < 64 || N % 64 != 0 || K % w8a16::kBK != 0 || !aligned16(x) || !aligned16(w))
    return (int)cudaErrorInvalidValue;
  const w8a16::Args a{(const bf16*)x, (const int8_t*)w, (const float*)scale, (const bf16*)bias, (bf16*)y, M, N, K};
  Grid gr{(M + kBM - 1) / kBM, (N + kBN - 1) / kBN, 0};
  const long tiles = (long)gr.tiles_m * gr.tiles_n;
  if (tiles > 0x7fffffff) return (int)cudaErrorInvalidValue;
  gr.num_tiles = (int)tiles;
  int sms = 0;
  cudaError_t err = device_setup(&sms);
  if (err != cudaSuccess) return (int)err;
  const auto encode = sm90::tensor_map_encoder(&err);
  if (encode == nullptr) return (int)err;

  CUtensorMap tmx, tmw;
  const cuuint32_t ones[2] = {1, 1};
  const cuuint64_t xdim[2] = {(cuuint64_t)K, (cuuint64_t)M}, xstride[1] = {(cuuint64_t)K * 2};
  const cuuint32_t xbox[2] = {(cuuint32_t)w8a16::kBK, (cuuint32_t)kBM};
  CUresult r = encode(&tmx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(x), xdim, xstride, xbox, ones,
                      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);  // NONE fills zeros
  if (r != CUDA_SUCCESS) return kEncodeError + (int)r;
  const cuuint64_t wdim[2] = {(cuuint64_t)K, (cuuint64_t)N}, wstride[1] = {(cuuint64_t)K};
  const cuuint32_t wbox[2] = {(cuuint32_t)w8a16::kBK, (cuuint32_t)kBN};
  r = encode(&tmw, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(w), wdim, wstride, wbox, ones,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return kEncodeError + (int)r;

  const int grid = gr.num_tiles < sms ? gr.num_tiles : sms;
  w8a16_video_kernel<<<grid, kThreads, kSmemBytes, (cudaStream_t)stream>>>(tmx, tmw, a, gr);
  return (int)cudaGetLastError();
}

// The text regime's K splits for a weight [N, K] on the current device: the
// fewest that give N / kBN x splits >= kBlocksPerSM x the SM count, at most
// one a 64-deep k step. The wrapper sizes the workspace by it.
int seedvr2_w8a16_splitk_splits(int N, int K, int* splits) {
  using namespace w8a16::text;
  if (N < 64 || K < 64 || N % 64 != 0 || K % w8a16::kBK != 0) return (int)cudaErrorInvalidValue;
  int sms = 0;
  const cudaError_t err = device_setup(&sms);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (N + kBN - 1) / kBN;
  const int want = (kBlocksPerSM * sms + tiles - 1) / tiles, steps = K / w8a16::kBK;
  const int most = steps < 65535 ? steps : 65535;  // gridDim.y
  *splits = want < most ? want : most;
  return 0;
}

// The text regime (split-K): 0 < M <= 64, N % 64 == 0, K % 64 == 0, 0 <
// splits <= K / 64; part is an fp32 workspace of splits * M * N; bias may
// be null. Two launches: the partial products, then their sum in split
// order with the scale and the bias.
int seedvr2_w8a16_linear_splitk(const void* x, const void* w, const void* scale, const void* bias, void* y,
                                void* part, int M, int N, int K, int splits, void* stream) {
  using namespace w8a16::text;
  if (M < 1 || M > w8a16::kTextRows || N < 64 || K < 64 || N % 64 != 0 || K % w8a16::kBK != 0 || splits < 1 ||
      splits > K / w8a16::kBK || splits > 65535 || !aligned16(x) || !aligned16(w) || !aligned16(scale) ||
      !aligned16(part))
    return (int)cudaErrorInvalidValue;
  const w8a16::Args a{(const bf16*)x, (const int8_t*)w, (const float*)scale, (const bf16*)bias, (bf16*)y, M, N, K};
  int sms = 0;
  cudaError_t err = device_setup(&sms);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + kBN - 1) / kBN, splits);
  w8a16_splitk_kernel<<<grid, kThreads, kSmemBytes, (cudaStream_t)stream>>>(a, (float*)part, splits);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const long quads = (long)M * N / 4;
  w8a16_splitk_reduce_kernel<<<(unsigned)((quads + kReduceThreads - 1) / kReduceThreads), kReduceThreads, 0,
                               (cudaStream_t)stream>>>(a, (const float*)part, splits);
  return (int)cudaGetLastError();
}

}  // extern "C"

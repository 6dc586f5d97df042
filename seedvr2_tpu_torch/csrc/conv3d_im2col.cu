// Plain C entry point of K6 (conv3d_im2col.cuh); see conv3d.cu for the
// conventions every entry follows. The two tensor maps hold the data
// pointers, so they are encoded on each call (microseconds), by
// cuTensorMapEncodeTiled (hopper.cuh:tensor_map_encoder). A failed encode returns
// kEncodeError + its CUresult (ops/cuda_lib.py raises on it).
#include "conv3d_im2col.cuh"

using namespace seedvr2;

namespace {

constexpr int kEncodeError = 1 << 20;  // + CUresult of a failed cuTensorMapEncodeTiled
constexpr int kMaxDevices = 64;

// The patch (ph, pw), ph * pw == 256, with the fewest tiles over H x W;
// ties go to the first, the squarest (the smallest slab).
void pick_patch(int H, int W, int* ph, int* pw) {
  static const int kPatches[3][2] = {{16, 16}, {8, 32}, {4, 64}};
  long best = -1;
  for (const auto& p : kPatches) {
    const long n = (long)((H + p[0] - 1) / p[0]) * ((W + p[1] - 1) / p[1]);
    if (best < 0 || n < best) {
      best = n;
      *ph = p[0];
      *pw = p[1];
    }
  }
}

}  // namespace

extern "C" {

// x [B, T+2, H, W, cin], wf [27*cin, cout] bf16, 16-byte aligned (TMA);
// cin % 64 == 0, cout % 128 == 0.
int seedvr2_conv3d_im2col(const void* x, const void* wf, const void* bias, void* y, int B, int T, int H, int W,
                          int cin, int cout, void* stream) {
  using namespace im2col;
  if (B < 1 || T < 1 || H < 1 || W < 1 || cin % kBK != 0 || cout % kBN != 0 ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(wf)) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSuccess;
  const auto encode = sm90::tensor_map_encoder(&err);
  if (encode == nullptr) return (int)err;

  Args a{(const float*)bias, (bf16*)y, T, H, W, cin, cout, 0, 0, 0, 0, 0, 0};
  pick_patch(H, W, &a.ph, &a.pw);
  a.tiles_h = (H + a.ph - 1) / a.ph;
  a.tiles_w = (W + a.pw - 1) / a.pw;
  a.tiles_n = cout / kBN;
  const long tiles = (long)B * T * a.tiles_h * a.tiles_w * a.tiles_n;
  if (tiles > 0x7fffffff) return (int)cudaErrorInvalidValue;
  a.num_tiles = (int)tiles;

  const cuuint64_t e = 2;  // bytes of a bf16
  CUtensorMap tmx, tmw;
  const cuuint64_t xdim[5] = {(cuuint64_t)cin, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)T + 2, (cuuint64_t)B};
  const cuuint64_t xstride[4] = {cin * e, (cuuint64_t)W * cin * e, (cuuint64_t)H * W * cin * e,
                                 (cuuint64_t)(T + 2) * H * W * cin * e};
  const cuuint32_t xbox[5] = {(cuuint32_t)kBK, (cuuint32_t)a.pw + 8, (cuuint32_t)a.ph + 2, 1, 1};  // the slab
  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  CUresult r = encode(&tmx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, const_cast<void*>(x), xdim, xstride, xbox, ones,
                      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);  // NONE fills zeros (NAN_REQUEST_ZERO_FMA gives NaN)
  if (r != CUDA_SUCCESS) return kEncodeError + (int)r;
  const cuuint64_t wdim[2] = {(cuuint64_t)cout, (cuuint64_t)27 * cin};
  const cuuint64_t wstride[1] = {cout * e};
  const cuuint32_t wbox[2] = {64, (cuuint32_t)kBK};
  r = encode(&tmw, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(wf), wdim, wstride, wbox, ones,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return kEncodeError + (int)r;

  // once per device: the shared-memory opt-in above 48 KB, and the SM count
  static int sms[kMaxDevices] = {0};
  int dev = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (sms[dev] == 0) {
    err = cudaFuncSetAttribute(conv3d_im2col_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    int n = 0;
    if ((err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return (int)err;
    sms[dev] = n;
  }
  const int grid = a.num_tiles < sms[dev] ? a.num_tiles : sms[dev];
  conv3d_im2col_kernel<<<grid, kThreads, kSmemBytes, (cudaStream_t)stream>>>(tmx, tmw, a);
  return (int)cudaGetLastError();
}

// What the runtime holds for the kernel: registers a thread, local memory
// (spills) a thread, and the dynamic shared memory it launches with.
int seedvr2_conv3d_im2col_attributes(int* regs, int* local_bytes, int* smem_bytes) {
  cudaFuncAttributes f;
  const cudaError_t err = cudaFuncGetAttributes(&f, im2col::conv3d_im2col_kernel);
  if (err != cudaSuccess) return (int)err;
  *regs = f.numRegs;
  *local_bytes = (int)f.localSizeBytes;
  *smem_bytes = im2col::kSmemBytes;
  return 0;
}

}  // extern "C"

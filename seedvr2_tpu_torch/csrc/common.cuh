// Shared pieces of the hand-written Hopper kernels: bf16 helpers, and the
// WMMA fragment types and 64 x 64 implicit-GEMM tile of K6
// (conv3d_im2col.cuh) alone, which runs 128 threads (4 warps) per block
// through nvcuda::wmma (16x16x16, fp32 accumulation) with synchronous
// 16-byte loads into shared memory.
//
// K1/K4 and K2 have their own core (conv_core.cuh) and the attention
// kernels theirs (attention_core.cuh), both on the inline PTX of ptx.cuh:
// mma.sync fragments in registers, ldmatrix operands, cp.async rings.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace seedvr2 {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

constexpr int kThreads = 128;

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragBRow = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// Eight bf16 values moved as one 16-byte word.
union Pack8 {
  uint4 u;
  bf16 h[8];
};

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// ---------------------------------------------------------------------------
// The WMMA implicit-GEMM tile of K6 (conv3d_im2col.cuh), its only user:
// a 64 x 64 output tile on 4 warps, spilled to shared memory (row stride
// kLdC) for the epilogue.
// ---------------------------------------------------------------------------
constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kLdC = kBN + 4;   // fp32 elements
constexpr int kTileCBytes = kBM * kLdC * 4;

// Spill the 64x64 fp32 tile to shared memory (row stride kLdC) so the
// epilogue can address it by (pixel, channel).
__device__ __forceinline__ void igemm_store_c(FragC (&acc)[2][2], float* sc) {
  const int warp = threadIdx.x >> 5;
  const int wm = warp >> 1, wn = warp & 1;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 2; ++ni)
      wmma::store_matrix_sync(sc + (wm * 32 + mi * 16) * kLdC + wn * 32 + ni * 16, acc[mi][ni],
                              kLdC, wmma::mem_row_major);
  __syncthreads();
}

__device__ __forceinline__ void igemm_zero(FragC (&acc)[2][2]) {
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 2; ++ni) wmma::fill_fragment(acc[mi][ni], 0.0f);
}

}  // namespace seedvr2

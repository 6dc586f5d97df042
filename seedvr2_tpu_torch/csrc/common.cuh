// Shared pieces of the hand-written Hopper kernels: bf16 helpers, the WMMA
// fragment types and the implicit-GEMM tile that the VAE convolutions
// (conv3d.cuh, conv3d_im2col.cuh, fold_upsample.cuh) are built on.
//
// The convolutions run 128 threads (4 warps) per block and multiply bf16
// tiles on the tensor cores through nvcuda::wmma (16x16x16, fp32
// accumulation), with synchronous 16-byte loads into shared memory: no
// cp.async/TMA pipeline and no wgmma yet. The attention kernels have their
// own core (attention_core.cuh, on the inline PTX of ptx.cuh).
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
using FragBCol = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
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
// Implicit-GEMM tile: out[BM pixels, BN channels] = sum over taps of
// A_tap[BM, Cin] @ W_tap[Cin, BN]. A_tap rows are input pixels gathered by
// the caller (a null pointer reads as zero, which is how spatial padding and
// the ragged last tile are handled: no padded copy of the input exists).
// ---------------------------------------------------------------------------
constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 32;
constexpr int kLdA = kBK + 8;   // bf16 elements; +8 staggers banks
constexpr int kLdB = kBN + 8;
constexpr int kLdC = kBN + 4;   // fp32 elements
constexpr int kTileABytes = kBM * kLdA * 2;
constexpr int kTileBBytes = kBK * kLdB * 2;
constexpr int kTileCBytes = kBM * kLdC * 4;
constexpr int kIgemmSmem = kTileCBytes > kTileABytes + kTileBBytes ? kTileCBytes
                                                                   : kTileABytes + kTileBBytes;

// Rows of the A tile this thread loads: rows (tid >> 2) and (tid >> 2) + 32,
// each as 16-byte chunk (tid & 3) of the 32-channel slice.
__device__ __forceinline__ int igemm_a_row(int i) { return (threadIdx.x >> 2) + 32 * i; }

// One tap: accumulate A[BM, cin] (rows src[0..1] for this thread's two rows,
// null = zero row) times W[cin, BN] (row stride ldw) into the warp's 2x2
// fragments. The block covers a 64x64 output tile; warp (wm, wn) owns the
// 32x32 quarter at (32*wm, 32*wn).
__device__ __forceinline__ void igemm_tap(FragC (&acc)[2][2], const bf16* const (&src)[2],
                                          const bf16* __restrict__ w, long ldw, int cin,
                                          bf16* sa, bf16* sb) {
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const int kc = tid & 3;
  for (int k0 = 0; k0 < cin; k0 += kBK) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (src[i] != nullptr) v = *reinterpret_cast<const uint4*>(src[i] + k0 + kc * 8);
      *reinterpret_cast<uint4*>(sa + igemm_a_row(i) * kLdA + kc * 8) = v;
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + kThreads * i;
      const int r = c >> 3, nc = c & 7;
      *reinterpret_cast<uint4*>(sb + r * kLdB + nc * 8) =
          *reinterpret_cast<const uint4*>(w + (long)(k0 + r) * ldw + nc * 8);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      FragA fa[2];
      FragBRow fb[2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        wmma::load_matrix_sync(fa[mi], sa + (wm * 32 + mi * 16) * kLdA + kk, kLdA);
#pragma unroll
      for (int ni = 0; ni < 2; ++ni)
        wmma::load_matrix_sync(fb[ni], sb + kk * kLdB + wn * 32 + ni * 16, kLdB);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 2; ++ni) wmma::mma_sync(acc[mi][ni], fa[mi], fb[ni], acc[mi][ni]);
    }
    __syncthreads();
  }
}

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

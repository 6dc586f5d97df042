// Shared pieces of the hand-written Hopper kernels: the bf16 type and its
// helpers.
//
// The convolutions K1 / K4 / K6 and K2 are one pipeline (conv_pipeline.cuh)
// on Hopper's TMA, mbarrier and wgmma (hopper.cuh), as are K7's video
// regime and the attention kernels K3 / K3q (attention_pipeline.cuh, after
// the q/k preparation of window_qk_prepare.cuh) and K5 (the same loop with
// the policy of flash_attention.cuh). K7's split-K regime runs on the
// mma.sync and cp.async of ptx.cuh; K8 (gn_stats.cuh) on plain loads.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace seedvr2 {

using bf16 = __nv_bfloat16;

// Eight bf16 values moved as one 16-byte word.
union Pack8 {
  uint4 u;
  bf16 h[8];
};

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// Max and sum over the 4 lanes of a quad (lane / 4 alike): the lanes that
// share an mma / wgmma accumulator row.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ uint32_t pick4(const uint32_t (&v)[4], int i) {
  return i == 0 ? v[0] : i == 1 ? v[1] : i == 2 ? v[2] : v[3];
}

// A 4 x 4 transpose of 4-byte words inside a lane quad: lane q holds v[j] =
// its word of block j (j = 0..3) and gets back the four lanes' words of
// block q, lane 0's first. An accumulator's bf16 pairs (lane q: columns 2q,
// 2q + 1 of four 8-column blocks) become one 16-byte run of 8 columns a lane.
__device__ __forceinline__ uint4 quad_transpose(const uint32_t (&v)[4], int q) {
  uint32_t x[4];  // x[s] = lane (q ^ s)'s word of block q: it sends v[q ^ s], which is what (q ^ s) needs of us
  x[0] = pick4(v, q);
#pragma unroll
  for (int s = 1; s < 4; ++s) x[s] = __shfl_xor_sync(0xffffffffu, pick4(v, q ^ s), s);
  return make_uint4(pick4(x, q), pick4(x, q ^ 1), pick4(x, q ^ 2), pick4(x, q ^ 3));
}

}  // namespace seedvr2

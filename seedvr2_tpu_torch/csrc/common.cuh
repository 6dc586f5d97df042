// Shared pieces of the hand-written Hopper kernels: the bf16 type and its
// helpers.
//
// K1/K4 and K2 have their own core (conv_core.cuh) and the attention
// kernels theirs (attention_core.cuh), both on the inline PTX of ptx.cuh:
// mma.sync fragments in registers, ldmatrix operands, cp.async rings. K6
// (conv3d_im2col.cuh) runs on Hopper's TMA, mbarrier and wgmma
// (hopper.cuh).
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

}  // namespace seedvr2

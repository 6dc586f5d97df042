// Shared pieces of the hand-written Hopper kernels: the bf16 type and its
// helpers.
//
// The attention kernels have their own core (attention_core.cuh) on the
// inline PTX of ptx.cuh: mma.sync fragments in registers, ldmatrix
// operands, cp.async rings. The convolutions K1 / K4 / K6 and K2 are one
// pipeline (conv_pipeline.cuh) on Hopper's TMA, mbarrier and wgmma
// (hopper.cuh), as is K7's video regime.
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

// K8: the per-frame GroupNorm statistics of K4's route, written as K4's
// tables (scale, shift) [B, T, C] fp32 with x * scale + shift ==
// GroupNorm(x) * gw + gb for each frame (b, t) of a raw x_ext [B, T, H, W,
// C] bf16.
//
// Replaces no TPU kernel: the JAX package computes these tables with XLA's
// reductions (seedvr2_tpu/ops/conv3d_kernel.py:143 gn_silu_tables), outside
// Pallas. The port's plain version of them (ops/conv3d_kernel.py:
// gn_silu_tables_plain) on a CUDA tensor made an fp32 copy of x_ext, a
// second fp32 copy of (x - mean)^2 and one launch a sum, which cost more
// device time on the long clip than K4 itself (PERF.md).
//
// What bounds it on the H100: bytes. x is read once; a value costs a few
// flops, far under the card's ~20 fp32 flops a byte.
//
// Design: two launches, no atomics (two launches give the same bits).
// 1. gn_partials_kernel, grid (pixel chunks, B * T): a block takes a chunk
//    of ppb * steps pixels of one frame (the chunk geometry is the
//    caller's: ops/conv3d_kernel.py:gn_stats_geometry, 256 KB of x a
//    chunk at the VAE's widths), C / 8 neighbouring threads a pixel, each
//    loading 16 bytes (8 channels) of it, 4 pixels at a time. A thread keeps
//    (mean, M2) of each of its two 4-channel halves (a half never straddles
//    a group, since C / groups is a multiple of 4) and its count: a batch
//    of 4 pixels' 16 values of a half is reduced two-pass in registers,
//    then merged into the running pair by Chan's formula, as accurate as a
//    two-pass variance with one read. The block merges its threads' pairs
//    group by group in thread order through shared memory and writes one
//    (mean, M2) per group to scratch [B * T, chunks, groups].
// 2. gn_tables_kernel, a warp per (frame, group): lane l merges chunks
//    [l * per, (l + 1) * per) in index order, the lanes then merge pairwise
//    (lane, lane + s) for s = 1, 2, 4, 8, 16, so the chunks stay in index
//    order; var = M2 / n, rstd = 1 / sqrt(var + eps), and the group's
//    channels get scale = rstd * gw and shift = gb - mean * scale.
#pragma once

#include <math.h>

#include "common.cuh"

namespace seedvr2 {
namespace gnstats {

constexpr int kMaxThreads = 1024;

// Chan's merge of (nb, mb, m2b) into (n, mean, m2).
__device__ __forceinline__ void merge(float& n, float& mean, float& m2, float nb, float mb, float m2b) {
  if (nb == 0.f) return;
  const float nn = n + nb;
  const float w = nb / nn;
  const float d = mb - mean;
  mean += d * w;
  m2 += m2b + d * d * (n * w);
  n = nn;
}

// Two bf16 of a 32-bit word as floats.
__device__ __forceinline__ float2 unpack(uint32_t u) {
  return make_float2(__uint_as_float(u << 16), __uint_as_float(u & 0xffff0000u));
}

// (mean, M2) of k pixels' 4-channel half (words lo, hi of each 16-byte load), two-pass.
template <int k>
__device__ __forceinline__ void batch(const uint4 (&u)[4], int half, float& mean, float& m2) {
  float v[4 * k];
#pragma unroll
  for (int i = 0; i < k; ++i) {
    const float2 a = unpack(half ? u[i].z : u[i].x), b = unpack(half ? u[i].w : u[i].y);
    v[4 * i] = a.x;
    v[4 * i + 1] = a.y;
    v[4 * i + 2] = b.x;
    v[4 * i + 3] = b.y;
  }
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4 * k; ++i) s += v[i];
  mean = s * (1.f / (4 * k));
  m2 = 0.f;
#pragma unroll
  for (int i = 0; i < 4 * k; ++i) m2 += (v[i] - mean) * (v[i] - mean);
}

// grid (chunks, frames), ppb * C / 8 threads.
__global__ void __launch_bounds__(kMaxThreads) gn_partials_kernel(const bf16* __restrict__ x, float2* __restrict__ part,
                                                                  int P, int C, int G, int ppb, int steps) {
  __shared__ float red_n[kMaxThreads];
  __shared__ float2 red[kMaxThreads][2];
  const int tpp = C / 8;  // threads a pixel
  const int tc = threadIdx.x % tpp, pl = threadIdx.x / tpp;
  const long frame = blockIdx.y;
  const long chunk_px = (long)ppb * steps;
  const long p0 = blockIdx.x * chunk_px;
  const long pend = min((long)P, p0 + chunk_px);
  const uint4* src = reinterpret_cast<const uint4*>(x + frame * P * C) + tc;

  float n = 0.f, mean[2] = {0.f, 0.f}, m2[2] = {0.f, 0.f};
  long p = p0 + pl;
  for (; p + 3L * ppb < pend; p += 4L * ppb) {
    uint4 u[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) u[i] = __ldg(src + (p + (long)i * ppb) * tpp);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float bm, bm2;
      batch<4>(u, h, bm, bm2);
      float nh = n;
      merge(nh, mean[h], m2[h], 16.f, bm, bm2);
    }
    n += 16.f;
  }
  for (; p < pend; p += ppb) {
    uint4 u[4];
    u[0] = __ldg(src + p * tpp);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float bm, bm2;
      batch<1>(u, h, bm, bm2);
      float nh = n;
      merge(nh, mean[h], m2[h], 4.f, bm, bm2);
    }
    n += 4.f;
  }
  red_n[threadIdx.x] = n;
  red[threadIdx.x][0] = make_float2(mean[0], m2[0]);
  red[threadIdx.x][1] = make_float2(mean[1], m2[1]);
  __syncthreads();

  // group g: the halves hh = 2 tc + h in [g * Cg / 4, (g + 1) * Cg / 4) of
  // every pixel lane, merged in the order (pixel lane, half)
  const int hpg = C / G / 4;  // halves a group
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    float gn = 0.f, gm = 0.f, gm2 = 0.f;
    for (int l = 0; l < ppb; ++l)
      for (int hh = g * hpg; hh < (g + 1) * hpg; ++hh) {
        const int t = l * tpp + hh / 2;
        const float2 r = red[t][hh & 1];
        merge(gn, gm, gm2, red_n[t], r.x, r.y);
      }
    part[(frame * gridDim.x + blockIdx.x) * G + g] = make_float2(gm, gm2);
  }
}

template <class W>
__device__ __forceinline__ float to_float(W w) {
  return (float)w;
}
template <>
__device__ __forceinline__ float to_float(bf16 w) {
  return __bfloat162float(w);
}

// One warp per (frame, group); blocks of 256 threads.
template <class W>
__global__ void __launch_bounds__(256) gn_tables_kernel(const float2* __restrict__ part, const W* __restrict__ gw,
                                                        const W* __restrict__ gb, float* __restrict__ scale,
                                                        float* __restrict__ shift, int frames, int P, int C, int G,
                                                        int chunks, long chunk_px, float eps) {
  const int lane = threadIdx.x & 31;
  const long wi = ((long)blockIdx.x * blockDim.x + threadIdx.x) / 32;
  if (wi >= (long)frames * G) return;
  const long frame = wi / G;
  const int g = (int)(wi % G), cg = C / G;
  const int per = (chunks + 31) / 32;
  float n = 0.f, mean = 0.f, m2 = 0.f;
  for (int k = lane * per; k < min(chunks, (lane + 1) * per); ++k) {
    const float2 r = part[(frame * chunks + k) * G + g];
    const long px = min((long)P, (k + 1) * chunk_px) - k * chunk_px;
    merge(n, mean, m2, (float)(px * cg), r.x, r.y);
  }
#pragma unroll
  for (int s = 1; s < 32; s <<= 1) {
    const float on = __shfl_down_sync(0xffffffffu, n, s), om = __shfl_down_sync(0xffffffffu, mean, s),
                om2 = __shfl_down_sync(0xffffffffu, m2, s);
    if ((lane & (2 * s - 1)) == 0) merge(n, mean, m2, on, om, om2);
  }
  mean = __shfl_sync(0xffffffffu, mean, 0);
  const float var = __shfl_sync(0xffffffffu, m2, 0) / __shfl_sync(0xffffffffu, n, 0);
  const float rstd = 1.f / sqrtf(var + eps);
  for (int i = lane; i < cg; i += 32) {
    const int c = g * cg + i;
    const float sc = rstd * to_float(gw[c]);
    scale[frame * C + c] = sc;
    shift[frame * C + c] = to_float(gb[c]) - mean * sc;
  }
}

}  // namespace gnstats
}  // namespace seedvr2

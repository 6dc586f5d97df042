// K7: the W8A16 linear of the int8 DiT, y[M, N] = (x[M, K] @ widen(w[K, N]))
// * scale[N] (+ bias[N]), x and y bf16, w int8 stored [N, K] (K-contiguous),
// scale fp32, bias bf16, the sum in fp32.
//
// Replaces what XLA does for seedvr2_tpu/models/dit/nadit.py:277-285
// (_apply_linear on an int8 leaf) and seedvr2_tpu/ops/quant.py:43-53
// (linear_apply): a convert of the int8 weight fused into the product, so
// that no dequantized copy of it is ever written. Here the int8 tile lands
// in shared memory and each thread widens the bytes of its own B fragments
// to bf16 in registers.
//
// Bound: on the video stream (M = 7200 rows at 720p) the product is bound by
// operations (7B qkv: 0.41 ms at the bf16 peak against 0.06 ms of bytes);
// on the text stream (M = 58) by the weight's bytes, which int8 halves
// against a bf16 copy. This first kernel is simple: bf16 mma.sync m16n8k16
// (ptx.cuh) on a three-stage cp.async ring of 128 x 64 x-tiles and 128 x 64
// int8 w-tiles, 8 warps of 64 x 32 outputs each, scale and bias in the fp32
// epilogue with one rounding to bf16. Split-K for the text rows (a grid of
// N / 128 blocks fills 72 of 132 SMs at 7B qkv) and wgmma are later work.
//
// The fragments need no ldmatrix. The mma's k order within a 16-step is
// free as long as A and B agree, so logical k = 2t, 2t + 1, 8 + 2t, 9 + 2t
// of lane (g, t) is mapped to physical k = 4t .. 4t + 3. Then a lane's B
// fragment (column n = g) is the 4 contiguous bytes w[n][4t .. 4t + 3] (one
// 32-bit shared load, widened to two bf16 pairs: b0 = k 4t, 4t + 1; b1 = k
// 4t + 2, 4t + 3), and its A fragment is x[g][4t .. 4t + 3] and x[g + 8][4t
// .. 4t + 3] (two 64-bit shared loads: a0, a2 from row g; a1, a3 from row g
// + 8). Row pitches of 160 (x) and 80 (w) bytes keep both loads free of
// bank conflicts.
#pragma once

#include "common.cuh"
#include "ptx.cuh"

namespace seedvr2 {
namespace w8a16 {

constexpr int kBM = 128, kBN = 128, kBK = 64;
constexpr int kStages = 3;
constexpr int kThreads = 256;            // 8 warps: 2 along M x 4 along N
constexpr int kWM = 64, kWN = 32;         // one warp's outputs
constexpr int kMF = kWM / 16, kNF = kWN / 8;
constexpr int kXPitch = kBK + 16;         // bf16 elements per x row in shared memory (160 bytes)
constexpr int kWPitch = kBK + 16;         // bytes per w row (80)
constexpr int kXStage = kBM * kXPitch;    // bf16 elements
constexpr int kWStage = kBN * kWPitch;    // bytes
constexpr int kXBytes = kStages * kXStage * 2;
constexpr int kSmemBytes = kXBytes + kStages * kWStage;

struct Args {
  const bf16* x;       // [M, K]
  const int8_t* w;     // [N, K]
  const float* scale;  // [N]
  const bf16* bias;    // [N] or nullptr
  bf16* y;             // [M, N]
  int M, N, K;
};

// Four int8 (k ascending from the low byte) as two bf16 pairs, exactly, without
// the int -> float converts (a quarter-rate unit): each byte v = q + 128 is
// placed in the mantissa of 2^23 (fp32 bits 0x4B0000vv = 2^23 + v), 2^23 + 128
// is subtracted (exact: q), and the upper halves of the fp32 results are the
// bf16 values (|q| <= 128 has at most 8 significant bits: the truncation is
// exact).
__device__ __forceinline__ void widen_s8x4(uint32_t q, uint32_t& lo, uint32_t& hi) {
  const uint32_t v = q ^ 0x80808080u;
  constexpr uint32_t kBase = 0x4B000000u;
  float f[4];
  uint32_t* u = reinterpret_cast<uint32_t*>(f);
  u[0] = __byte_perm(v, kBase, 0x7650);
  u[1] = __byte_perm(v, kBase, 0x7651);
  u[2] = __byte_perm(v, kBase, 0x7652);
  u[3] = __byte_perm(v, kBase, 0x7653);
#pragma unroll
  for (int i = 0; i < 4; ++i) f[i] -= 8388736.f;  // 2^23 + 128
  lo = __byte_perm(u[0], u[1], 0x7632);
  hi = __byte_perm(u[2], u[3], 0x7632);
}

// One k-tile of x (rows past M zero-filled) and of w (rows past N zero-filled:
// the last N tile of an N that is a multiple of 64 only) into ring stage s.
__device__ __forceinline__ void load_tile(const Args& a, bf16* xs, uint8_t* ws, int m0, int n0, int k0, int tid) {
#pragma unroll
  for (int i = 0; i < kBM * kBK / 8 / kThreads; ++i) {  // 16-byte chunks of x: 8 a row
    const int c = tid + i * kThreads;
    const int row = c / (kBK / 8), col = (c % (kBK / 8)) * 8;
    const bool ok = m0 + row < a.M;
    const bf16* src = a.x + (ok ? (size_t)(m0 + row) * a.K + k0 + col : 0);
    cp_async16(xs + row * kXPitch + col, src, ok);
  }
#pragma unroll
  for (int i = 0; i < kBN * kBK / 16 / kThreads; ++i) {  // 16-byte chunks of w: 4 a row
    const int c = tid + i * kThreads;
    const int row = c / (kBK / 16), col = (c % (kBK / 16)) * 16;
    const bool ok = n0 + row < a.N;
    cp_async16(ws + row * kWPitch + col, a.w + (ok ? (size_t)(n0 + row) * a.K + k0 + col : 0), ok);
  }
}

__global__ void __launch_bounds__(kThreads, 2) w8a16_linear_kernel(const Args a) {
  extern __shared__ __align__(16) uint8_t smem[];
  bf16* xs0 = reinterpret_cast<bf16*>(smem);
  uint8_t* ws0 = smem + kXBytes;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp / (kBN / kWN), wn = warp % (kBN / kWN);
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM;
  const int KT = a.K / kBK;

  float acc[kMF][kNF][4];
#pragma unroll
  for (int i = 0; i < kMF; ++i)
#pragma unroll
    for (int j = 0; j < kNF; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < KT) load_tile(a, xs0 + s * kXStage, ws0 + s * kWStage, m0, n0, s * kBK, tid);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<kStages - 2>();  // this thread's copies of tile kt have landed
    __syncthreads();               // everyone's have, and stage (kt - 1) % kStages is free
    const int next = kt + kStages - 1;
    if (next < KT)
      load_tile(a, xs0 + (next % kStages) * kXStage, ws0 + (next % kStages) * kWStage, m0, n0, next * kBK, tid);
    cp_async_commit();
    const bf16* xs = xs0 + (kt % kStages) * kXStage;
    const uint8_t* ws = ws0 + (kt % kStages) * kWStage;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t b[kNF][2];
#pragma unroll
      for (int j = 0; j < kNF; ++j) {
        const int n = wn * kWN + j * 8 + g;
        widen_s8x4(*reinterpret_cast<const uint32_t*>(ws + n * kWPitch + kk + 4 * t), b[j][0], b[j][1]);
      }
#pragma unroll
      for (int i = 0; i < kMF; ++i) {
        const int m = wm * kWM + i * 16 + g;
        const uint2 r0 = *reinterpret_cast<const uint2*>(xs + m * kXPitch + kk + 4 * t);
        const uint2 r8 = *reinterpret_cast<const uint2*>(xs + (m + 8) * kXPitch + kk + 4 * t);
        const uint32_t af[4] = {r0.x, r8.x, r0.y, r8.y};
#pragma unroll
        for (int j = 0; j < kNF; ++j) mma_bf16(acc[i][j], af, b[j][0], b[j][1]);
      }
    }
  }
  cp_async_wait_all();

  // epilogue: lane (g, t) holds rows g, g + 8 and columns 2t, 2t + 1 of each 16 x 8 fragment
  if (n0 + wn * kWN >= a.N) return;  // this warp's columns lie past N (N % 64 == 0: all or none of them)
#pragma unroll
  for (int j = 0; j < kNF; ++j) {
    const int n = n0 + wn * kWN + j * 8 + 2 * t;
    const float s0 = a.scale[n], s1 = a.scale[n + 1];
    const float b0 = a.bias != nullptr ? __bfloat162float(a.bias[n]) : 0.f;
    const float b1 = a.bias != nullptr ? __bfloat162float(a.bias[n + 1]) : 0.f;
#pragma unroll
    for (int i = 0; i < kMF; ++i) {
      const int m = m0 + wm * kWM + i * 16 + g;
      if (m < a.M)
        *reinterpret_cast<uint32_t*>(a.y + (size_t)m * a.N + n) =
            pack_bf16(acc[i][j][0] * s0 + b0, acc[i][j][1] * s1 + b1);
      if (m + 8 < a.M)
        *reinterpret_cast<uint32_t*>(a.y + (size_t)(m + 8) * a.N + n) =
            pack_bf16(acc[i][j][2] * s0 + b0, acc[i][j][3] * s1 + b1);
    }
  }
}

// Launch on ``stream``; N % 64 == 0 (the last N tile may be half full), K % kBK == 0.
inline int launch(const Args& a, cudaStream_t stream) {
  const cudaError_t err =
      cudaFuncSetAttribute(w8a16_linear_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.N + kBN - 1) / kBN, (a.M + kBM - 1) / kBM);
  w8a16_linear_kernel<<<grid, kThreads, kSmemBytes, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace w8a16
}  // namespace seedvr2

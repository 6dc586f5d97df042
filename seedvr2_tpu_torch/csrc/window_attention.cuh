// K3: the DiT's fused window attention (qk rms-norm + RoPE + per-window
// text keys + masked softmax + PV), head-major; K3q: the same with int8 q/k.
//
// Replaces the Pallas kernel seedvr2_tpu/ops/fused_window_attention.py:145
// fused_window_attention (_kernel; quant_qk=True is K3q, the attention_mode
// sageattn_2/3, its _quant at :100-117). Per (batch, window, head) the
// query rows are the window's S video slots followed by the Lt text tokens;
// the keys/values are [window video ; all text]; padded video slots (valid
// == 0) are masked out of the keys, and their query rows are computed and
// written like any other (the DiT drops them). The text-output mean over
// windows stays outside, in fp32, as in the JAX model.
//
// What bounds it on the H100: bytes. A (window, head)'s q, k, v and
// outputs in bf16 are 4 * 463 * 256 bytes against 4 * 463^2 * 128 flops
// (3B 720p: S 405, Lt 58), ~230 flops a byte, under the card's ~295 for
// bf16, and the fp32 RoPE tables add bytes. The kernel it replaces (a
// register-resident mma.sync core, deleted since K5 left it too) ran at
// ~1.5x SDPA: it normalised and roped every K row in shared memory once
// per 128-row query block (4 times a window at R = 463, each text row 4 x
// nW times), ~44% of its time with the tensor cores idle; every warp
// reloaded every K and V fragment by ldmatrix for its 16 rows; and one
// cp.async ring and __syncthreads pair served all 8 warps, so no softmax
// overlapped a product.
//
// Design: two kernels, launched back to back by the wrapper
// (ops/fused_window_attention.py).
// 1. window_qk_prepare.cuh: every q and k row normalised and roped once
//    (K3q: its int8 codes and scale), written to scratch: video rows [B, H,
//    nW, S, D], text rows [B, H, Lt, D] once per (batch, head); plus the
//    window's key codes [nW, Sp] (Sp = S rounded up to 64). The trade: at
//    3B 720p the prepared q/k are ~75 MB written and ~75 MB read back by
//    the flash loop (~0.045 ms of bandwidth a direction at 3.35 TB/s), in
//    place of the in-loop preparation that took ~44% of the old kernel's
//    0.393 ms; K3q writes int8 codes, half those bytes, and 4-byte scales.
//    A fused form (one block a (window, head) preparing K once into 128 KB
//    of resident shared memory) would save those bytes but leaves no room
//    for a V ring beside it and runs one block per (window, head).
// 2. attention_pipeline.cuh: the flash loop on TMA + mbarrier + wgmma, with
//    this policy. A work item is (batch, head, window, pair of query
//    tiles): the window's query tiles are its video slots in 64-row tiles,
//    then its text rows in 64-row tiles (no tile mixes the two), and the two
//    consumer warp groups of a block take one tile each. The key tiles are
//    likewise the video slots [0, S) in 64-key tiles, each from a 5-D
//    tensor map over [B, H, nW, S, D] (a box never crosses into the next
//    window; TMA zero-fills past S and the key code masks those slots),
//    then the text keys [0, Lt) from their own map. V is read by TMA from
//    the caller's qkv tensors as they are: no concatenated copy of q, k or
//    v is made. K3q multiplies int8 codes on the s8 wgmma (both operands
//    K-major, the one layout 8-bit wgmma takes); its logit is float(dot) *
//    (s_q * scale * log2(e)) * s_k, exact in the dot since |dot| <= 128 *
//    127^2 < 2^24. A video key tile whose 64 slots hold no token (the
//    prep's flag) is neither loaded nor multiplied: its keys would add
//    exactly 0 (41% of the video key tiles of the 3B 720p shifted plan, 19%
//    and 30% of the 1080p ones). Items run in the order (pair, window,
//    head, batch), so the blocks in flight share a window's keys in L2.
#pragma once

#include "attention_pipeline.cuh"

namespace seedvr2 {
namespace window {

using flash::kBN;
using flash::kBox;
using flash::QTile;

constexpr int kD = flash::kD;
constexpr int kEncodeError = 1 << 20;  // + CUresult of a failed cuTensorMapEncodeTiled
constexpr int kMaxDevices = 64;

// The tensor maps of one launch, 5-D each (innermost first): the prepared
// video q / k [B, H, nW, S, D] as (D, S, nW, H, B), the text q / k [B, H,
// Lt, D] as (D, Lt, 1, H, B), and V inside the caller's qkv tensors:
// [B, 3, H, nW, S, D] as (D, S, nW, H, 3B) and [B, 3, H, Lt, D] as (D, Lt,
// 1, H, 3B), kind 2 at coordinate 3b + 2.
struct Maps {
  CUtensorMap q_vid, k_vid, v_vid, q_txt, k_txt, v_txt;
  __device__ void prefetch() const {
    sm90::tma_prefetch(&q_vid);
    sm90::tma_prefetch(&k_vid);
    sm90::tma_prefetch(&v_vid);
    sm90::tma_prefetch(&q_txt);
    sm90::tma_prefetch(&k_txt);
    sm90::tma_prefetch(&v_txt);
  }
};

struct Item {
  int b, h, w, pair;
};

template <bool kQuant_>
struct WindowTiles {
  static constexpr bool kQuant = kQuant_;
  static constexpr bool kProducerCodes = false;  // the codes and tile flags come from the preparation's scratch
  using Item = window::Item;
  int B, H, nW, S, Lt, Sp, Ltp;
  int nvt, ntt, npairs;   // video tiles, text tiles (64 rows or keys each), query tile pairs
  float scale;            // 1 / sqrt(D)
  const float* kcode;     // [nW, Sp]
  const uint8_t* tile_live;  // [nW, nvt]: 1 when a video key tile holds a token
  const float* qs_vid;    // K3q: [B, H, nW, Sp]
  const float* ks_vid;
  const float* qs_txt;    // K3q: [B, H, Ltp]
  const float* ks_txt;
  bf16* ovid;             // [B, H, nW, S, D]
  bf16* otxt;             // [B, H, nW, Lt, D]

  __device__ int items() const { return npairs * nW * H * B; }
  __device__ Item item(int i) const {
    Item it;
    it.pair = i % npairs;
    i /= npairs;
    it.w = i % nW;
    i /= nW;
    it.h = i % H;
    it.b = i / H;
    return it;
  }
  __device__ int key_tiles() const { return nvt + ntt; }
  // bit j: video key tile j (< 64) holds a token; tiles past 64 and text tiles always count
  __device__ uint64_t live_tiles(const Item& it) const {
    uint64_t live = 0;
    const int n = nvt < 64 ? nvt : 64;
    for (int j = 0; j < n; ++j) live |= (uint64_t)(__ldg(tile_live + (long)it.w * nvt + j) != 0) << j;
    return live;
  }
  __device__ int next_tile(uint64_t live, int j) const {
    do ++j;
    while (j < nvt && j < 64 && !((live >> j) & 1));
    return j;
  }
  __device__ int last_tile(uint64_t) const { return nvt + ntt - 1; }  // a text tile: always live
  __device__ QTile q_tile(const Item& it, int c) const {
    const int qi = 2 * it.pair + c;
    if (qi < nvt) return QTile{1, 64 * qi, min(64, S - 64 * qi)};
    if (qi < nvt + ntt) return QTile{2, 64 * (qi - nvt), min(64, Lt - 64 * (qi - nvt))};
    return QTile{0, 0, 0};
  }
  __device__ bool video_tile(int j) const { return j < nvt; }
  __device__ float text_code(int j, int col) const { return 64 * (j - nvt) + col < Lt ? 0.f : -INFINITY; }

  // one 64-row box of `map` at (row0, w or 0, h, bb): bf16 as two 64-column halves, int8 as one
  __device__ void load_rows(const CUtensorMap* map, bool int8, int row0, int w, int h, int bb,
                            unsigned char* dst, uint64_t* bar) const {
    sm90::tma_load_5d(dst, map, bar, 0, row0, w, h, bb);
    if (!int8) sm90::tma_load_5d(dst + kBox, map, bar, 64, row0, w, h, bb);
  }

  __device__ void load_q(const Maps& m, const Item& it, const QTile& qt, unsigned char* dst, uint64_t* bar) const {
    const bool vid = qt.kind == 1;
    load_rows(vid ? &m.q_vid : &m.q_txt, kQuant, qt.row0, vid ? it.w : 0, it.h, it.b, dst, bar);
  }

  __device__ uint32_t kv_bytes(int j) const {
    return (kQuant ? kBox : 2 * kBox) + 2 * kBox + (video_tile(j) ? kBN * 4 : 0) + (kQuant ? kBN * 4 : 0);
  }

  __device__ void load_kv(const Maps& m, const Item& it, int j, unsigned char* k, unsigned char* v, float* code,
                          float* kscale, uint64_t* bar) const {
    const bool vid = video_tile(j);
    const int row0 = 64 * (vid ? j : j - nvt), w = vid ? it.w : 0;
    load_rows(vid ? &m.k_vid : &m.k_txt, kQuant, row0, w, it.h, it.b, k, bar);
    load_rows(vid ? &m.v_vid : &m.v_txt, false, row0, w, it.h, 3 * it.b + 2, v, bar);
    if (vid) sm90::bulk_load(code, kcode + (long)it.w * Sp + row0, kBN * 4, bar);
    if (kQuant) {
      const long bh = (long)it.b * H + it.h;
      sm90::bulk_load(kscale, vid ? ks_vid + (bh * nW + it.w) * Sp + row0 : ks_txt + bh * Ltp + row0, kBN * 4, bar);
    }
  }

  __device__ float q_scale(const Item& it, const QTile& qt, int r) const {
    const long bh = (long)it.b * H + it.h;
    return qt.kind == 1 ? qs_vid[(bh * nW + it.w) * Sp + qt.row0 + r] : qs_txt[bh * Ltp + qt.row0 + r];
  }

  __device__ bf16* out_row(const Item& it, const QTile& qt, int r) const {
    if (r >= qt.rows) return nullptr;
    const long bhw = ((long)it.b * H + it.h) * nW + it.w;
    return qt.kind == 1 ? ovid + (bhw * S + qt.row0 + r) * kD : otxt + (bhw * Lt + qt.row0 + r) * kD;
  }
  __device__ bool keep(const Item&, const QTile&, int) const { return true; }  // padded slots' rows are written too
  __device__ float extra_den(float) const { return 0.f; }  // every key is loaded
};

// ---- host side ----
// Internal linkage: conv_ab loads libraries of other trees beside this one
// (see conv_pipeline.cuh).
namespace {

// A 5-D map over a contiguous tensor of dims (innermost first) with 64-row
// boxes of 128 bytes, 128-byte swizzle, zeros past the end.
inline CUresult encode(PFN_cuTensorMapEncodeTiled_v12000 fn, CUtensorMap* map, bool int8, const void* ptr,
                       const cuuint64_t (&dims)[5]) {
  const cuuint64_t e = int8 ? 1 : 2;
  cuuint64_t strides[4];
  cuuint64_t s = e;
  for (int i = 0; i < 4; ++i) strides[i] = (s *= dims[i]);
  const cuuint32_t box[5] = {int8 ? 128u : 64u, 64, 1, 1, 1};
  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  return fn(map, int8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, const_cast<void*>(ptr),
            dims, strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);  // NONE fills zeros
}

// Encodes the maps and launches flash_kernel on `stream` over min(items, SMs)
// blocks. Returns 0, a cudaError_t, or kEncodeError + a CUresult.
template <bool kQuant>
int launch(WindowTiles<kQuant> p, const void* vqkv, const void* tqkv, const void* q_vid, const void* k_vid,
           const void* q_txt, const void* k_txt, cudaStream_t stream) {
  cudaError_t err = cudaSuccess;
  const auto fn = sm90::tensor_map_encoder(&err);
  if (fn == nullptr) return (int)err;
  const cuuint64_t D = kD, S = p.S, Lt = p.Lt, nW = p.nW, H = p.H, B = p.B;
  const cuuint64_t vid[5] = {D, S, nW, H, B}, txt[5] = {D, Lt, 1, H, B};
  const cuuint64_t vid3[5] = {D, S, nW, H, 3 * B}, txt3[5] = {D, Lt, 1, H, 3 * B};
  Maps m;
  CUresult r;
  if ((r = encode(fn, &m.q_vid, kQuant, q_vid, vid)) != CUDA_SUCCESS) return kEncodeError + (int)r;
  if ((r = encode(fn, &m.k_vid, kQuant, k_vid, vid)) != CUDA_SUCCESS) return kEncodeError + (int)r;
  if ((r = encode(fn, &m.q_txt, kQuant, q_txt, txt)) != CUDA_SUCCESS) return kEncodeError + (int)r;
  if ((r = encode(fn, &m.k_txt, kQuant, k_txt, txt)) != CUDA_SUCCESS) return kEncodeError + (int)r;
  if ((r = encode(fn, &m.v_vid, false, vqkv, vid3)) != CUDA_SUCCESS) return kEncodeError + (int)r;
  if ((r = encode(fn, &m.v_txt, false, tqkv, txt3)) != CUDA_SUCCESS) return kEncodeError + (int)r;

  // once per device: the shared-memory opt-in above 48 KB; the SM count
  static bool opted[kMaxDevices] = {false};
  static int sms[kMaxDevices] = {0};
  int dev = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  constexpr int smem = flash::Layout<kQuant>::kSmemBytes;
  const auto kernel = flash::flash_kernel<Maps, WindowTiles<kQuant>>;
  if (!opted[dev]) {
    if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem)) != cudaSuccess)
      return (int)err;
    int n = 0;
    if ((err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return (int)err;
    sms[dev] = n;
    opted[dev] = true;
  }
  const long items = (long)p.npairs * p.nW * p.H * p.B;
  if (items > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const int grid = items < sms[dev] ? (int)items : sms[dev];
  kernel<<<grid, flash::kThreads, smem, stream>>>(m, p);
  return (int)cudaGetLastError();
}

// Registers a thread, local memory (spills) a thread and the dynamic shared
// memory of the flash kernel.
template <bool kQuant>
int attributes(int* regs, int* local_bytes, int* smem_bytes) {
  cudaFuncAttributes f;
  const cudaError_t err = cudaFuncGetAttributes(&f, flash::flash_kernel<Maps, WindowTiles<kQuant>>);
  if (err != cudaSuccess) return (int)err;
  *regs = f.numRegs;
  *local_bytes = (int)f.localSizeBytes;
  *smem_bytes = flash::Layout<kQuant>::kSmemBytes;
  return 0;
}

}  // namespace

}  // namespace window
}  // namespace seedvr2

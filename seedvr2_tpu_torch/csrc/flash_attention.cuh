// K5: masked attention over [B, S, H, D] bf16 (D = 128) with an fp32
// softmax, the DiT's unfused window attention under attention_mode
// flash_attn_2/3.
//
// Replaces the Pallas kernel seedvr2_tpu/ops/flash_attention.py:
// flash_attention (_attn_kernel): logits q.k / sqrt(D) in fp32, masked keys
// at -1e30, fp32 softmax, probabilities in bf16 before PV, the output
// zeroed where q_valid is false. The Pallas version pads S to a multiple of
// 128 and transposes to [B*H, S, D] for the TPU compiler's alignment; here
// the kernel reads the strided [B, S, H, D] layout (each row of a head is
// 256 contiguous bytes) and masks the ragged S itself, so no padded or
// transposed copy exists. The JAX function's padding keys (masked, zero
// value) still count in its softmax denominator, which only a row with no
// valid key can see: the kernel adds their n_pad terms exp(-1e30 - m) at
// the end instead of loading them. Masked keys keep their -1e30 logit
// through the online max, as in the JAX math, so a row whose keys are all
// masked comes out as sum(v) / Sp.
//
// What bounds it on the H100: at the DiT's shapes (S = 463, 7B: B*nW = 32,
// H = 24) a (b, h) does 4*S^2*D flops on 4*S*D*2 bytes of q, k, v and o,
// ~230 flops a byte, under the card's ~295 for bf16, so the least time is
// set by the bytes.
//
// Design: the masked policy of attention_pipeline.cuh (TMA, mbarrier rings,
// wgmma), beside the window attention's. A work item is (batch, head,
// 128-row query block), the two consumer warp groups taking its two 64-row
// tiles; items run in the order (block, head, batch), so the blocks in
// flight share a (batch, head)'s K and V in L2. Q, K and V come by TMA from
// 4-D tensor maps over the strided tensors, dims (D, H, S, B), a box of 64
// rows of one head in two 64-column halves; TMA zero-fills rows past S.
// The producer warp's 32 lanes turn kv_valid into each stage's key codes
// (0: valid, the masked logit -1e30 * log2(e): masked, -inf: past S) and,
// once an item, into the bitmask of the 64-key tiles that hold a valid key.
// A tile whose keys are all masked is neither loaded nor multiplied: while
// the row has a valid key somewhere its terms are exactly 0 (exp2 of -1e30
// against a real logit), wherever the tile lies in the walk. In a batch row
// with no valid key the masked keys are the whole result, so there no tile
// is skipped (and with more than 64 key tiles, S > 4096, none is either).
#pragma once

#include "attention_pipeline.cuh"

namespace seedvr2 {
namespace masked {

using flash::kBN;
using flash::kBox;
using flash::kMaskedL2;
using flash::QTile;

constexpr int kD = flash::kD;
constexpr int kEncodeError = 1 << 20;  // + CUresult of a failed cuTensorMapEncodeTiled
constexpr int kMaxDevices = 64;

// The tensor maps of one launch: q, k, v [B, S, H, D] as (D, H, S, B).
struct Maps {
  CUtensorMap q, k, v;
  __device__ void prefetch() const {
    sm90::tma_prefetch(&q);
    sm90::tma_prefetch(&k);
    sm90::tma_prefetch(&v);
  }
};

struct Item {
  int b, h, qb;
};

struct FlashTiles {
  static constexpr bool kQuant = false;
  static constexpr bool kProducerCodes = true;
  using Item = masked::Item;
  int B, S, H, nqb, nk;     // query blocks of 128 rows, key tiles of 64
  int n_pad;                // keys the JAX function pads with: max(ceil(S/128)*128, 128) - S
  float scale;              // 1 / sqrt(D)
  const uint8_t* kv_valid;  // [B, S]
  const uint8_t* q_valid;   // [B, S] or null
  bf16* o;                  // [B, S, H, D]

  __device__ int items() const { return nqb * H * B; }
  __device__ Item item(int i) const {
    Item it;
    it.qb = i % nqb;
    i /= nqb;
    it.h = i % H;
    it.b = i / H;
    return it;
  }
  __device__ int key_tiles() const { return nk; }
  __device__ uint64_t all_tiles() const { return nk >= 64 ? ~0ull : (1ull << nk) - 1; }

  // Bit j: key tile j holds a valid key of batch row it.b (all the producer
  // warp's lanes together: lane l reads keys 64 j + l and + 32 of each tile).
  __device__ uint64_t live_tiles(const Item& it) const {
    if (nk > 64) return all_tiles();
    const int lane = threadIdx.x & 31;
    const uint8_t* row = kv_valid + (long)it.b * S;
    uint64_t live = 0;
    for (int j = 0; j < nk; ++j) {
      const int k0 = 64 * j + lane, k1 = k0 + 32;
      const int v = (k0 < S ? __ldg(row + k0) : 0) | (k1 < S ? __ldg(row + k1) : 0);
      live |= (uint64_t)(v != 0) << j;
    }
    for (int s = 16; s > 0; s >>= 1) live |= __shfl_xor_sync(0xffffffffu, live, s);
    return live != 0 ? live : all_tiles();  // no valid key: every masked key counts, none is skipped
  }
  __device__ int next_tile(uint64_t live, int j) const {
    do ++j;
    while (j < nk && j < 64 && !((live >> j) & 1));
    return j;
  }
  __device__ int last_tile(uint64_t live) const { return nk > 64 ? nk - 1 : 63 - __clzll((long long)live); }

  __device__ QTile q_tile(const Item& it, int c) const {
    const int row0 = 128 * it.qb + 64 * c;
    return row0 < S ? QTile{1, row0, min(64, S - row0)} : QTile{0, 0, 0};
  }
  __device__ bool video_tile(int) const { return true; }  // every tile's codes are in its stage
  __device__ float text_code(int, int) const { return 0.f; }

  // the codes of keys 64 j + lane and 64 j + 32 + lane (log2 domain)
  __device__ float code(const uint8_t* row, int key) const {
    return key >= S ? -INFINITY : (__ldg(row + key) ? 0.f : kMaskedL2);
  }
  __device__ float2 key_codes(const Item& it, int j, int lane) const {
    const uint8_t* row = kv_valid + (long)it.b * S;
    return make_float2(code(row, 64 * j + lane), code(row, 64 * j + 32 + lane));
  }

  // one 64-row box of `map` at (row0, h, b), as two 64-column halves
  __device__ void load_rows(const CUtensorMap* map, int row0, int h, int b, unsigned char* dst, uint64_t* bar) const {
    sm90::tma_load_4d(dst, map, bar, 0, h, row0, b);
    sm90::tma_load_4d(dst + kBox, map, bar, 64, h, row0, b);
  }
  __device__ void load_q(const Maps& m, const Item& it, const QTile& qt, unsigned char* dst, uint64_t* bar) const {
    load_rows(&m.q, qt.row0, it.h, it.b, dst, bar);
  }
  __device__ uint32_t kv_bytes(int) const { return 4 * kBox; }
  __device__ void load_kv(const Maps& m, const Item& it, int j, unsigned char* k, unsigned char* v, float*, float*,
                          uint64_t* bar) const {
    load_rows(&m.k, 64 * j, it.h, it.b, k, bar);
    load_rows(&m.v, 64 * j, it.h, it.b, v, bar);
  }

  __device__ bf16* out_row(const Item& it, const QTile& qt, int r) const {
    return r < qt.rows ? o + (((long)it.b * S + qt.row0 + r) * H + it.h) * kD : nullptr;
  }
  __device__ bool keep(const Item& it, const QTile& qt, int r) const {
    return r < qt.rows && (q_valid == nullptr || __ldg(q_valid + (long)it.b * S + qt.row0 + r) != 0);
  }
  // the JAX padding keys: n_pad terms 2^(masked - m), nonzero only when m is the masked logit
  __device__ float extra_den(float m) const { return (float)n_pad * exp2f(kMaskedL2 - m); }
};

// ---- host side ----
// Internal linkage: conv_ab loads libraries of other trees beside this one
// (see conv_pipeline.cuh).
namespace {

// A 4-D map over [B, S, H, D] bf16 as (D, H, S, B), boxes of 64 columns x
// 1 head x 64 rows, 128-byte swizzle, zeros past the end.
inline CUresult encode(PFN_cuTensorMapEncodeTiled_v12000 fn, CUtensorMap* map, const void* ptr, int B, int S,
                       int H) {
  const cuuint64_t dims[4] = {(cuuint64_t)kD, (cuuint64_t)H, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {kD * 2, (cuuint64_t)H * kD * 2, (cuuint64_t)S * H * kD * 2};
  const cuuint32_t box[4] = {64, 1, 64, 1};
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box, ones,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);  // NONE fills zeros
}

// Encodes the maps and launches flash_kernel on `stream` over min(items, SMs)
// blocks. Returns 0, a cudaError_t, or kEncodeError + a CUresult.
inline int launch(FlashTiles p, const void* q, const void* k, const void* v, cudaStream_t stream) {
  cudaError_t err = cudaSuccess;
  const auto fn = sm90::tensor_map_encoder(&err);
  if (fn == nullptr) return (int)err;
  Maps m;
  CUresult r;
  if ((r = encode(fn, &m.q, q, p.B, p.S, p.H)) != CUDA_SUCCESS) return kEncodeError + (int)r;
  if ((r = encode(fn, &m.k, k, p.B, p.S, p.H)) != CUDA_SUCCESS) return kEncodeError + (int)r;
  if ((r = encode(fn, &m.v, v, p.B, p.S, p.H)) != CUDA_SUCCESS) return kEncodeError + (int)r;

  // once per device: the shared-memory opt-in above 48 KB; the SM count
  static bool opted[kMaxDevices] = {false};
  static int sms[kMaxDevices] = {0};
  int dev = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  constexpr int smem = flash::Layout<false>::kSmemBytes;
  const auto kernel = flash::flash_kernel<Maps, FlashTiles>;
  if (!opted[dev]) {
    if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem)) != cudaSuccess)
      return (int)err;
    int n = 0;
    if ((err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return (int)err;
    sms[dev] = n;
    opted[dev] = true;
  }
  const long items = (long)p.nqb * p.H * p.B;
  if (items > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const int grid = items < sms[dev] ? (int)items : sms[dev];
  kernel<<<grid, flash::kThreads, smem, stream>>>(m, p);
  return (int)cudaGetLastError();
}

// Registers a thread, local memory (spills) a thread and the dynamic shared
// memory of the kernel.
inline int attributes(int* regs, int* local_bytes, int* smem_bytes) {
  cudaFuncAttributes f;
  const cudaError_t err = cudaFuncGetAttributes(&f, flash::flash_kernel<Maps, FlashTiles>);
  if (err != cudaSuccess) return (int)err;
  *regs = f.numRegs;
  *local_bytes = (int)f.localSizeBytes;
  *smem_bytes = flash::Layout<false>::kSmemBytes;
  return 0;
}

}  // namespace

}  // namespace masked
}  // namespace seedvr2

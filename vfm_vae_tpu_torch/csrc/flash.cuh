// The machinery that the bf16 flash kernels share (the forward,
// flash_attention_nullkv.cu; the dQ and dK/dV kernels of the backward,
// flash_attention_nullkv_bwd.cu): the shared-memory layout and TMA ring of a
// warp-specialised, persistent CTA, the wgmma products over its tiles, and
// the host side of a launch (tensor maps, shared-memory limits, SM count).
//
// A CTA holds NWG consumer warpgroups of 64 rows each and one producer
// warpgroup. Per work tile (a block of 64 NWG rows of one (sample, head)) the
// producer loads the block's rows of kRes "resident" tensors once, then
// streams n_tiles tiles of two tensors A and B through a ring of kStages
// stages; each consumer warpgroup multiplies its 64 resident rows with every
// streamed tile:
//   forward: resident Q;        streamed K (A) and V (B)
//   dQ:      resident Q and dO; streamed K (A) and V (B)
//   dK/dV:   resident K and V;  streamed Q (A) and dO (B), plus the
//            producer's per-row L and D (kRowFloats floats a stage)
// All tiles are bf16 in the 128-byte swizzle of hopper.cuh, 64 columns per
// box (two boxes a row at d = 128).
#pragma once

#include <atomic>

#include "common.cuh"
#include "hopper.cuh"

namespace vfm {

// Shared-memory layout (bytes from a 1024-aligned base): the resident
// tensors (each kBoxes boxes of kRowsRes rows), the A ring, the B ring, the
// ring's mbarriers and kRowFloats floats per stage.
template <int D, int NWG, int Res, int ResBoxRows, int KT, int Stages, int RowFloats>
struct RingLayout {
  static constexpr int kBoxes = D / 64;             // 64-column boxes per row
  static constexpr int kRes = Res;                  // resident tensors
  static constexpr int kRowsRes = 64 * NWG;         // resident rows per work tile
  static constexpr int kResBoxRows = ResBoxRows;    // rows per TMA box of a resident tensor
  static constexpr int kResBox = kRowsRes * 128;    // one box column of a resident tensor
  static constexpr int kKT = KT;                    // rows per streamed tile
  static constexpr int kKBox = KT * 128;            // one box of a streamed tile
  static constexpr int kTile = kBoxes * kKBox;      // one streamed tile
  static constexpr int kStages = Stages;
  static constexpr int kA = Res * kBoxes * kResBox;  // A ring
  static constexpr int kB = kA + Stages * kTile;     // B ring
  static constexpr int kBar = kB + Stages * kTile;   // the ring's mbarriers
  static constexpr int kRows = kBar + 8 * (2 + 3 * Stages);  // per-stage row floats
  static constexpr int kRowFloats = RowFloats;
  static constexpr int kRowArrivals = RowFloats ? 32 : 0;  // a producer warp writes them
  static constexpr int kSmem = kRows + Stages * RowFloats * 4 + 1024;  // + alignment slack
  static constexpr int kThreadsConsumer = NWG * 128;
  static constexpr int kThreads = kThreadsConsumer + 128;  // + the producer warpgroup
};

template <int N>
__device__ __forceinline__ void fence_all(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) fence_operand(r[i]);
}

template <int N>
__device__ __forceinline__ void fence_all(int (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) fence_operand(r[i]);
}

template <int N>
__device__ __forceinline__ void fence_all(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) fence_operand(r[i][e]);
}

// Work tile of a CTA's walk: (block, head, sample), blocks fastest, so that
// the CTAs in flight share heads and their streamed tiles in L2. r0 is the
// block's first resident row.
struct WorkTile {
  int r0, h, b;
};

// The ring and its loads. CTA c walks work tiles c, c + gridDim.x, ...;
// every work tile has n_tiles streamed tiles, and streamed tile j of the
// CTA's it-th work tile is tile gi = it * n_tiles + j of its walk through the
// ring (stage gi % kStages). Barriers: res_full and res_empty for the
// resident buffers, a_full, b_full and empty for each stage.
template <typename L>
struct Ring {
  const CUtensorMap* res[L::kRes];
  const CUtensorMap *ta, *tb;
  uint32_t res_s, a_s, b_s, bar;  // shared addresses
  int n_tiles, n_blocks, n_work, N, t_res;  // t_res: rows of the resident tensors

  __device__ __forceinline__ uint32_t res_full() const { return bar; }
  __device__ __forceinline__ uint32_t res_empty() const { return bar + 8u; }
  __device__ __forceinline__ uint32_t a_full(int s) const { return bar + 8u * (2 + s); }
  __device__ __forceinline__ uint32_t b_full(int s) const {
    return bar + 8u * (2 + L::kStages + s);
  }
  __device__ __forceinline__ uint32_t empty(int s) const {
    return bar + 8u * (2 + 2 * L::kStages + s);
  }
  __device__ __forceinline__ int work(int it) const { return blockIdx.x + it * gridDim.x; }
  __device__ __forceinline__ WorkTile tile(int it) const {
    const int w = work(it);
    return {(w % n_blocks) * L::kRowsRes, (w / n_blocks) % N, w / (n_blocks * N)};
  }

  __device__ __forceinline__ void init() const {
    mbar_init(res_full(), 1);
    mbar_init(res_empty(), L::kThreadsConsumer);
    for (int s = 0; s < L::kStages; ++s) {
      mbar_init(a_full(s), 1);
      mbar_init(b_full(s), 1 + L::kRowArrivals);
      mbar_init(empty(s), L::kThreadsConsumer);
    }
    mbar_fence_init();
  }

  // The producer: one lane issues every TMA load of the CTA's walk, each as
  // soon as its buffer is free. Resident boxes of kResBoxRows rows that start
  // past t_res are not loaded (their rows are never stored).
  __device__ __forceinline__ void produce() const {
    constexpr int kParts = L::kRowsRes / L::kResBoxRows;
    for (int it = 0; work(it) < n_work; ++it) {
      const WorkTile wt = tile(it);
      if (it > 0) mbar_wait(res_empty(), (it - 1) & 1);
      int parts = kParts;
      if (kParts > 1) {
        const int left = (t_res - wt.r0 + L::kResBoxRows - 1) / L::kResBoxRows;
        parts = left < kParts ? left : kParts;
      }
      mbar_expect_tx(res_full(), parts * L::kRes * L::kBoxes * L::kResBoxRows * 128);
      for (int r = 0; r < L::kRes; ++r)
        for (int x = 0; x < L::kBoxes; ++x)
          for (int p = 0; p < parts; ++p)
            tma_load_4d(res_s + (r * L::kBoxes + x) * L::kResBox + p * L::kResBoxRows * 128,
                        res[r], res_full(), 64 * x, wt.h, wt.r0 + p * L::kResBoxRows, wt.b);
      for (int j = 0; j < n_tiles; ++j) {
        const int gi = it * n_tiles + j, s = gi % L::kStages;
        if (gi >= L::kStages) mbar_wait(empty(s), ((gi / L::kStages) & 1) ^ 1);
        mbar_expect_tx(a_full(s), L::kTile);
        for (int x = 0; x < L::kBoxes; ++x)
          tma_load_4d(a_s + s * L::kTile + x * L::kKBox, ta, a_full(s), 64 * x, wt.h,
                      j * L::kKT, wt.b);
        mbar_expect_tx(b_full(s), L::kTile);
        for (int x = 0; x < L::kBoxes; ++x)
          tma_load_4d(b_s + s * L::kTile + x * L::kKBox, tb, b_full(s), 64 * x, wt.h,
                      j * L::kKT, wt.b);
      }
    }
  }
};

// C (64 x KT) = A B^T over d: A this warpgroup's 64 resident rows at `a_rows`
// (boxes kResBox apart), B a streamed tile at `b_tile` (boxes kKBox apart),
// both K-major; d in steps of 16 (32 bytes within a swizzled 128-byte row,
// the next box after 64).
template <int D, typename L>
__device__ __forceinline__ void issue_ss(float (&c)[L::kKT / 2], uint32_t a_rows,
                                         uint32_t b_tile) {
  static_assert(L::kKT == 64 || L::kKT == 128, "one m64n64 or m64n128 product per 16 of d");
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk & 3) * 32;
    const uint64_t da = sw128_desc(a_rows + (kk >> 2) * L::kResBox + off, 16, 1024);
    const uint64_t db = sw128_desc(b_tile + (kk >> 2) * L::kKBox + off, 16, 1024);
    if constexpr (L::kKT == 128)
      wgmma_ss_m64n128(c, da, db, kk > 0);
    else
      wgmma_ss_m64n64(c, da, db, kk > 0);
  }
}

// C (64 x D) += A B: A (64 x KT) in registers, B a streamed tile read as
// stored, [row][d], as an MN-major operand, 16 rows (2048 bytes) per step.
template <int D, typename L>
__device__ __forceinline__ void issue_rs(float (&c)[D / 2], const uint32_t (&a)[L::kKT / 16][4],
                                         uint32_t b_tile) {
#pragma unroll
  for (int kk = 0; kk < L::kKT / 16; ++kk)
    wgmma_rs<D>(c, a[kk], sw128_desc(b_tile + kk * 2048, L::kKBox, 1024));
}

// A 64 x KT accumulator (sc) as the A fragments of m64nNk16, rounded to
// bf16: columns 16 kk .. 16 kk + 15 in a[kk].
template <int KT>
__device__ __forceinline__ void pack_a(uint32_t (&a)[KT / 16][4], const float (&sc)[KT / 2]) {
#pragma unroll
  for (int kk = 0; kk < KT / 16; ++kk) {
    a[kk][0] = pack_bf16(sc[8 * kk], sc[8 * kk + 1]);
    a[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
    a[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
    a[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
  }
}

// dot[hf] = row r + 8 hf of a resident tile at `tile` (64-column boxes
// `box_bytes` apart) . `vec` (D bf16 in global memory), for the null token:
// lane t of each quad takes the 16-byte chunks t, t + 4, ..., the quad sums.
template <int D>
__device__ __forceinline__ void rows_dot(float (&dot)[2], const unsigned char* tile,
                                         int box_bytes, const bf16* __restrict__ vec, int r,
                                         int t) {
  dot[0] = dot[1] = 0.f;
#pragma unroll
  for (int c = t; c < D / 8; c += 4) {  // this lane's 16-byte chunks of the row
    const uint4 kv = *reinterpret_cast<const uint4*>(vec + 8 * c);
    const uint32_t kw[4] = {kv.x, kv.y, kv.z, kv.w};
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int rr = r + 8 * hf;
      const uint4 qv = *reinterpret_cast<const uint4*>(tile + (c / 8) * box_bytes + rr * 128 +
                                                       (((c & 7) ^ (rr & 7)) << 4));
      const uint32_t qw[4] = {qv.x, qv.y, qv.z, qv.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 a = unpack_bf16(qw[e]), bb = unpack_bf16(kw[e]);
        dot[hf] = fmaf(a.x, bb.x, fmaf(a.y, bb.y, dot[hf]));
      }
    }
  }
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    dot[hf] += __shfl_xor_sync(0xffffffffu, dot[hf], 1);
    dot[hf] += __shfl_xor_sync(0xffffffffu, dot[hf], 2);
  }
}

// ------------------------------------------------------------------- host

// Sets a kernel's dynamic shared-memory limit once per device; later calls
// only read a bit mask.
template <typename Kernel>
inline cudaError_t smem_limit_once(Kernel kernel, int bytes,
                                   std::atomic<unsigned long long>& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (done.load(std::memory_order_relaxed) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) done.fetch_or(bit);
  return err;
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, found through the runtime, so that the
// library links against nothing beyond the CUDA runtime.
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return static_cast<EncodeTiled>(nullptr);
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A bf16 or fp32 (elem_bytes 2 or 4) (B, T, N, D) tensor as a 4-D map
// (innermost first: D, N, T, B) with boxes of 128 bytes of D (64 bf16 or 32
// fp32 columns), one head, `rows` tokens, in the 128-byte swizzle; rows past
// T read as 0.
inline cudaError_t tensor_map(CUtensorMap* map, const void* ptr, int B, int T, int N, int D,
                              int rows, int elem_bytes = 2) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t e = (cuuint64_t)elem_bytes;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)N, (cuuint64_t)T, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * e, (cuuint64_t)N * D * e,
                                 (cuuint64_t)T * N * D * e};
  const cuuint32_t box[4] = {(cuuint32_t)(128 / elem_bytes), 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = fn(map,
                        elem_bytes == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                        : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                        4, const_cast<void*>(ptr), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

inline int sm_count() {
  static const int n = [] {
    int dev = 0, sms = 132;
    if (cudaGetDevice(&dev) == cudaSuccess)
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    return sms;
  }();
  return n;
}

}  // namespace vfm

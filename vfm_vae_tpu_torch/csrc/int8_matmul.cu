// K6 + K10: fused int8 quantize -> int8 x int8 -> int32 GEMM -> rescale + bias,
// for Hopper.
//
// Replaces vfm_vae_tpu/ops/pallas/int8_matmul.py:_int8_matmul_2d (dynamic
// per-row absmax scale) and carries two more modes of the same GEMM:
//   dynamic: s[m] = max(amax_m / 127, 1e-8), xq = rint(x / s) (IEEE division),
//            y = ((acc * s[m]) * ws[n]) + b[n]                -> bf16
//   static:  inv = 1 / max(as, 1e-8), xq = clip(rint(x * inv), -127, 127),
//            y = (acc * (as * ws[n])) + b[n]                  -> bf16
//            (vfm_vae_tpu/ops/quantized.py:int8_linear_prequant_static, an XLA
//            int8 dot in the JAX package; PyTorch has no int8 matmul to stand in)
//   raw:     K10, tools/bench_int8_kernel.py:raw_int8: int8 A, no quantize,
//            out = int8(acc >> 8) with two's-complement wrap.
// Every product, rounding and rescale happens in the plain twin's order, with
// __fdiv_rn / __fmul_rn / __fadd_rn so that nvcc contracts nothing into an FMA,
// and rint half to even (as jnp.round and torch.round); the int32 sum is exact
// in any order, so the kernel and its twin agree bit for bit.
//
// Bound on the H100: 2 M N K int8 operations against M K 2 + N K + M N 2
// bytes; at the tower's M = 1024 B the (K, N) = (1024, 1024) Linears are
// bound by bytes, the fc1/fc2 Linears (1024 x 4096) by the int8 tensor
// cores (1979 TOP/s dense).
//
// Design: a persistent, warp-specialised wgmma GEMM.
// - Tiles of 128 rows x BN columns (BN = 256, or 128 where 128 x 256 tiles
//   would fill fewer than half the SMs; K6's quantize work per stage does not
//   shrink with BN, so narrower tiles cost more than the idle SMs of one
//   wave; `make_plan`, probes/int8_matmul.py), walked by min(tiles, SMs)
//   CTAs with N fastest within a band of rows, so that the CTAs in flight
//   share an x row band in L2 (the weights, at most 4 MB, stay there).
// - A producer warpgroup (one lane) TMA-loads each 128-value K step of x and
//   of the weight (N, K), both K-major as stored, into a ring of stages in
//   the 128-byte swizzle (hopper.cuh), as deep as shared memory allows (3-6).
//   TMA zero-fills rows and K bytes past the tensor, which add 0 to every sum.
// - Two consumer warpgroups of 64 rows each issue wgmma m64nBNk32 s8 with s32
//   accumulators in registers (BN / 2 a thread; setmaxnreg moves the
//   producer's registers to them). K10 reads both operands from the ring
//   (SS). K6 reads x as bf16 and quantizes in registers: each thread loads
//   the bf16 values of its A fragment from the swizzled stage, quantizes and
//   packs four s8 a register (the layout of an 8-bit A operand of wgmma k32,
//   that of mma.m16n8k32 per warp), and issues wgmma RS with the weight from
//   the ring; x is read once from device memory in bf16 and its int8 form is
//   never stored, as in the TPU kernel. The quantize of step k overlaps the
//   products of step k - 1 (two register sets).
//   Fragment indices (g = lane / 4, t = lane % 4, w the warp in the
//   warpgroup, wg the warpgroup): register a[kk][2q + h] of K step kk
//   (0..3, 32 values each) holds row r = 64 wg + 16 w + g + 8 h of the tile
//   at stage columns c = 32 kk + 16 q + 4 t .. c + 3; the stage holds two
//   boxes of 64 bf16 columns x 128 rows (16 KB each), and column c of row r
//   is at byte  (c / 64) 16384 + 128 r + (((b / 16) ^ (r % 8)) 16) + b % 16,
//   b = 2 (c % 64). Eight-byte loads, served a half-warp (rows g = 0..3 or
//   4..7) at a time: load p (0, 1) of a pair of K steps (2 j, 2 j + 1) reads
//   step kk = 2 j + (p ^ (g % 2)), so that the eight chunks of 16 bytes that
//   a half-warp reads lie in eight different bank groups (conflict-free; with
//   one kk for all lanes, rows g and g ^ 1 would read the same banks), and
//   two selects put the packed words in place (tests/test_torch_int8_plan.py
//   emulates these formulas). rint is the fp32 add of 1.5 * 2^23 (exact for
//   |v| < 2^22, ties to even), whose low byte is the s8 value; static mode's
//   clip is a bf16x2 clamp of x to bounds found once per thread
//   (clamp_bound). The quantize's instructions bound K6: two consumer warps
//   a scheduler issue ~5 a value (probes/int8_matmul.py).
// - Dynamic mode needs the row's absmax before any value is quantized: a
//   pre-pass kernel in the same call writes s[m] to the caller's M floats.
// - Epilogue: the accumulators are rescaled (K6) or shifted (K10), written
//   to a swizzled shared chunk of 64 rows x 128 bytes and stored by TMA
//   (two chunk buffers a consumer warpgroup, so the stores overlap the next
//   chunk and the next tile's products; the producer loads the next tile's
//   stages meanwhile). TMA clips rows and columns past the tensor. K10's
//   int8 rows of N bytes need N % 16 == 0 for TMA; other N store directly.
//
// Layouts: x (M, K) bf16 (raw: int8); wq (N, K) int8, K contiguous (the
// transpose of the JAX package's (K, N)); ws, b (N,) fp32 (b may be null);
// a_s: static, () fp32 on the device; dynamic, (M,) fp32 that the pre-pass
// writes; out (M, N) bf16 (raw: int8). x, wq and out 16-byte aligned.
#include <algorithm>
#include <atomic>
#include <type_traits>

#include "flash.cuh"

namespace {

using vfm::bf16;

enum Mode { kDynamic = 0, kStatic = 1, kRaw = 2 };

constexpr int kBM = 128;                       // rows per tile: two warpgroups of 64
constexpr int kBK = 128;                       // K values per stage (one swizzle row of int8)
constexpr int kConsumers = 2;                  // consumer warpgroups
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kSmemMax = 232448;               // bytes of shared memory a block can use
constexpr int kEpiBox = 64 * 128;              // one epilogue chunk: 64 rows x 128 bytes
constexpr int kEpiBytes = kConsumers * 2 * kEpiBox;
constexpr int kSlack = 1024;                   // 1024-byte alignment of the swizzled tiles
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;             // 128 x 40 + 256 x 232 = 384 x 168, the launch's
constexpr float kRint = 12582912.f;            // 1.5 * 2^23

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

__host__ __device__ constexpr int a_bytes(int mode) { return kBM * kBK * (mode == kRaw ? 1 : 2); }
__host__ __device__ constexpr int stage_bytes(int mode, int bn) { return a_bytes(mode) + bn * kBK; }

// The launch plan (vfm_int8_matmul_plan exports it; ops/kernels/int8_matmul.py
// mirrors it).
struct Plan {
  int bn, stages, tiles, ctas, smem, direct, prepass;
};

Plan make_plan(int M, int N, int mode, int sms) {
  Plan p;
  const int m_tiles = cdiv(M, kBM);
  p.bn = 2LL * m_tiles * cdiv(N, 256) >= sms ? 256 : 128;
  const int stage = stage_bytes(mode, p.bn);
  p.stages = (kSmemMax - kEpiBytes - kSlack) / (stage + 16);
  p.tiles = m_tiles * cdiv(N, p.bn);
  p.ctas = std::min(p.tiles, sms);
  p.smem = p.stages * (stage + 16) + kEpiBytes + kSlack;
  p.direct = mode == kRaw && N % 16 != 0;
  p.prepass = mode == kDynamic;
  return p;
}

template <int MODE, int BN>
struct Cfg {
  static constexpr bool kBf16A = MODE != kRaw;
  static constexpr int kA = a_bytes(MODE);
  static constexpr int kStage = stage_bytes(MODE, BN);
  static constexpr int kAcc = BN / 2;               // s32 accumulators a thread
  static constexpr int kChunkCols = MODE == kRaw ? 128 : 64;  // 128 bytes of output a row
  static constexpr int kChunkN8 = kChunkCols / 8;   // n8 blocks a chunk
  static constexpr int kChunks = BN / kChunkCols;
};

__device__ __forceinline__ void wgmma_ss(int (&d)[128], uint64_t da, uint64_t db, int sc) {
  vfm::wgmma_s8_ss_m64n256(d, da, db, sc);
}
__device__ __forceinline__ void wgmma_ss(int (&d)[64], uint64_t da, uint64_t db, int sc) {
  vfm::wgmma_s8_ss_m64n128(d, da, db, sc);
}
__device__ __forceinline__ void wgmma_rs(int (&d)[128], const uint32_t (&a)[4], uint64_t db,
                                         int sc) {
  vfm::wgmma_s8_rs_m64n256(d, a, db, sc);
}
__device__ __forceinline__ void wgmma_rs(int (&d)[64], const uint32_t (&a)[4], uint64_t db,
                                         int sc) {
  vfm::wgmma_s8_rs_m64n128(d, a, db, sc);
}

// rint(v) as the low byte of v + 1.5 * 2^23 (|v| < 2^22).
__device__ __forceinline__ uint32_t rint_bits(float v) { return __float_as_uint(__fadd_rn(v, kRint)); }

// Static mode's clip, moved before the product: the largest positive finite
// bf16 x (bit pattern) with q(x) = rint(x * inv) <= 127. q is odd and
// monotone, and near 127 neighbouring bf16 values move x * inv by less than
// 1 (8 significant bits), so q(bound) = 127 and, for every x, clip(q(x),
// -127, 127) = q(clamp(x, -bound, bound)) in bf16: two bf16x2 min/max for
// two values instead of two fp32 min/max for each. (If no finite x reaches
// 127, every finite x is exact and the bound is +inf: then only an infinite
// x, with as > 2.6e36, would differ from the twin.)
__device__ __forceinline__ uint32_t clamp_bound(float inv) {
  auto q = [inv](uint32_t bits) { return rintf(__fmul_rn(__uint_as_float(bits << 16), inv)); };
  if (q(0x7f7fu) <= 127.f) return 0x7f80u;
  uint32_t lo = 0, hi = 0x7f7fu;  // q(lo) <= 127 < q(hi)
  while (hi - lo > 1) {
    const uint32_t mid = (lo + hi) / 2;
    (q(mid) <= 127.f ? lo : hi) = mid;
  }
  return lo;
}

// Both bf16 of a word clamped to [lo2, hi2] (bf16x2 bounds).
__device__ __forceinline__ uint32_t clamp_bf16x2(uint32_t v, uint32_t lo2, uint32_t hi2) {
  uint32_t r;
  asm("max.bf16x2 %0, %1, %2;\n" : "=r"(r) : "r"(v), "r"(lo2));
  asm("min.bf16x2 %0, %1, %2;\n" : "=r"(r) : "r"(r), "r"(hi2));
  return r;
}

// Four bf16 (two words, the lowest column first) quantized and packed, the
// lowest column in the lowest byte. Static: rint(clamp(x) * inv) (= the
// twin's clip(rint(x * inv), -127, 127)), the bf16x2 bounds in lo2, hi2;
// dynamic: rint(x / s).
template <int MODE>
__device__ __forceinline__ uint32_t quant4(uint2 v, float f, uint32_t lo2, uint32_t hi2) {
  if constexpr (MODE == kStatic) {
    v.x = clamp_bf16x2(v.x, lo2, hi2);
    v.y = clamp_bf16x2(v.y, lo2, hi2);
  }
  const float x[4] = {__uint_as_float(v.x << 16), __uint_as_float(v.x & 0xffff0000u),
                      __uint_as_float(v.y << 16), __uint_as_float(v.y & 0xffff0000u)};
  uint32_t q[4];
#pragma unroll
  for (int e = 0; e < 4; ++e)
    q[e] = rint_bits(MODE == kStatic ? __fmul_rn(x[e], f) : __fdiv_rn(x[e], f));
  return __byte_perm(__byte_perm(q[0], q[1], 0x0040), __byte_perm(q[2], q[3], 0x0040), 0x5410);
}

// This thread's A fragments of one stage (the four K steps of 32), from the
// bf16 stage at `stage` (generic pointer); r0 = 64 wg + 16 w + g. f: static,
// 1 / max(as, 1e-8), with the clamp bounds lo2, hi2; dynamic, the scales of
// rows r0 and r0 + 8. Lanes with odd g load the K steps of a pair in the
// other order (see the top).
template <int MODE>
__device__ __forceinline__ void quantize_stage(uint32_t (&a)[4][4], const unsigned char* stage,
                                               int r0, int t, float f0, float f1, uint32_t lo2,
                                               uint32_t hi2) {
  const int odd = r0 & 1;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + 8 * h;
        uint32_t w[2];
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          const int c = 32 * (2 * j + (p ^ odd)) + 16 * q + 4 * t;
          const int b = 2 * (c & 63);
          const uint2 v = *reinterpret_cast<const uint2*>(
              stage + (c >> 6) * (kBM * 128) + r * 128 + ((((b >> 4) ^ (r & 7)) << 4) | (b & 15)));
          w[p] = quant4<MODE>(v, h ? f1 : f0, lo2, hi2);
        }
        a[2 * j][2 * q + h] = odd ? w[1] : w[0];
        a[2 * j + 1][2 * q + h] = odd ? w[0] : w[1];
      }
    }
  }
}

// One K step of a consumer warpgroup with register set SET (kt % 2): wait for
// stage s, quantize this thread's A fragments from it (K6), issue the four
// products, then release the previous step's stage once its products have
// completed (which also frees the other register set). Barriers: full[s] at
// bars + 8 s, empty[s] at bars + 8 (stages + s).
template <int MODE, int BN, int SET>
__device__ __forceinline__ void k_step(int (&acc)[BN / 2], uint32_t (&af)[2][4][4],
                                       const unsigned char* smem, uint32_t base, uint32_t bars,
                                       int stages, int& s, uint32_t& ph, int& prev, int kt,
                                       int wg, int r0, int t, int lane, float f0, float f1,
                                       uint32_t lo2, uint32_t hi2) {
  using C = Cfg<MODE, BN>;
  vfm::mbar_wait(bars + 8u * s, ph);
  const uint32_t a = base + s * C::kStage, b = a + C::kA;
  if constexpr (C::kBf16A)
    quantize_stage<MODE>(af[SET], smem + (a - base), r0, t, f0, f1, lo2, hi2);
  vfm::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t db = vfm::sw128_desc(b + 32 * kk, 16, 1024);
    if constexpr (C::kBf16A) {
      wgmma_rs(acc, af[SET][kk], db, kt > 0 || kk > 0);
    } else {
      wgmma_ss(acc, vfm::sw128_desc(a + wg * 64 * 128 + 32 * kk, 16, 1024), db, kt > 0 || kk > 0);
    }
  }
  vfm::wgmma_commit();
  if (kt > 0) {
    vfm::wgmma_wait<1>();
    if constexpr (C::kBf16A) vfm::fence_all(af[SET ^ 1]);
    if (lane == 0) vfm::mbar_arrive(bars + 8u * (stages + prev));
  }
  prev = s;
  if (++s == stages) {
    s = 0;
    ph ^= 1;
  }
}

template <int MODE, int BN>
__global__ void __launch_bounds__(kThreads, 1) int8_gemm_kernel(
    const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw,
    const __grid_constant__ CUtensorMap tout, const float* __restrict__ ws,
    const float* __restrict__ bias, const float* __restrict__ a_s, void* __restrict__ out, int M,
    int N, int K, int stages, int direct) {
  using C = Cfg<MODE, BN>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = vfm::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const unsigned char* smem = smem_raw + (base - raw);  // generic pointer to `base`
  const uint32_t epi = base + stages * C::kStage;
  const uint32_t bars = epi + kEpiBytes;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (stages + s); };
  const int n_tn = cdiv(N, BN), n_tiles = cdiv(M, kBM) * n_tn, nk = cdiv(K, kBK);

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      vfm::mbar_init(full(s), 1);
      vfm::mbar_init(empty(s), 4 * kConsumers);  // one arrival per consumer warp
    }
    vfm::mbar_fence_init();
  }
  __syncthreads();

  // Warpgroup 0 produces (one lane issues every TMA load of the walk); 1 and
  // 2 consume. The role is read through a shuffle so that the compiler sees
  // it is uniform per warp; the two paths never rejoin.
  const int role = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (role == 0) {
    vfm::reg_dealloc<kProducerRegs>();
    if (threadIdx.x != 0) return;
    int s = 0, gi = 0;
    uint32_t ph = 0;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const int m0 = (tile / n_tn) * kBM, n0 = (tile % n_tn) * BN;
      for (int kt = 0; kt < nk; ++kt, ++gi) {
        if (gi >= stages) vfm::mbar_wait(empty(s), ph ^ 1);
        vfm::mbar_expect_tx(full(s), C::kStage);
        const uint32_t a = base + s * C::kStage;
        if constexpr (C::kBf16A) {
          vfm::tma_load_2d(a, &tx, full(s), kt * kBK, m0);
          vfm::tma_load_2d(a + kBM * 128, &tx, full(s), kt * kBK + 64, m0);
        } else {
          vfm::tma_load_2d(a, &tx, full(s), kt * kBK, m0);
        }
        vfm::tma_load_2d(a + C::kA, &tw, full(s), kt * kBK, n0);
        if (++s == stages) {
          s = 0;
          ph ^= 1;
        }
      }
    }
    return;
  }

  vfm::reg_alloc<kConsumerRegs>();
  const int wg = role - 1;
  const int tid = threadIdx.x - 128 * role, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = 64 * wg + 16 * warp + g;  // tile row of this thread's first accumulator row
  float inv = 0.f, as_val = 0.f;
  uint32_t lo2 = 0, hi2 = 0;
  if constexpr (MODE == kStatic) {
    as_val = *a_s;
    inv = __fdiv_rn(1.f, fmaxf(as_val, 1e-8f));
    hi2 = clamp_bound(inv) * 0x10001u;
    lo2 = hi2 | 0x80008000u;
  }
  auto sync_wg = [&] { wg == 0 ? vfm::named_sync<1, 128>() : vfm::named_sync<2, 128>(); };
  const uint32_t my_epi = epi + wg * 2 * kEpiBox;
  int s = 0, chunk_seq = 0;
  uint32_t ph = 0;
  uint32_t af[2][4][4];
  int acc[C::kAcc];

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int m0 = (tile / n_tn) * kBM, n0 = (tile % n_tn) * BN;
    float f0 = inv, f1 = inv;
    if constexpr (MODE == kDynamic) {
      f0 = m0 + r0 < M ? a_s[m0 + r0] : 1.f;
      f1 = m0 + r0 + 8 < M ? a_s[m0 + r0 + 8] : 1.f;
    }
    int prev = 0, kt = 0;
#pragma unroll 1
    for (; kt + 1 < nk; kt += 2) {
      k_step<MODE, BN, 0>(acc, af, smem, base, bars, stages, s, ph, prev, kt, wg, r0, t, lane,
                          f0, f1, lo2, hi2);
      k_step<MODE, BN, 1>(acc, af, smem, base, bars, stages, s, ph, prev, kt + 1, wg, r0, t,
                          lane, f0, f1, lo2, hi2);
    }
    if (kt < nk)
      k_step<MODE, BN, 0>(acc, af, smem, base, bars, stages, s, ph, prev, kt, wg, r0, t, lane,
                          f0, f1, lo2, hi2);
    vfm::wgmma_wait<0>();
    vfm::fence_all(acc);
    if constexpr (C::kBf16A) {
      vfm::fence_all(af[0]);
      vfm::fence_all(af[1]);
    }
    if (lane == 0) vfm::mbar_arrive(bars + 8u * (stages + prev));

    // Epilogue. Columns 8 j + 2 t and + 1 of rows r0 and r0 + 8 are
    // acc[4 j + 2 h] and acc[4 j + 2 h + 1].
    const int mrow = m0 + 64 * wg;  // first row of this warpgroup's 64
    if (mrow >= M) continue;        // uniform per warpgroup
    if (MODE == kRaw && direct) {  // K10 with N % 16 != 0: two bytes a store
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = n0 + 8 * j + 2 * t;
        if (col >= N) continue;  // N % 8 == 0: col + 1 < N as well
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = m0 + r0 + 8 * h;
          if (m >= M) continue;
          const uint32_t v = ((static_cast<uint32_t>(acc[4 * j + 2 * h] >> 8) & 0xffu) |
                              ((static_cast<uint32_t>(acc[4 * j + 2 * h + 1] >> 8) & 0xffu) << 8));
          *reinterpret_cast<uint16_t*>(static_cast<int8_t*>(out) + (size_t)m * N + col) =
              static_cast<uint16_t>(v);
        }
      }
      continue;
    }
    const int lr = 16 * warp + g;  // row within the warpgroup's 64 (lr % 8 == g)
#pragma unroll
    for (int c = 0; c < C::kChunks; ++c) {
      const int col0 = n0 + c * C::kChunkCols;
      if (col0 >= N) break;  // uniform
      const uint32_t buf = my_epi + (chunk_seq & 1) * kEpiBox;
      if (tid == 0) vfm::bulk_wait_read<1>();  // the store that last read `buf` is done
      sync_wg();
#pragma unroll
      for (int jj = 0; jj < C::kChunkN8; ++jj) {
        const int j = c * C::kChunkN8 + jj;
        const int col = col0 + 8 * jj + 2 * t;
        float w0 = 0.f, w1 = 0.f, b0 = 0.f, b1 = 0.f;
        if constexpr (MODE != kRaw) {
          if (col < N) {
            const float2 wv = *reinterpret_cast<const float2*>(ws + col);
            w0 = wv.x;
            w1 = wv.y;
            if (bias != nullptr) {
              const float2 bv = *reinterpret_cast<const float2*>(bias + col);
              b0 = bv.x;
              b1 = bv.y;
            }
          }
          if constexpr (MODE == kStatic) {
            w0 = __fmul_rn(as_val, w0);
            w1 = __fmul_rn(as_val, w1);
          }
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = lr + 8 * h;
          const int c0 = acc[4 * j + 2 * h], c1 = acc[4 * j + 2 * h + 1];
          if constexpr (MODE == kRaw) {
            const int byte = 8 * jj + 2 * t;
            const uint32_t v = (static_cast<uint32_t>(c0 >> 8) & 0xffu) |
                               ((static_cast<uint32_t>(c1 >> 8) & 0xffu) << 8);
            asm volatile("st.shared.u16 [%0], %1;\n" ::"r"(
                             buf + r * 128 + ((((byte >> 4) ^ g) << 4) | (byte & 15))),
                         "h"(static_cast<unsigned short>(v))
                         : "memory");
          } else {
            float y0, y1;
            if constexpr (MODE == kDynamic) {
              const float sr = h ? f1 : f0;
              y0 = __fmul_rn(__fmul_rn(__int2float_rn(c0), sr), w0);
              y1 = __fmul_rn(__fmul_rn(__int2float_rn(c1), sr), w1);
            } else {
              y0 = __fmul_rn(__int2float_rn(c0), w0);
              y1 = __fmul_rn(__int2float_rn(c1), w1);
            }
            if (bias != nullptr) {
              y0 = __fadd_rn(y0, b0);
              y1 = __fadd_rn(y1, b1);
            }
            const int byte = 16 * jj + 4 * t;
            asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(
                             buf + r * 128 + ((((byte >> 4) ^ g) << 4) | (byte & 15))),
                         "r"(vfm::pack_bf16(y0, y1))
                         : "memory");
          }
        }
      }
      vfm::fence_proxy_async();
      sync_wg();
      if (tid == 0) {
        vfm::tma_store_2d(&tout, buf, col0, mrow);
        vfm::bulk_commit();
      }
      ++chunk_seq;
    }
  }
  if (tid == 0) vfm::bulk_wait<0>();
}

// Dynamic mode's pre-pass: s[m] = max(max_k |x[m, k]| / 127, 1e-8), one warp a row.
__global__ void __launch_bounds__(256) row_scale_kernel(const bf16* __restrict__ x,
                                                        float* __restrict__ s, int M, int K) {
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= M) return;
  const bf16* src = x + (size_t)row * K;
  float amax = 0.f;
  for (int c = lane * 8; c < K; c += 32 * 8) {
    const uint4 v = *reinterpret_cast<const uint4*>(src + c);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 p = vfm::unpack_bf16(w[i]);
      amax = fmaxf(amax, fmaxf(fabsf(p.x), fabsf(p.y)));
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  if (lane == 0) s[row] = fmaxf(__fdiv_rn(amax, 127.f), 1e-8f);
}

// A row-major (rows, cols) matrix of `es`-byte elements as a 2-D tensor map
// with boxes of (box_cols, box_rows) in the 128-byte swizzle; elements past
// the matrix read as 0 and are not written.
cudaError_t map_2d(CUtensorMap* map, const void* ptr, int es, int rows, int cols, int box_cols,
                   int box_rows) {
  const vfm::EncodeTiled fn = vfm::encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * es};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r =
      fn(map, es == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_UINT8, 2,
         const_cast<void*>(ptr), dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int MODE, int BN>
cudaError_t launch(const Plan& p, const void* x, const void* wq, const float* ws,
                   const float* bias, const float* a_s, void* out, int M, int N, int K,
                   cudaStream_t stream) {
  using C = Cfg<MODE, BN>;
  static std::atomic<unsigned long long> attr_done{0};
  cudaError_t err = vfm::smem_limit_once(int8_gemm_kernel<MODE, BN>, kSmemMax, attr_done);
  if (err != cudaSuccess) return err;
  const int es_in = C::kBf16A ? 2 : 1, es_out = MODE == kRaw ? 1 : 2;
  CUtensorMap tx, tw, tout;
  if ((err = map_2d(&tx, x, es_in, M, K, C::kBf16A ? 64 : 128, kBM)) != cudaSuccess) return err;
  if ((err = map_2d(&tw, wq, 1, N, K, 128, BN)) != cudaSuccess) return err;
  if (p.direct) {
    tout = tw;  // unused
  } else if ((err = map_2d(&tout, out, es_out, M, N, C::kChunkCols, 64)) != cudaSuccess) {
    return err;
  }
  if (MODE == kDynamic) {
    row_scale_kernel<<<cdiv(M, 8), 256, 0, stream>>>(static_cast<const bf16*>(x),
                                                     const_cast<float*>(a_s), M, K);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  int8_gemm_kernel<MODE, BN><<<p.ctas, kThreads, p.smem, stream>>>(
      tx, tw, tout, ws, bias, a_s, out, M, N, K, p.stages, p.direct);
  return cudaGetLastError();
}

template <int MODE>
cudaError_t dispatch(const Plan& p, const void* x, const void* wq, const float* ws,
                     const float* bias, const float* a_s, void* out, int M, int N, int K,
                     cudaStream_t stream) {
  if (p.bn == 256) return launch<MODE, 256>(p, x, wq, ws, bias, a_s, out, M, N, K, stream);
  return launch<MODE, 128>(p, x, wq, ws, bias, a_s, out, M, N, K, stream);
}

bool valid(int M, int N, int K, int mode) {
  return M > 0 && N > 0 && K > 0 && K % 32 == 0 && N % 8 == 0 && mode >= kDynamic &&
         mode <= kRaw;
}

}  // namespace

// mode 0 dynamic (a_s: M fp32 of scratch for the row scales), 1 static (a_s:
// the fp32 scale), 2 raw (K10: x and out int8; ws, bias and a_s unused). One
// call launches the pre-pass (dynamic) and the GEMM.
extern "C" int vfm_int8_matmul(const void* x, const void* wq, const float* ws, const float* bias,
                               const float* a_s, void* out, int M, int N, int K, int mode,
                               void* stream) {
  if (!valid(M, N, K, mode) || ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(wq) |
                                 reinterpret_cast<uintptr_t>(out)) & 15) ||
      (mode != kRaw && (ws == nullptr || a_s == nullptr)))
    return (int)cudaErrorInvalidValue;
  const Plan p = make_plan(M, N, mode, vfm::sm_count());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kDynamic: return (int)dispatch<kDynamic>(p, x, wq, ws, bias, a_s, out, M, N, K, s);
    case kStatic: return (int)dispatch<kStatic>(p, x, wq, ws, bias, a_s, out, M, N, K, s);
    default: return (int)dispatch<kRaw>(p, x, wq, ws, bias, a_s, out, M, N, K, s);
  }
}

// The launch plan for (M, N, K, mode) on a card with `sms` SMs: plan[0] rows
// per tile, [1] columns per tile, [2] K values per stage, [3] ring stages,
// [4] consumer warpgroups, [5] CTAs, [6] threads per CTA, [7] dynamic shared
// memory in bytes, [8] 1 if the epilogue stores directly (else TMA), [9] 1 if
// the row-scale pre-pass runs, [10] tiles.
extern "C" int vfm_int8_matmul_plan(int M, int N, int K, int mode, int sms, int* plan) {
  if (!valid(M, N, K, mode) || sms <= 0) return (int)cudaErrorInvalidValue;
  const Plan p = make_plan(M, N, mode, sms);
  const int vals[11] = {kBM, p.bn, kBK, p.stages, kConsumers, p.ctas, kThreads,
                        p.smem, p.direct, p.prepass, p.tiles};
  for (int i = 0; i < 11; ++i) plan[i] = vals[i];
  return 0;
}

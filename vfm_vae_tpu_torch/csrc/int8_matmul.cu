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
//   gelu:    the first product of the decoder's static-int8 ConvNeXt MLP
//            (vfm_vae_tpu/models/convnext.py:_int8_mlp, an XLA int8 dot in the
//            JAX package): rows grouped by image (img = m / hw), a pre-pass
//            u = x * A[img, k] (fp32), q = clip(rint(u * inv), -127, 127) with
//            inv = 1 / max(as, 1e-8) into int8, then
//            v = (acc * e[img, n]) + b[img, n],
//            y = (v * 0.5) * (1 + erff(v * 0.70710678))           -> bf16
//            (the erf GELU; e = (as * ws) * demod and b the folded bias, per
//            image, from the caller).
//   residual: the MLP's second product, static mode with the layer scale and
//            the residual in the epilogue:
//            y = x_in[m, n] + ((acc * (as * ws[n])) + b[n]) * g[n]  -> bf16
//            (convnext.py:207-211 in fp32, one rounding at the end, as JAX
//            rounds the layer's output to its dtype).
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
// - K6 at a K that is not a multiple of 32 (the EVA-02 SwiGLU's 2730, the
//   Qwen2.5-VL MLP's 3420; vfm_int8_matmul_tails): TMA needs row strides of
//   16-byte multiples, which such an x (2K bytes a row) and weight (K bytes)
//   do not have. The caller gives the weight K' = 32 ceil(K / 32) columns,
//   zero past K, once per weight. A pre-pass (quantize_rows_kernel, one warp
//   a row) quantizes x with the formulas above (dynamic: the row's absmax
//   first, its second read from L1) into an int8 scratch of K' columns,
//   zero past K; the GEMM then reads that by TMA, as K10 does (wgmma SS,
//   modes kDynamicQ and kStaticQ), with K6's epilogue. The zeros add 0 to
//   every sum and leave every absmax as it was: the twin's result at K, bit
//   for bit. Cost: one read of x and one write of M K' bytes in the
//   pre-pass, against a main loop that reads int8 and quantizes nothing.
// - K6 at an N that is not a multiple of 8 (2730, 3420): the bf16 output
//   rows are stored by TMA into a buffer of ldo = 8 ceil(N / 8) columns,
//   which TMA clips at N; the caller hands on its first N columns.
// - The decoder's gelu mode (vfm_int8_matmul_gelu) runs the K-tail route at
//   every K: the pre-pass (quantize_rows_kernel, kQScaled) forms u = x * A
//   in fp32 before it quantizes, so the codes are those of the fp32 product
//   and not of a bf16 u, and the GEMM reads them by TMA (mode kGeluQ). Its
//   epilogue reads the per-image scale and bias at each accumulator's own
//   row (an 8 x 8 image is 64 rows, less than a tile of 128), then applies
//   the exact (erf) GELU: K1 uses the tanh form, this path the JAX
//   package's approximate=False. The second product (vfm_int8_matmul_
//   residual, mode kStaticRes) is the static mode with the layer scale and
//   the residual added in fp32 before the one bf16 rounding: rounding the
//   product to bf16 first (and adding in PyTorch) left the tiny decoder's
//   int8 decode 1.5e-2 (mean relative L1) from the JAX package's, against
//   3e-7 without that rounding (tests/test_torch_int8_decoder.py).
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
// writes; out (M, N) bf16 (raw: int8). x, wq and out 16-byte aligned. The
// tails entry: x (M, K) bf16 2-byte aligned where K % 32 != 0, wq (N, K'),
// out rows of ldo bf16.
#include <algorithm>
#include <atomic>
#include <type_traits>

#include "flash.cuh"

namespace {

using vfm::bf16;

// The API's modes (dynamic, static, raw; gelu and residual, which
// vfm_int8_matmul_gelu and vfm_int8_matmul_residual run), and two more of
// the GEMM: K6's dynamic and static epilogue over an int8 x that the
// quantize pre-pass wrote (a K off 32).
enum Mode {
  kDynamic = 0, kStatic = 1, kRaw = 2, kDynamicQ = 3, kStaticQ = 4, kGeluQ = 5, kStaticRes = 6
};
// The quantize pre-pass's kinds: dynamic row scales, the static scale, the
// static scale of x times a per-image channel scale (gelu).
enum Quant { kQDyn = 0, kQStatic = 1, kQScaled = 2 };

__host__ __device__ constexpr bool bf16_a(int mode) {
  return mode == kDynamic || mode == kStatic || mode == kStaticRes;
}
// The static scale quantizes a bf16 x in registers.
__host__ __device__ constexpr bool static_bf16(int mode) { return mode == kStatic || mode == kStaticRes; }
__host__ __device__ constexpr bool dynamic_scale(int mode) {
  return mode == kDynamic || mode == kDynamicQ;
}

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

__host__ __device__ constexpr int a_bytes(int mode) { return kBM * kBK * (bf16_a(mode) ? 2 : 1); }
__host__ __device__ constexpr int stage_bytes(int mode, int bn) { return a_bytes(mode) + bn * kBK; }

// The launch plan (vfm_int8_matmul_plan exports it; ops/kernels/int8_matmul.py
// mirrors it).
struct Plan {
  int bn, stages, tiles, ctas, smem, direct, prepass, pad;
};

int padded_k(int K) { return cdiv(K, 32) * 32; }

// The GEMM's mode for an API mode: K6 at a K off 32 reads the int8 x of
// the quantize pre-pass (pad), as the gelu mode always does.
int gemm_mode(int mode, bool pad) { return mode == kGeluQ ? kGeluQ : pad ? mode + kDynamicQ : mode; }

// `mode` is the API's; K6 at a K off 32 runs the quantize pre-pass and the
// GEMM's int8-A mode (pad), the gelu mode at every K.
Plan make_plan(int M, int N, int K, int mode, int sms) {
  Plan p;
  const int m_tiles = cdiv(M, kBM);
  p.bn = 2LL * m_tiles * cdiv(N, 256) >= sms ? 256 : 128;
  p.pad = mode == kGeluQ || (mode != kRaw && K % 32 != 0);
  const int stage = stage_bytes(gemm_mode(mode, p.pad), p.bn);
  p.stages = (kSmemMax - kEpiBytes - kSlack) / (stage + 16);
  p.tiles = m_tiles * cdiv(N, p.bn);
  p.ctas = std::min(p.tiles, sms);
  p.smem = p.stages * (stage + 16) + kEpiBytes + kSlack;
  p.direct = mode == kRaw && N % 16 != 0;
  p.prepass = mode == kDynamic || p.pad;
  return p;
}

template <int MODE, int BN>
struct Cfg {
  static constexpr bool kBf16A = bf16_a(MODE);
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

// The erf GELU in the twin's order: (v * 0.5) * (1 + erf(v * sqrt(1/2))).
__device__ __forceinline__ float gelu_erf(float v) {
  return __fmul_rn(__fmul_rn(v, 0.5f), __fadd_rn(1.f, erff(__fmul_rn(v, 0.70710678118654752f))));
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
  if constexpr (static_bf16(MODE)) {
    v.x = clamp_bf16x2(v.x, lo2, hi2);
    v.y = clamp_bf16x2(v.y, lo2, hi2);
  }
  const float x[4] = {__uint_as_float(v.x << 16), __uint_as_float(v.x & 0xffff0000u),
                      __uint_as_float(v.y << 16), __uint_as_float(v.y & 0xffff0000u)};
  uint32_t q[4];
#pragma unroll
  for (int e = 0; e < 4; ++e)
    q[e] = rint_bits(static_bf16(MODE) ? __fmul_rn(x[e], f) : __fdiv_rn(x[e], f));
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
    int N, int K, int stages, int direct, int hw, const float* __restrict__ gamma,
    const bf16* __restrict__ resid) {
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
  if constexpr (static_bf16(MODE)) {
    as_val = *a_s;
    inv = __fdiv_rn(1.f, fmaxf(as_val, 1e-8f));
    hi2 = clamp_bound(inv) * 0x10001u;
    lo2 = hi2 | 0x80008000u;
  }
  if constexpr (MODE == kStaticQ) as_val = *a_s;
  auto sync_wg = [&] { wg == 0 ? vfm::named_sync<1, 128>() : vfm::named_sync<2, 128>(); };
  const uint32_t my_epi = epi + wg * 2 * kEpiBox;
  int s = 0, chunk_seq = 0;
  uint32_t ph = 0;
  uint32_t af[2][4][4];
  int acc[C::kAcc];

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int m0 = (tile / n_tn) * kBM, n0 = (tile % n_tn) * BN;
    float f0 = inv, f1 = inv;
    if constexpr (dynamic_scale(MODE)) {
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
        if constexpr (MODE != kRaw && MODE != kGeluQ) {
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
          if constexpr (MODE == kStatic || MODE == kStaticQ || MODE == kStaticRes) {
            w0 = __fmul_rn(as_val, w0);
            w1 = __fmul_rn(as_val, w1);
          }
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = lr + 8 * h;
          const int c0 = acc[4 * j + 2 * h], c1 = acc[4 * j + 2 * h + 1];
          if constexpr (MODE == kGeluQ) {
            // The image of this row (rows past M read the last image's; TMA
            // does not store them), its scale and bias at these columns.
            float2 ev = make_float2(0.f, 0.f), bv = ev;
            if (col < N) {
              const size_t o = (size_t)(min(mrow + r, M - 1) / hw) * N + col;
              ev = *reinterpret_cast<const float2*>(ws + o);
              bv = *reinterpret_cast<const float2*>(bias + o);
            }
            const float y0 = gelu_erf(__fadd_rn(__fmul_rn(__int2float_rn(c0), ev.x), bv.x));
            const float y1 = gelu_erf(__fadd_rn(__fmul_rn(__int2float_rn(c1), ev.y), bv.y));
            const int byte = 16 * jj + 4 * t;
            asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(
                             buf + r * 128 + ((((byte >> 4) ^ g) << 4) | (byte & 15))),
                         "r"(vfm::pack_bf16(y0, y1))
                         : "memory");
          } else if constexpr (MODE == kRaw) {
            const int byte = 8 * jj + 2 * t;
            const uint32_t v = (static_cast<uint32_t>(c0 >> 8) & 0xffu) |
                               ((static_cast<uint32_t>(c1 >> 8) & 0xffu) << 8);
            asm volatile("st.shared.u16 [%0], %1;\n" ::"r"(
                             buf + r * 128 + ((((byte >> 4) ^ g) << 4) | (byte & 15))),
                         "h"(static_cast<unsigned short>(v))
                         : "memory");
          } else {
            float y0, y1;
            if constexpr (dynamic_scale(MODE)) {
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
            if constexpr (MODE == kStaticRes) {
              // The layer scale, then the residual (rows past M and columns
              // past N are not stored).
              float2 gv = make_float2(0.f, 0.f), xv = gv;
              const int m = mrow + r;
              if (col < N && m < M) {
                gv = *reinterpret_cast<const float2*>(gamma + col);
                xv = vfm::unpack_bf16(
                    *reinterpret_cast<const uint32_t*>(resid + (size_t)m * N + col));
              }
              y0 = __fadd_rn(xv.x, __fmul_rn(y0, gv.x));
              y1 = __fadd_rn(xv.y, __fmul_rn(y1, gv.y));
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

// The pre-pass of a K off 32: x (M, K) bf16 quantized into xq (M, Kp) int8
// with zeros past K, as the GEMM's register quantize would (kQDyn: s[m] =
// max(amax / 127, 1e-8), written out, q = rint(x / s); kQStatic: q =
// clip(rint(x * (1 / max(as, 1e-8))), -127, 127)); kQScaled (the gelu mode,
// at any K): u = x * scale[m / hw, k] in fp32, then kQStatic's q of u. One
// warp a row, eight columns a lane and step; `pairs`: x and its rows 4-byte
// aligned (K even), so two values a load.
template <int Q>
__global__ void __launch_bounds__(256) quantize_rows_kernel(const bf16* __restrict__ x,
                                                            int8_t* __restrict__ xq,
                                                            float* __restrict__ s,
                                                            const float* __restrict__ a_s, int M,
                                                            int K, int Kp, int pairs,
                                                            const float* __restrict__ scale,
                                                            int hw) {
  constexpr bool DYN = Q == kQDyn;
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= M) return;
  const bf16* src = x + (size_t)row * K;
  const float* srow = Q == kQScaled ? scale + (size_t)(row / hw) * K : nullptr;
  auto load8 = [&](int c, float (&v)[8]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = c + 2 * i;
      uint32_t w;
      if (pairs && k + 1 < K) {
        w = *reinterpret_cast<const uint32_t*>(src + k);
      } else {
        w = (k < K ? __bfloat16_as_ushort(src[k]) : 0u) |
            ((k + 1 < K ? __bfloat16_as_ushort(src[k + 1]) : 0u) << 16);
      }
      const float2 p = vfm::unpack_bf16(w);
      v[2 * i] = p.x;
      v[2 * i + 1] = p.y;
    }
  };
  float f;
  if constexpr (DYN) {
    float amax = 0.f;
    for (int c = lane * 8; c < K; c += 32 * 8) {
      float v[8];
      load8(c, v);
#pragma unroll
      for (int e = 0; e < 8; ++e) amax = fmaxf(amax, fabsf(v[e]));
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
    f = fmaxf(__fdiv_rn(amax, 127.f), 1e-8f);
    if (lane == 0) s[row] = f;
  } else {
    f = __fdiv_rn(1.f, fmaxf(*a_s, 1e-8f));
  }
  for (int c = lane * 8; c < Kp; c += 32 * 8) {
    float v[8];
    load8(c, v);
    if constexpr (Q == kQScaled) {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        if (c + e < K) v[e] = __fmul_rn(v[e], srow[c + e]);
    }
    uint32_t q[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float r = DYN ? rintf(__fdiv_rn(v[e], f)) : fminf(fmaxf(rintf(__fmul_rn(v[e], f)),
                                                                    -127.f), 127.f);
      q[e] = static_cast<uint32_t>(static_cast<int>(r)) & 0xffu;
    }
    *reinterpret_cast<uint2*>(xq + (size_t)row * Kp + c) =
        make_uint2(q[0] | (q[1] << 8) | (q[2] << 16) | (q[3] << 24),
                   q[4] | (q[5] << 8) | (q[6] << 16) | (q[7] << 24));
  }
}

// A row-major (rows, cols) matrix of `es`-byte elements, `ld` elements a row,
// as a 2-D tensor map with boxes of (box_cols, box_rows) in the 128-byte
// swizzle; elements past the matrix read as 0 and are not written.
cudaError_t map_2d(CUtensorMap* map, const void* ptr, int es, int rows, int cols, int box_cols,
                   int box_rows, int ld = 0) {
  const vfm::EncodeTiled fn = vfm::encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)(ld ? ld : cols) * es};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r =
      fn(map, es == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_UINT8, 2,
         const_cast<void*>(ptr), dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The decoder modes' extra operands: the gelu pre-pass's per-image channel
// scale (images of hw rows), the residual epilogue's layer scale and input.
struct Extra {
  const float* scale = nullptr;
  int hw = 1;
  const float* gamma = nullptr;
  const void* resid = nullptr;
};

template <int MODE, int BN>
cudaError_t launch(const Plan& p, const void* x, void* xq, const void* wq, const float* ws,
                   const float* bias, const float* a_s, void* out, int M, int N, int K, int ldo,
                   const Extra& ex, cudaStream_t stream) {
  using C = Cfg<MODE, BN>;
  static std::atomic<unsigned long long> attr_done{0};
  cudaError_t err = vfm::smem_limit_once(int8_gemm_kernel<MODE, BN>, kSmemMax, attr_done);
  if (err != cudaSuccess) return err;
  constexpr bool kQ = MODE == kDynamicQ || MODE == kStaticQ || MODE == kGeluQ;
  const int es_in = C::kBf16A ? 2 : 1, es_out = MODE == kRaw ? 1 : 2;
  const int kg = kQ ? padded_k(K) : K;  // the GEMM's K
  CUtensorMap tx, tw, tout;
  if ((err = map_2d(&tx, kQ ? xq : x, es_in, M, kg, C::kBf16A ? 64 : 128, kBM)) != cudaSuccess)
    return err;
  if ((err = map_2d(&tw, wq, 1, N, kg, 128, BN)) != cudaSuccess) return err;
  if (p.direct) {
    tout = tw;  // unused
  } else if ((err = map_2d(&tout, out, es_out, M, N, C::kChunkCols, 64, ldo)) != cudaSuccess) {
    return err;
  }
  if constexpr (kQ) {
    const int pairs = K % 2 == 0 && reinterpret_cast<uintptr_t>(x) % 4 == 0;
    constexpr int kQuant = MODE == kDynamicQ ? kQDyn : MODE == kGeluQ ? kQScaled : kQStatic;
    quantize_rows_kernel<kQuant><<<cdiv(M, 8), 256, 0, stream>>>(
        static_cast<const bf16*>(x), static_cast<int8_t*>(xq), const_cast<float*>(a_s), a_s, M,
        K, kg, pairs, ex.scale, ex.hw);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  } else if (MODE == kDynamic) {
    row_scale_kernel<<<cdiv(M, 8), 256, 0, stream>>>(static_cast<const bf16*>(x),
                                                     const_cast<float*>(a_s), M, K);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  int8_gemm_kernel<MODE, BN><<<p.ctas, kThreads, p.smem, stream>>>(
      tx, tw, tout, ws, bias, a_s, out, M, N, kg, p.stages, p.direct, ex.hw, ex.gamma,
      static_cast<const bf16*>(ex.resid));
  return cudaGetLastError();
}

template <int MODE>
cudaError_t dispatch(const Plan& p, const void* x, void* xq, const void* wq, const float* ws,
                     const float* bias, const float* a_s, void* out, int M, int N, int K, int ldo,
                     const Extra& ex, cudaStream_t stream) {
  if (p.bn == 256)
    return launch<MODE, 256>(p, x, xq, wq, ws, bias, a_s, out, M, N, K, ldo, ex, stream);
  return launch<MODE, 128>(p, x, xq, wq, ws, bias, a_s, out, M, N, K, ldo, ex, stream);
}

bool valid(int M, int N, int K, int mode) {
  return M > 0 && N > 0 && K > 0 && K % 32 == 0 && N % 8 == 0 && mode >= kDynamic &&
         mode <= kRaw;
}

int run(const void* x, void* xq, const void* wq, const float* ws, const float* bias,
        const float* a_s, void* out, int M, int N, int K, int ldo, int mode, void* stream,
        const Extra& ex = Extra()) {
  const Plan p = make_plan(M, N, K, mode, vfm::sm_count());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int m = gemm_mode(mode, p.pad);
#define VFM_INT8_CASE(M_)                                                                 \
  case M_:                                                                                \
    return (int)dispatch<M_>(p, x, xq, wq, ws, bias, a_s, out, M, N, K, ldo, ex, s);
  switch (m) {
    VFM_INT8_CASE(kDynamic)
    VFM_INT8_CASE(kStatic)
    VFM_INT8_CASE(kDynamicQ)
    VFM_INT8_CASE(kStaticQ)
    VFM_INT8_CASE(kGeluQ)
    VFM_INT8_CASE(kStaticRes)
    default:
      return (int)dispatch<kRaw>(p, x, xq, wq, ws, bias, a_s, out, M, N, K, ldo, ex, s);
  }
#undef VFM_INT8_CASE
}

}  // namespace

// mode 0 dynamic (a_s: M fp32 of scratch for the row scales), 1 static (a_s:
// the fp32 scale), 2 raw (K10: x and out int8; ws, bias and a_s unused). One
// call launches the pre-pass (dynamic) and the GEMM. K % 32 == 0, N % 8 == 0
// (K6 at other K or N: vfm_int8_matmul_tails).
extern "C" int vfm_int8_matmul(const void* x, const void* wq, const float* ws, const float* bias,
                               const float* a_s, void* out, int M, int N, int K, int mode,
                               void* stream) {
  if (!valid(M, N, K, mode) || ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(wq) |
                                 reinterpret_cast<uintptr_t>(out)) & 15) ||
      (mode != kRaw && (ws == nullptr || a_s == nullptr)))
    return (int)cudaErrorInvalidValue;
  return run(x, nullptr, wq, ws, bias, a_s, out, M, N, K, N, mode, stream);
}

// K6 (mode 0 dynamic, 1 static) at any K and N. A K off 32: x (M, K) bf16,
// 2-byte aligned, is quantized by the pre-pass into xq (M, Kp) int8 scratch,
// Kp = 32 ceil(K / 32), and wq is (N, Kp) int8 with zeros past K; otherwise x
// and wq (N, K) are read as vfm_int8_matmul reads them (16-byte aligned, xq
// unused). out: rows of ldo bf16, ldo >= N a multiple of 8 (columns N.. are
// not written). ws, bias, a_s as vfm_int8_matmul.
extern "C" int vfm_int8_matmul_tails(const void* x, void* xq, const void* wq, const float* ws,
                                     const float* bias, const float* a_s, void* out, int M,
                                     int N, int K, int ldo, int mode, void* stream) {
  const bool pad = K % 32 != 0;
  if (M <= 0 || N <= 0 || K <= 0 || ldo < N || ldo % 8 || (mode != kDynamic && mode != kStatic) ||
      ws == nullptr || a_s == nullptr || (pad && xq == nullptr) ||
      (reinterpret_cast<uintptr_t>(x) & (pad ? 1 : 15)) ||
      ((reinterpret_cast<uintptr_t>(xq) | reinterpret_cast<uintptr_t>(wq) |
        reinterpret_cast<uintptr_t>(out)) & 15))
    return (int)cudaErrorInvalidValue;
  return run(x, xq, wq, ws, bias, a_s, out, M, N, K, ldo, mode, stream);
}

// The decoder's int8 MLP expand (mode gelu): x (M, K) bf16, 2-byte aligned,
// rows grouped by image (M = images x hw); A (images, K) fp32, the per-image
// channel scale; a_s () fp32, the static scale s (the pre-pass quantizes
// x * A with 1 / max(s, 1e-8) into xq (M, Kp) int8 scratch, Kp = 32 ceil(K /
// 32)); wq (N, Kp) int8, zero past K; e and b (images, N) fp32, the
// epilogue's scale and bias; out (M, N) bf16, N a multiple of 8. xq, wq and
// out 16-byte aligned.
extern "C" int vfm_int8_matmul_gelu(const void* x, const float* A, void* xq, const void* wq,
                                    const float* e, const float* b, const float* a_s, void* out,
                                    int M, int N, int K, int hw, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || N % 8 || hw <= 0 || M % hw || x == nullptr ||
      A == nullptr || e == nullptr || b == nullptr || a_s == nullptr ||
      (reinterpret_cast<uintptr_t>(x) & 1) ||
      ((reinterpret_cast<uintptr_t>(xq) | reinterpret_cast<uintptr_t>(wq) |
        reinterpret_cast<uintptr_t>(out)) & 15) ||
      ((reinterpret_cast<uintptr_t>(e) | reinterpret_cast<uintptr_t>(b)) & 7))
    return (int)cudaErrorInvalidValue;
  Extra ex;
  ex.scale = A;
  ex.hw = hw;
  return run(x, xq, wq, e, b, a_s, out, M, N, K, N, kGeluQ, stream, ex);
}

// The decoder's int8 MLP contract (mode residual): out = x_in + ((acc * (as
// * ws)) + b) * g with x quantized by the static scale as, as K6 static
// does. x (M, K) bf16, wq (N, K) int8, out and x_in (M, N) bf16, all 16-byte
// aligned (x_in 4-byte); ws, b, g (N,) fp32, a_s () fp32. K % 32 == 0, N %
// 8 == 0.
extern "C" int vfm_int8_matmul_residual(const void* x, const void* wq, const float* ws,
                                        const float* b, const float* a_s, const float* g,
                                        const void* x_in, void* out, int M, int N, int K,
                                        void* stream) {
  if (!valid(M, N, K, kStatic) || ws == nullptr || b == nullptr || a_s == nullptr ||
      g == nullptr || x_in == nullptr ||
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(wq) |
        reinterpret_cast<uintptr_t>(out)) & 15) || (reinterpret_cast<uintptr_t>(x_in) & 3))
    return (int)cudaErrorInvalidValue;
  Extra ex;
  ex.gamma = g;
  ex.resid = x_in;
  return run(x, nullptr, wq, ws, b, a_s, out, M, N, K, N, kStaticRes, stream, ex);
}

// The launch plan for (M, N, K, mode) on a card with `sms` SMs: plan[0] rows
// per tile, [1] columns per tile, [2] K values per stage, [3] ring stages,
// [4] consumer warpgroups, [5] CTAs, [6] threads per CTA, [7] dynamic shared
// memory in bytes, [8] 1 if the epilogue stores directly (else TMA), [9] 1 if
// a pre-pass runs (dynamic mode's row scales, or the quantize of a K off
// 32 or of the gelu mode), [10] tiles, [11] 1 if x is quantized to K' = 32
// ceil(K / 32) columns by the pre-pass (K6 at a K off 32, the gelu mode).
// Modes 0-2, 5 (gelu) and 6 (residual); K10 and the residual mode take
// K % 32 == 0 and N % 8 == 0, K6 any K and N.
extern "C" int vfm_int8_matmul_plan(int M, int N, int K, int mode, int sms, int* plan) {
  if (M <= 0 || N <= 0 || K <= 0 || mode < kDynamic ||
      (mode > kRaw && mode != kGeluQ && mode != kStaticRes) ||
      ((mode == kRaw || mode == kStaticRes) && !valid(M, N, K, kRaw)) || sms <= 0)
    return (int)cudaErrorInvalidValue;
  const Plan p = make_plan(M, N, K, mode, sms);
  const int vals[12] = {kBM, p.bn, kBK, p.stages, kConsumers, p.ctas, kThreads,
                        p.smem, p.direct, p.prepass, p.tiles, p.pad};
  for (int i = 0; i < 12; ++i) plan[i] = vals[i];
  return 0;
}

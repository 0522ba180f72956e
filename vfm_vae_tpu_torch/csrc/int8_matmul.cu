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
// __fdiv_rn / __fmul_rn / __fadd_rn so that nvcc contracts nothing into an FMA
// and rintf (half to even, as jnp.round and torch.round); the int32 sum is
// exact, so the kernel and its twin agree bit for bit.
//
// Bound on the H100: 2*M*N*K int8 operations against M*K*2 + N*K + M*N*2
// bytes, ~N/1.5 operations per byte at the tower's K, N >= 1024: compute bound
// (1979 TOP/s dense int8). Design: one CTA of eight warps per (BM-row tile,
// run of column tiles). The CTA quantizes its x row tile once, over the
// whole K, into shared memory (BM = 128 rows at K <= 1504, 64 or 32 rows for
// larger K), and reuses it for every column tile of its run; the number of
// column runs is chosen so that about two waves of CTAs cover the SMs, which
// re-quantizes a row tile once per run. Weight tiles (128 or 256 columns x
// 128 bytes of K) stream through a double buffer with cp.async. The GEMM is mma.sync m16n8k32
// s8.s8.s32; its A and B fragments have, byte for byte, the layout of the
// bf16 m16n8k16 fragments in common.cuh. Not wgmma, not TMA: a right first
// version.
//
// Layouts: x (M, K) bf16 (raw: int8); wq (N, K) int8, K contiguous (the
// transpose of the JAX package's (K, N)); ws, b (N,) fp32 (b may be null);
// as () fp32 on the device; out (M, N) bf16 (raw: int8).
#include <algorithm>

#include "common.cuh"

namespace {

using vfm::bf16;

constexpr int kBK = 128;           // K bytes per weight stage
constexpr int kLDB = kBK + 16;     // weight stage row stride, bytes (conflict-free fragments)
constexpr int kThreads = 256;      // 8 warps
constexpr size_t kSmemMax = 232448;  // bytes of shared memory a block can use

// Warp layout of a BM-row tile: 2 x 4 warps of (BM/2) x 32 (BN = 128) for
// BM >= 64; 1 x 8 warps of 32 x 32 (BN = 256) for BM = 32, so that every
// warp keeps at least two m16 tiles in flight.
template <int BM>
struct Tile {
  static constexpr int WARPS_M = BM >= 64 ? 2 : 1;
  static constexpr int WARPS_N = 8 / WARPS_M;
  static constexpr int BN = 32 * WARPS_N;  // output columns per tile
  static constexpr int MT = BM / WARPS_M / 16;
};

enum Mode { kDynamic = 0, kStatic = 1, kRaw = 2 };

__device__ __forceinline__ void mma_s8(int c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n));
}

__host__ __device__ constexpr int xq_ld(int K) { return K + 16; }  // bytes; conflict-free A loads

// Eight quantized values packed into two words, element 0 at the lowest address.
__device__ __forceinline__ uint2 pack_s8(const float q[8]) {
  uint32_t w[2] = {0u, 0u};
#pragma unroll
  for (int e = 0; e < 8; ++e)
    w[e >> 2] |= (static_cast<uint32_t>(__float2int_rn(q[e])) & 0xffu) << (8 * (e & 3));
  return make_uint2(w[0], w[1]);
}

__device__ __forceinline__ void unpack8(const uint4& v, float f[8]) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 p = vfm::unpack_bf16(w[i]);
    f[2 * i] = p.x;
    f[2 * i + 1] = p.y;
  }
}

// Stage the CTA's row tile as int8 in shared memory; one warp per row.
template <int BM, int MODE>
__device__ void stage_rows(const void* __restrict__ x, const float* __restrict__ a_s,
                           int8_t* xq, float* srow, int m0, int M, int K) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ld = xq_ld(K);
  float inv = 0.f;
  if (MODE == kStatic) inv = __fdiv_rn(1.f, fmaxf(*a_s, 1e-8f));
  for (int r = warp; r < BM; r += kThreads / 32) {
    const int m = m0 + r;
    int8_t* dst = xq + (size_t)r * ld;
    if (m >= M) {  // ragged edge: zero rows, masked at the store
      for (int c = lane * 16; c < K; c += 32 * 16)
        *reinterpret_cast<uint4*>(dst + c) = make_uint4(0, 0, 0, 0);
      if (lane == 0) srow[r] = 1.f;
      continue;
    }
    if (MODE == kRaw) {
      const int8_t* src = static_cast<const int8_t*>(x) + (size_t)m * K;
      for (int c = lane * 16; c < K; c += 32 * 16)
        *reinterpret_cast<uint4*>(dst + c) = *reinterpret_cast<const uint4*>(src + c);
      continue;
    }
    const bf16* src = static_cast<const bf16*>(x) + (size_t)m * K;
    float s = 1.f;
    if (MODE == kDynamic) {
      float amax = 0.f;
      for (int c = lane * 8; c < K; c += 32 * 8) {
        float f[8];
        unpack8(*reinterpret_cast<const uint4*>(src + c), f);
#pragma unroll
        for (int e = 0; e < 8; ++e) amax = fmaxf(amax, fabsf(f[e]));
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
      s = fmaxf(__fdiv_rn(amax, 127.f), 1e-8f);
      if (lane == 0) srow[r] = s;
    }
    for (int c = lane * 8; c < K; c += 32 * 8) {
      float f[8];
      unpack8(*reinterpret_cast<const uint4*>(src + c), f);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        if (MODE == kDynamic) {
          f[e] = rintf(__fdiv_rn(f[e], s));
        } else {
          f[e] = fminf(fmaxf(rintf(__fmul_rn(f[e], inv)), -127.f), 127.f);
        }
      }
      *reinterpret_cast<uint2*>(dst + c) = pack_s8(f);
    }
  }
}

// One BN x 128-byte weight stage; rows past N and bytes past K are zero.
template <int BN>
__device__ __forceinline__ void load_w_stage(int8_t* ws_s, const int8_t* __restrict__ wq, int n0,
                                             int k0, int N, int K) {
  for (int i = threadIdx.x; i < BN * (kBK / 16); i += kThreads) {
    const int r = i / (kBK / 16), c16 = (i % (kBK / 16)) * 16;
    int8_t* dst = ws_s + r * kLDB + c16;
    if (n0 + r < N && k0 + c16 < K) {
      cp_async16(dst, wq + (size_t)(n0 + r) * K + k0 + c16);
    } else {
      *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
    }
  }
}

// A fragment (16 rows x 32 bytes) / B fragment (8 rows x 32 bytes) from byte tiles.
__device__ __forceinline__ void load_a_s8(uint32_t a[4], const int8_t* base, int ld, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const int8_t* p0 = base + g * ld + 4 * t;
  const int8_t* p1 = p0 + 8 * ld;
  a[0] = *reinterpret_cast<const uint32_t*>(p0);
  a[1] = *reinterpret_cast<const uint32_t*>(p1);
  a[2] = *reinterpret_cast<const uint32_t*>(p0 + 16);
  a[3] = *reinterpret_cast<const uint32_t*>(p1 + 16);
}

__device__ __forceinline__ void load_b_s8(uint32_t b[2], const int8_t* base, int ld, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const int8_t* p = base + g * ld + 4 * t;
  b[0] = *reinterpret_cast<const uint32_t*>(p);
  b[1] = *reinterpret_cast<const uint32_t*>(p + 16);
}

template <int BM, int MODE>
__global__ void __launch_bounds__(kThreads) int8_matmul_kernel(
    const void* __restrict__ x, const int8_t* __restrict__ wq, const float* __restrict__ ws,
    const float* __restrict__ bias, const float* __restrict__ a_s, void* __restrict__ out, int M,
    int N, int K, int tiles_per_cta) {
  constexpr int BN = Tile<BM>::BN;
  constexpr int MT = Tile<BM>::MT;  // m16 tiles per warp
  constexpr int WM = MT * 16;       // rows per warp
  constexpr int NT = 4;             // n8 tiles per warp (32 columns)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ld = xq_ld(K);
  int8_t* xq = reinterpret_cast<int8_t*>(smem_raw);                // [BM][ld]
  int8_t* wstage = xq + (size_t)BM * ld;                           // [2][BN][kLDB]
  float* srow = reinterpret_cast<float*>(wstage + 2 * BN * kLDB);  // [BM]

  const int m0 = blockIdx.x * BM;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp % Tile<BM>::WARPS_M, wn = warp / Tile<BM>::WARPS_M;
  const int g = lane >> 2, t = lane & 3;
  const int nk = K / kBK + (K % kBK ? 1 : 0);

  const int tile0 = blockIdx.y * tiles_per_cta;
  const int n_tiles = (N + BN - 1) / BN;
  const int tile_end = min(tile0 + tiles_per_cta, n_tiles);

  // The first weight stage flies while the row tile is quantized.
  load_w_stage<BN>(wstage, wq, tile0 * BN, 0, N, K);
  cp_async_commit();
  stage_rows<BM, MODE>(x, a_s, xq, srow, m0, M, K);

  float as_val = 0.f;
  if (MODE == kStatic) as_val = *a_s;

  for (int tile = tile0; tile < tile_end; ++tile) {
    const int n0 = tile * BN;
    int acc[MT][NT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0;

    for (int kt = 0; kt < nk; ++kt) {
      if (kt + 1 < nk) {
        load_w_stage<BN>(wstage + ((kt + 1) & 1) * BN * kLDB, wq, n0, (kt + 1) * kBK, N, K);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const int8_t* wsb = wstage + (kt & 1) * BN * kLDB;
      const int kbytes = min(kBK, K - kt * kBK);  // K is a multiple of 32
      for (int kk = 0; kk < kbytes; kk += 32) {
        uint32_t af[MT][4];
#pragma unroll
        for (int i = 0; i < MT; ++i)
          load_a_s8(af[i], xq + (size_t)(wm * WM + i * 16) * ld + kt * kBK + kk, ld, lane);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          uint32_t bfr[2];
          load_b_s8(bfr, wsb + (wn * 32 + j * 8) * kLDB + kk, kLDB, lane);
#pragma unroll
          for (int i = 0; i < MT; ++i) mma_s8(acc[i][j], af[i], bfr);
        }
      }
      __syncthreads();
    }

    // The next tile's first weight stage flies during this tile's epilogue.
    if (tile + 1 < tile_end) {
      load_w_stage<BN>(wstage, wq, n0 + BN, 0, N, K);
      cp_async_commit();
    }

#pragma unroll
    for (int i = 0; i < MT; ++i) {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int col = n0 + wn * 32 + j * 8 + 2 * t;
        if (col >= N) continue;  // N is a multiple of 8: col + 1 < N as well
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int rloc = wm * WM + i * 16 + g + half * 8;
          const int m = m0 + rloc;
          if (m >= M) continue;
          const int c0 = acc[i][j][2 * half], c1 = acc[i][j][2 * half + 1];
          if (MODE == kRaw) {
            const uint32_t lo = static_cast<uint32_t>(c0 >> 8) & 0xffu;
            const uint32_t hi = static_cast<uint32_t>(c1 >> 8) & 0xffu;
            *reinterpret_cast<uint16_t*>(static_cast<int8_t*>(out) + (size_t)m * N + col) =
                static_cast<uint16_t>(lo | (hi << 8));
            continue;
          }
          float y0, y1;
          if (MODE == kDynamic) {
            const float s = srow[rloc];
            y0 = __fmul_rn(__fmul_rn(__int2float_rn(c0), s), ws[col]);
            y1 = __fmul_rn(__fmul_rn(__int2float_rn(c1), s), ws[col + 1]);
          } else {
            y0 = __fmul_rn(__int2float_rn(c0), __fmul_rn(as_val, ws[col]));
            y1 = __fmul_rn(__int2float_rn(c1), __fmul_rn(as_val, ws[col + 1]));
          }
          if (bias != nullptr) {
            y0 = __fadd_rn(y0, bias[col]);
            y1 = __fadd_rn(y1, bias[col + 1]);
          }
          *reinterpret_cast<uint32_t*>(static_cast<bf16*>(out) + (size_t)m * N + col) =
              vfm::pack_bf16(y0, y1);
        }
      }
    }
  }
}

int num_sms() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (n <= 0) n = 132;
  }
  return n;
}

template <int BM>
constexpr size_t smem_bytes(int K) {
  return (size_t)BM * xq_ld(K) + 2 * Tile<BM>::BN * kLDB + BM * sizeof(float);
}

template <int BM, int MODE>
cudaError_t launch(const void* x, const void* wq, const float* ws, const float* bias,
                   const float* a_s, void* out, int M, int N, int K, cudaStream_t stream) {
  const size_t smem = smem_bytes<BM>(K);
  cudaError_t err = cudaFuncSetAttribute(int8_matmul_kernel<BM, MODE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int m_tiles = (M + BM - 1) / BM;
  const int n_tiles = (N + Tile<BM>::BN - 1) / Tile<BM>::BN;
  // Enough column runs for about two CTAs per SM; each run re-quantizes its rows.
  const int want = 2 * num_sms();
  const int runs = std::max(1, std::min(n_tiles, (want + m_tiles - 1) / m_tiles));
  const int per = (n_tiles + runs - 1) / runs;
  dim3 grid(m_tiles, (n_tiles + per - 1) / per);
  int8_matmul_kernel<BM, MODE><<<grid, kThreads, smem, stream>>>(
      x, static_cast<const int8_t*>(wq), ws, bias, a_s, out, M, N, K, per);
  return cudaGetLastError();
}

template <int MODE>
cudaError_t dispatch(const void* x, const void* wq, const float* ws, const float* bias,
                     const float* a_s, void* out, int M, int N, int K, cudaStream_t stream) {
  if (smem_bytes<128>(K) <= kSmemMax)
    return launch<128, MODE>(x, wq, ws, bias, a_s, out, M, N, K, stream);
  if (smem_bytes<64>(K) <= kSmemMax)
    return launch<64, MODE>(x, wq, ws, bias, a_s, out, M, N, K, stream);
  if (smem_bytes<32>(K) <= kSmemMax)
    return launch<32, MODE>(x, wq, ws, bias, a_s, out, M, N, K, stream);
  return cudaErrorInvalidValue;  // K too large for a resident row tile
}

}  // namespace

// mode 0 dynamic, 1 static (a_s: device pointer to the fp32 scale), 2 raw (K10:
// x and out int8; ws, bias and a_s unused).
extern "C" int vfm_int8_matmul(const void* x, const void* wq, const float* ws, const float* bias,
                               const float* a_s, void* out, int M, int N, int K, int mode,
                               void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 32 != 0 || N % 8 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kDynamic: return (int)dispatch<kDynamic>(x, wq, ws, bias, a_s, out, M, N, K, s);
    case kStatic: return (int)dispatch<kStatic>(x, wq, ws, bias, a_s, out, M, N, K, s);
    case kRaw: return (int)dispatch<kRaw>(x, wq, ws, bias, a_s, out, M, N, K, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

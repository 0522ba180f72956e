// K1: fused ConvNeXt MLP for Hopper, and K9, its pipelined design (below).
//
// Replaces vfm_vae_tpu/ops/pallas/fused_mlp.py:_fused (Pallas body _kernel).
//   out = x_in + gamma * ((GELU(bf16(x * A_b) @ W1^T * d_b + b1_b) -> bf16) @ W2^T + b2)
// with fp32 accumulation and the exact erf GELU. Rounding points match the
// plain twin: x*A is rounded to bf16 before GEMM1 and the GELU output is
// rounded to bf16 before GEMM2.
//
// Bound on the H100: two chained GEMMs of 2*T*C*4C flops each against one
// read of x and x_in and one write of out, so ~2C flops per byte: compute
// bound once the (T, 4C) hidden stays on chip. Design: one CTA per (sample,
// 32-token tile); the 4C hidden is walked in 64-column chunks whose GELU
// output lives only in shared memory, and the (32, C) output accumulator
// lives in registers across the whole walk. Weights are re-read from L2 by
// every CTA (no multicast, no wgmma, no TMA): a simple, right first version.
//
// Layouts: x, x_in, out (B, HW, C) bf16; A (B, C), d and b1 (B, 4C) fp32;
// W1 (4C, C) and W2 (C, 4C) bf16 in torch Linear layout (out, in); b2 and
// gamma (C,) fp32.
#include "common.cuh"

namespace {

using vfm::bf16;

constexpr int kMT = 32;       // tokens per CTA
constexpr int kHC = 64;       // hidden columns per chunk
constexpr int kThreads = 256;

__device__ __forceinline__ float gelu_erf(float v) {
  return 0.5f * v * (1.0f + erff(v * 0.70710678118654752f));
}

// The elementwise steps K1 and K9 share, written once so that both kernels
// compile them to the same instructions (K9 is bit-exact with K1).
// Hidden activation: GELU(acc * d + b1) with one explicit FMA.
__device__ __forceinline__ float hidden_act(float acc, float d, float b1) {
  return gelu_erf(__fmaf_rn(acc, d, b1));
}

// Output: (acc + b2) * gamma + x_in with one explicit FMA.
__device__ __forceinline__ float out_val(float acc, float b2, float gamma, float xin) {
  return __fmaf_rn(__fadd_rn(acc, b2), gamma, xin);
}

// Stage rows [tok0, tok0 + kMT) of bf16(x * A_b) into xs (ld C + 8); rows
// past HW are zero.
template <int C, int NT>
__device__ __forceinline__ void stage_xs(bf16* xs, const bf16* __restrict__ x,
                                         const float* __restrict__ A, int b, int tok0, int HW,
                                         int tid) {
  constexpr int LDX = C + 8;
  const size_t base = (size_t)b * HW * C;
  for (int i = tid; i < kMT * C / 8; i += NT) {
    const int r = i / (C / 8), c8 = (i % (C / 8)) * 8;
    const int tok = tok0 + r;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (tok < HW) v = *reinterpret_cast<const uint4*>(x + base + (size_t)tok * C + c8);
    const uint32_t* e = reinterpret_cast<const uint32_t*>(&v);
    uint4 o;
    uint32_t* oe = reinterpret_cast<uint32_t*>(&o);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = vfm::unpack_bf16(e[j]);
      oe[j] = vfm::pack_bf16(__fmul_rn(f.x, A[b * C + c8 + 2 * j]),
                             __fmul_rn(f.y, A[b * C + c8 + 2 * j + 1]));
    }
    *reinterpret_cast<uint4*>(xs + r * LDX + c8) = o;
  }
}

// out = (y + b2) * gamma + x_in, rounded to bf16, for this warp's
// (16 tokens) x (C/4 columns) accumulator.
template <int C>
__device__ __forceinline__ void store_out(const float (*acc2)[4], const bf16* __restrict__ xin,
                                          const float* __restrict__ b2,
                                          const float* __restrict__ gamma, bf16* __restrict__ out,
                                          int b, int tok0, int HW, int wm, int wn, int lane) {
  constexpr int NT2 = C / 32;
  const int g = lane >> 2, t = lane & 3;
  const size_t base = (size_t)b * HW * C;
#pragma unroll
  for (int nt = 0; nt < NT2; ++nt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int tok = tok0 + wm * 16 + g + half * 8;
      if (tok >= HW) continue;
      const int col = wn * (C / 4) + nt * 8 + 2 * t;
      const size_t off = base + (size_t)tok * C + col;
      const float2 xi = vfm::unpack_bf16(*reinterpret_cast<const uint32_t*>(xin + off));
      const float y0 = out_val(acc2[nt][half * 2 + 0], b2[col], gamma[col], xi.x);
      const float y1 = out_val(acc2[nt][half * 2 + 1], b2[col + 1], gamma[col + 1], xi.y);
      *reinterpret_cast<uint32_t*>(out + off) = vfm::pack_bf16(y0, y1);
    }
  }
}

template <int C>
constexpr size_t smem_bytes() {
  return sizeof(bf16) * (size_t)(kMT * (C + 8) + kHC * (C + 8) + kMT * (kHC + 8) + C * (kHC + 8));
}

template <int C>
__global__ void __launch_bounds__(kThreads) fused_convnext_mlp_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ xin, const float* __restrict__ A,
    const float* __restrict__ dco, const float* __restrict__ b1, const bf16* __restrict__ w1,
    const bf16* __restrict__ w2, const float* __restrict__ b2, const float* __restrict__ gamma,
    bf16* __restrict__ out, int HW) {
  constexpr int H4 = 4 * C;
  constexpr int LDX = C + 8;
  constexpr int LDH = kHC + 8;
  constexpr int NT2 = C / 32;  // n8 tiles per warp in GEMM2 (4 warps along N)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);  // [kMT][LDX]
  bf16* w1s = xs + kMT * LDX;                      // [kHC][LDX]
  bf16* hs = w1s + kHC * LDX;                      // [kMT][LDH]
  bf16* w2s = hs + kMT * LDH;                      // [C][LDH]

  const int b = blockIdx.y;
  const int tok0 = blockIdx.x * kMT;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 1;   // 2 warps along tokens (16 rows each)
  const int wn = warp >> 1;  // 4 warps along columns
  const int g = lane >> 2, t = lane & 3;

  stage_xs<C, kThreads>(xs, x, A, b, tok0, HW, tid);

  float acc2[NT2][4];
#pragma unroll
  for (int n = 0; n < NT2; ++n) acc2[n][0] = acc2[n][1] = acc2[n][2] = acc2[n][3] = 0.f;

  for (int hc = 0; hc < H4; hc += kHC) {
    __syncthreads();  // previous chunk fully consumed
    for (int i = tid; i < kHC * C / 8; i += kThreads) {
      const int r = i / (C / 8), c8 = (i % (C / 8)) * 8;
      *reinterpret_cast<uint4*>(w1s + r * LDX + c8) =
          *reinterpret_cast<const uint4*>(w1 + (size_t)(hc + r) * C + c8);
    }
    for (int i = tid; i < C * kHC / 8; i += kThreads) {
      const int r = i / (kHC / 8), c8 = (i % (kHC / 8)) * 8;
      *reinterpret_cast<uint4*>(w2s + r * LDH + c8) =
          *reinterpret_cast<const uint4*>(w2 + (size_t)r * H4 + hc + c8);
    }
    __syncthreads();

    // GEMM1: this warp's (16 tokens) x (16 hidden columns).
    float acc1[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll 4
    for (int k = 0; k < C; k += 16) {
      uint32_t a[4];
      vfm::load_a(a, xs + (wm * 16) * LDX + k, LDX, lane);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        uint32_t bb[2];
        vfm::load_b(bb, w1s + (wn * 16 + nt * 8) * LDX + k, LDX, lane);
        vfm::mma_16816(acc1[nt], a, bb);
      }
    }
    // Demodulate, fold bias, GELU, round to bf16 into the hidden tile.
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = wm * 16 + g + half * 8;
        const int col = wn * 16 + nt * 8 + 2 * t;
        const int hcol = b * H4 + hc + col;
        const float v0 = hidden_act(acc1[nt][half * 2 + 0], dco[hcol], b1[hcol]);
        const float v1 = hidden_act(acc1[nt][half * 2 + 1], dco[hcol + 1], b1[hcol + 1]);
        *reinterpret_cast<uint32_t*>(hs + row * LDH + col) = vfm::pack_bf16(v0, v1);
      }
    }
    __syncthreads();

    // GEMM2: accumulate (16 tokens) x (C/4 columns) += hidden chunk @ W2 chunk.
#pragma unroll
    for (int k = 0; k < kHC; k += 16) {
      uint32_t a[4];
      vfm::load_a(a, hs + (wm * 16) * LDH + k, LDH, lane);
#pragma unroll
      for (int nt = 0; nt < NT2; ++nt) {
        uint32_t bb[2];
        vfm::load_b(bb, w2s + (wn * (C / 4) + nt * 8) * LDH + k, LDH, lane);
        vfm::mma_16816(acc2[nt], a, bb);
      }
    }
  }

  store_out<C>(acc2, xin, b2, gamma, out, b, tok0, HW, wm, wn, lane);
}

// K9: the same function, software-pipelined. Replaces
// vfm_vae_tpu/ops/pallas/fused_mlp.py:_fused_pipelined (Pallas body
// _kernel_pipelined), which overlapped tile k's dot1 with tile k-1's dot2
// across grid steps. On the H100 the overlap is made inside the CTA's walk
// over the hidden dimension, in 32-column chunks: chunk j+1's expand
// (GEMM1) is issued before chunk j's demodulate + GELU and contract
// (GEMM2), so the tensor-core work of the next chunk is in flight while
// the CUDA cores run the GELU; and the W1/W2 chunk tiles are double
// buffered in shared memory, filled by cp.async one chunk ahead of use, so
// the weight loads no longer sit between two barriers on the critical
// path. Two barriers per chunk (K1: three per 64-column chunk).
//
// Bit-exact with K1: every hidden element is the same sequence of
// mma.sync tiles over C (same operand fragments, the same 8-column groups),
// the shared hidden_act/out_val helpers, and the output accumulator takes
// the hidden dimension in the same ascending 16-column steps.
constexpr int kHC9 = 32;

template <int C>
constexpr size_t smem_bytes_pipelined() {
  return sizeof(bf16) * (size_t)(kMT * (C + 8) + 2 * kHC9 * (C + 8) + 2 * C * (kHC9 + 8) +
                                 kMT * (kHC9 + 8));
}

// cp.async the W1 rows [hc, hc + kHC9) (each C wide) into dst (ld C + 8).
template <int C>
__device__ __forceinline__ void fetch_w1(bf16* dst, const bf16* __restrict__ w1, int hc, int tid) {
  for (int i = tid; i < kHC9 * C / 8; i += kThreads) {
    const int r = i / (C / 8), c8 = (i % (C / 8)) * 8;
    vfm::cp_async16(dst + r * (C + 8) + c8, w1 + (size_t)(hc + r) * C + c8);
  }
}

// cp.async the W2 columns [hc, hc + kHC9) of all C rows into dst (ld kHC9 + 8).
template <int C>
__device__ __forceinline__ void fetch_w2(bf16* dst, const bf16* __restrict__ w2, int hc, int tid) {
  for (int i = tid; i < C * kHC9 / 8; i += kThreads) {
    const int r = i / (kHC9 / 8), c8 = (i % (kHC9 / 8)) * 8;
    vfm::cp_async16(dst + r * (kHC9 + 8) + c8, w2 + (size_t)r * (4 * C) + hc + c8);
  }
}

template <int C>
__global__ void __launch_bounds__(kThreads) fused_convnext_mlp_pipelined_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ xin, const float* __restrict__ A,
    const float* __restrict__ dco, const float* __restrict__ b1, const bf16* __restrict__ w1,
    const bf16* __restrict__ w2, const float* __restrict__ b2, const float* __restrict__ gamma,
    bf16* __restrict__ out, int HW) {
  constexpr int H4 = 4 * C;
  constexpr int NCH = H4 / kHC9;
  constexpr int LDX = C + 8;
  constexpr int LDH = kHC9 + 8;
  constexpr int NT2 = C / 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);  // [kMT][LDX]
  bf16* w1b[2] = {xs + kMT * LDX, xs + kMT * LDX + kHC9 * LDX};  // [kHC9][LDX] each
  bf16* w2b[2] = {w1b[1] + kHC9 * LDX, w1b[1] + kHC9 * LDX + C * LDH};  // [C][LDH] each
  bf16* hs = w2b[1] + C * LDH;  // [kMT][LDH]

  const int b = blockIdx.y;
  const int tok0 = blockIdx.x * kMT;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 1;   // 2 warps along tokens (16 rows each)
  const int wn = warp >> 1;  // 4 warps along columns
  const int g = lane >> 2, t = lane & 3;

  // GEMM1 of one chunk: this warp's (16 tokens) x (8 hidden columns).
  auto gemm1 = [&](float acc[4], const bf16* w1s) {
    acc[0] = acc[1] = acc[2] = acc[3] = 0.f;
#pragma unroll 4
    for (int k = 0; k < C; k += 16) {
      uint32_t a[4], bb[2];
      vfm::load_a(a, xs + (wm * 16) * LDX + k, LDX, lane);
      vfm::load_b(bb, w1s + (wn * 8) * LDX + k, LDX, lane);
      vfm::mma_16816(acc, a, bb);
    }
  };

  fetch_w1<C>(w1b[0], w1, 0, tid);
  fetch_w1<C>(w1b[1], w1, kHC9, tid);
  fetch_w2<C>(w2b[0], w2, 0, tid);
  vfm::cp_async_commit();
  stage_xs<C, kThreads>(xs, x, A, b, tok0, HW, tid);
  vfm::cp_async_wait_all();
  __syncthreads();

  float acc2[NT2][4];
#pragma unroll
  for (int n = 0; n < NT2; ++n) acc2[n][0] = acc2[n][1] = acc2[n][2] = acc2[n][3] = 0.f;
  float acc1[4];
  gemm1(acc1, w1b[0]);

  for (int j = 0; j < NCH; ++j) {
    // W1 chunk j+1 and W2 chunk j have landed; chunk j-1 is fully consumed.
    vfm::cp_async_wait_all();
    __syncthreads();
    if (j + 2 < NCH) fetch_w1<C>(w1b[j & 1], w1, (j + 2) * kHC9, tid);
    if (j + 1 < NCH) fetch_w2<C>(w2b[(j + 1) & 1], w2, (j + 1) * kHC9, tid);
    vfm::cp_async_commit();

    // Chunk j+1's expand goes to the tensor cores before chunk j's GELU.
    float next[4] = {0.f, 0.f, 0.f, 0.f};
    if (j + 1 < NCH) gemm1(next, w1b[(j + 1) & 1]);

    // Chunk j: demodulate, fold bias, GELU, round to bf16 into the hidden tile.
    const int hc = j * kHC9;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = wm * 16 + g + half * 8;
      const int col = wn * 8 + 2 * t;
      const int hcol = b * H4 + hc + col;
      const float v0 = hidden_act(acc1[half * 2 + 0], dco[hcol], b1[hcol]);
      const float v1 = hidden_act(acc1[half * 2 + 1], dco[hcol + 1], b1[hcol + 1]);
      *reinterpret_cast<uint32_t*>(hs + row * LDH + col) = vfm::pack_bf16(v0, v1);
    }
    __syncthreads();

    // GEMM2: (16 tokens) x (C/4 columns) += hidden chunk j @ W2 chunk j.
#pragma unroll
    for (int k = 0; k < kHC9; k += 16) {
      uint32_t a[4];
      vfm::load_a(a, hs + (wm * 16) * LDH + k, LDH, lane);
#pragma unroll
      for (int nt = 0; nt < NT2; ++nt) {
        uint32_t bb[2];
        vfm::load_b(bb, w2b[j & 1] + (wn * (C / 4) + nt * 8) * LDH + k, LDH, lane);
        vfm::mma_16816(acc2[nt], a, bb);
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) acc1[e] = next[e];
  }

  store_out<C>(acc2, xin, b2, gamma, out, b, tok0, HW, wm, wn, lane);
}

template <int C, bool kPipelined>
cudaError_t launch(const void* x, const void* xin, const float* A, const float* d, const float* b1,
                   const void* w1, const void* w2, const float* b2, const float* gamma, void* out,
                   int B, int HW, cudaStream_t stream) {
  constexpr size_t smem = kPipelined ? smem_bytes_pipelined<C>() : smem_bytes<C>();
  auto kernel = kPipelined ? fused_convnext_mlp_pipelined_kernel<C> : fused_convnext_mlp_kernel<C>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((HW + kMT - 1) / kMT, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(xin), A, d, b1,
      static_cast<const bf16*>(w1), static_cast<const bf16*>(w2), b2, gamma,
      static_cast<bf16*>(out), HW);
  return cudaGetLastError();
}

template <bool kPipelined>
int dispatch(const void* x, const void* xin, const float* A, const float* d, const float* b1,
             const void* w1, const void* w2, const float* b2, const float* gamma, void* out,
             int B, int HW, int C, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 128: return launch<128, kPipelined>(x, xin, A, d, b1, w1, w2, b2, gamma, out, B, HW, s);
    case 256: return launch<256, kPipelined>(x, xin, A, d, b1, w1, w2, b2, gamma, out, B, HW, s);
    case 512: return launch<512, kPipelined>(x, xin, A, d, b1, w1, w2, b2, gamma, out, B, HW, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int vfm_fused_convnext_mlp(const void* x, const void* xin, const float* A,
                                      const float* d, const float* b1, const void* w1,
                                      const void* w2, const float* b2, const float* gamma,
                                      void* out, int B, int HW, int C, void* stream) {
  return dispatch<false>(x, xin, A, d, b1, w1, w2, b2, gamma, out, B, HW, C, stream);
}

// K9: the pipelined design, same arguments and bits as K1.
extern "C" int vfm_fused_convnext_mlp_pipelined(const void* x, const void* xin, const float* A,
                                                const float* d, const float* b1, const void* w1,
                                                const void* w2, const float* b2,
                                                const float* gamma, void* out, int B, int HW,
                                                int C, void* stream) {
  return dispatch<true>(x, xin, A, d, b1, w1, w2, b2, gamma, out, B, HW, C, stream);
}

extern "C" const char* vfm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

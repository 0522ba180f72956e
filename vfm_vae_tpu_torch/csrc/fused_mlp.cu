// K1: fused ConvNeXt MLP for Hopper.
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
  const size_t base = (size_t)b * HW * C;

  // Stage xs = bf16(x * A_b); rows past HW are zero.
  for (int i = tid; i < kMT * C / 8; i += kThreads) {
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
      oe[j] = vfm::pack_bf16(f.x * A[b * C + c8 + 2 * j], f.y * A[b * C + c8 + 2 * j + 1]);
    }
    *reinterpret_cast<uint4*>(xs + r * LDX + c8) = o;
  }

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
        const float v0 = gelu_erf(acc1[nt][half * 2 + 0] * dco[hcol] + b1[hcol]);
        const float v1 = gelu_erf(acc1[nt][half * 2 + 1] * dco[hcol + 1] + b1[hcol + 1]);
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

  // out = (y + b2) * gamma + x_in, rounded to bf16.
#pragma unroll
  for (int nt = 0; nt < NT2; ++nt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int tok = tok0 + wm * 16 + g + half * 8;
      if (tok >= HW) continue;
      const int col = wn * (C / 4) + nt * 8 + 2 * t;
      const size_t off = base + (size_t)tok * C + col;
      const float2 xi = vfm::unpack_bf16(*reinterpret_cast<const uint32_t*>(xin + off));
      const float y0 = (acc2[nt][half * 2 + 0] + b2[col]) * gamma[col] + xi.x;
      const float y1 = (acc2[nt][half * 2 + 1] + b2[col + 1]) * gamma[col + 1] + xi.y;
      *reinterpret_cast<uint32_t*>(out + off) = vfm::pack_bf16(y0, y1);
    }
  }
}

template <int C>
cudaError_t launch(const void* x, const void* xin, const float* A, const float* d, const float* b1,
                   const void* w1, const void* w2, const float* b2, const float* gamma, void* out,
                   int B, int HW, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<C>();
  cudaError_t err = cudaFuncSetAttribute(fused_convnext_mlp_kernel<C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((HW + kMT - 1) / kMT, B);
  fused_convnext_mlp_kernel<C><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(xin), A, d, b1,
      static_cast<const bf16*>(w1), static_cast<const bf16*>(w2), b2, gamma,
      static_cast<bf16*>(out), HW);
  return cudaGetLastError();
}

}  // namespace

extern "C" int vfm_fused_convnext_mlp(const void* x, const void* xin, const float* A,
                                      const float* d, const float* b1, const void* w1,
                                      const void* w2, const float* b2, const float* gamma,
                                      void* out, int B, int HW, int C, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 128: return launch<128>(x, xin, A, d, b1, w1, w2, b2, gamma, out, B, HW, s);
    case 256: return launch<256>(x, xin, A, d, b1, w1, w2, b2, gamma, out, B, HW, s);
    case 512: return launch<512>(x, xin, A, d, b1, w1, w2, b2, gamma, out, B, HW, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* vfm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

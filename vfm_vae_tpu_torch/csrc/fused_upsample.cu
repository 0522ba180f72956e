// K2: fused SeparableUpsampleWithFixedBlur (pre-normalized) for Hopper.
//
// Replaces vfm_vae_tpu/ops/pallas/fused_upsample.py:_fused (Pallas body
// _kernel) together with its plain-XLA vertical leg _vblur:
//   GN affine x*a+c -> bf16 -> depthwise 3x3 zero-SAME (fp32) -> bf16
//   -> pointwise Ci -> 4Co (fp32 accumulation) -> bf16 -> PixelShuffle(2)
//   (torch order c*4 + q) -> horizontal edge-replicate blur (fp32) -> bf16
//   -> vertical edge-replicate blur (fp32) -> bf16.
//
// Bound on the H100: the pointwise product is 8*H*W*Ci*Co flops against
// reads of x and writes of a 4x larger output, i.e. a few hundred flops per
// byte at Co >= 256 (compute bound) and memory bound at the 128-channel top
// site. Design: kernel 1 runs one CTA per (sample, input row, 62-pixel
// column band, 32 output channels). It computes the GN affine and the
// depthwise stencil on the fly while staging the GEMM's A tile (the
// normalized and depthwise maps never reach device memory), runs the
// per-subpixel products as one (64 x 128) tensor-core tile over all four
// subpixels, keeps the bf16 product tile in shared memory with a one-pixel
// halo on each side, and applies the horizontal blur leg there; the shuffle
// is folded into the store indices. Kernel 2 applies the vertical leg, which
// couples output rows across CTAs of kernel 1. The depthwise stencil is
// recomputed once per 32-channel output tile: simple first, fast later.
//
// Layouts: x (B, H, W, Ci) bf16; a, c (B, Ci) fp32; dw (Ci, 3, 3) fp32;
// pw (4Co, Ci) bf16 (torch (out, in)); out and the scratch map hblur are
// (B, 2H, 2W, Co) bf16. Ci % 32 == 0 and Co % 32 == 0.
#include "common.cuh"

namespace {

using vfm::bf16;

constexpr int kMT = 64;            // GEMM rows: input pixels w0-1 .. w0+62
constexpr int kOut = kMT - 2;      // useful input pixels per CTA
constexpr int kNC = 32;            // output channels per CTA
constexpr int kN = 4 * kNC;        // GEMM columns (c*4 + q)
constexpr int kKC = 32;            // K chunk over Ci
constexpr int kLDA = kKC + 8;
constexpr int kLDU = kN + 8;
constexpr int kThreads = 128;
constexpr int kMaxTaps = 5;

struct Taps {
  float w[kMaxTaps];
  int n;
};

__global__ void __launch_bounds__(kThreads) upsample_hblur_kernel(
    const bf16* __restrict__ x, const float* __restrict__ a, const float* __restrict__ c,
    const float* __restrict__ dw, const bf16* __restrict__ pw, bf16* __restrict__ hblur, int H,
    int W, int Ci, int Co, Taps taps) {
  __shared__ __align__(16) bf16 As[kMT * kLDA];
  __shared__ __align__(16) bf16 Bs[kN * kLDA];
  __shared__ __align__(16) bf16 Us[kMT * kLDU];

  const int w0 = blockIdx.x * kOut;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int c0 = blockIdx.z * kNC;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const size_t xrow = (size_t)W * Ci;
  const bf16* xb = x + (size_t)b * H * xrow;

  float acc[kN / 8][4];
#pragma unroll
  for (int n = 0; n < kN / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int k0 = 0; k0 < Ci; k0 += kKC) {
    __syncthreads();
    // A tile: depthwise 3x3 of the GN-affine input, 8 channels per task.
    for (int task = tid; task < kMT * (kKC / 8); task += kThreads) {
      const int r = task / (kKC / 8), k8 = k0 + (task % (kKC / 8)) * 8;
      const int w = w0 - 1 + r;
      float s[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (w >= 0 && w < W) {
        float av[8], cv[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          av[e] = a[b * Ci + k8 + e];
          cv[e] = c[b * Ci + k8 + e];
        }
        for (int dy = 0; dy < 3; ++dy) {
          const int hh = h + dy - 1;
          if (hh < 0 || hh >= H) continue;
          for (int dx = 0; dx < 3; ++dx) {
            const int ww = w + dx - 1;
            if (ww < 0 || ww >= W) continue;
            const uint4 v = *reinterpret_cast<const uint4*>(xb + hh * xrow + (size_t)ww * Ci + k8);
            const uint32_t* e32 = reinterpret_cast<const uint32_t*>(&v);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const float2 f = vfm::unpack_bf16(e32[j]);
              const int e0 = 2 * j, e1 = 2 * j + 1;
              const float n0 = __bfloat162float(__float2bfloat16_rn(f.x * av[e0] + cv[e0]));
              const float n1 = __bfloat162float(__float2bfloat16_rn(f.y * av[e1] + cv[e1]));
              s[e0] += n0 * dw[(k8 + e0) * 9 + dy * 3 + dx];
              s[e1] += n1 * dw[(k8 + e1) * 9 + dy * 3 + dx];
            }
          }
        }
      }
      uint4 o;
      uint32_t* o32 = reinterpret_cast<uint32_t*>(&o);
#pragma unroll
      for (int j = 0; j < 4; ++j) o32[j] = vfm::pack_bf16(s[2 * j], s[2 * j + 1]);
      *reinterpret_cast<uint4*>(As + r * kLDA + (k8 - k0)) = o;
    }
    // B tile: pointwise rows 4*c0 .. 4*c0+127 (all four subpixels of 32 channels).
    for (int task = tid; task < kN * (kKC / 8); task += kThreads) {
      const int n = task / (kKC / 8), k8 = (task % (kKC / 8)) * 8;
      *reinterpret_cast<uint4*>(Bs + n * kLDA + k8) =
          *reinterpret_cast<const uint4*>(pw + (size_t)(4 * c0 + n) * Ci + k0 + k8);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kKC; kk += 16) {
      uint32_t af[4];
      vfm::load_a(af, As + (warp * 16) * kLDA + kk, kLDA, lane);
#pragma unroll
      for (int nt = 0; nt < kN / 8; ++nt) {
        uint32_t bf[2];
        vfm::load_b(bf, Bs + (nt * 8) * kLDA + kk, kLDA, lane);
        vfm::mma_16816(acc[nt], af, bf);
      }
    }
  }

  // Product tile rounded to bf16, kept on chip.
#pragma unroll
  for (int nt = 0; nt < kN / 8; ++nt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = warp * 16 + g + half * 8;
      *reinterpret_cast<uint32_t*>(Us + r * kLDU + nt * 8 + 2 * t) =
          vfm::pack_bf16(acc[nt][half * 2], acc[nt][half * 2 + 1]);
    }
  }
  __syncthreads();

  // Shuffle + horizontal edge-replicate blur, two channels per thread.
  const int wend = min(w0 + kOut, W);
  const int nx = 2 * (wend - w0);  // output columns of this CTA per output row
  const int hb = taps.n / 2;
  const int W2 = 2 * W;
  for (int i = tid; i < 2 * nx * (kNC / 2); i += kThreads) {
    const int pix = i / (kNC / 2), cp = (i % (kNC / 2)) * 2;
    const int qi = pix / nx;
    const int X = 2 * w0 + pix % nx;
    float s0 = 0.f, s1 = 0.f;
    for (int j = 0; j < taps.n; ++j) {
      const int xs = min(max(X + j - hb, 0), W2 - 1);
      const int r = (xs >> 1) - (w0 - 1);
      const int q = qi * 2 + (xs & 1);
      s0 += __bfloat162float(Us[r * kLDU + cp * 4 + q]) * taps.w[j];
      s1 += __bfloat162float(Us[r * kLDU + (cp + 1) * 4 + q]) * taps.w[j];
    }
    const size_t off = (((size_t)b * 2 * H + 2 * h + qi) * W2 + X) * Co + c0 + cp;
    *reinterpret_cast<uint32_t*>(hblur + off) = vfm::pack_bf16(s0, s1);
  }
}

// Vertical edge-replicate blur over (B, H2, W2, Co), eight channels per thread.
__global__ void __launch_bounds__(256) vblur_kernel(const bf16* __restrict__ src,
                                                     bf16* __restrict__ dst, int B, int H2,
                                                     int W2, int Co, Taps taps) {
  const size_t n8 = (size_t)B * H2 * W2 * Co / 8;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n8) return;
  const size_t e0 = i * 8;
  const size_t row = (size_t)W2 * Co;
  const size_t img = (size_t)H2 * row;
  const int bb = (int)(e0 / img);
  const int y = (int)((e0 % img) / row);
  const size_t inrow = e0 % row;
  const int hb = taps.n / 2;
  float s[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int j = 0; j < taps.n; ++j) {
    const int ys = min(max(y + j - hb, 0), H2 - 1);
    const uint4 v = *reinterpret_cast<const uint4*>(src + bb * img + ys * row + inrow);
    const uint32_t* e32 = reinterpret_cast<const uint32_t*>(&v);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float2 f = vfm::unpack_bf16(e32[q]);
      s[2 * q] += f.x * taps.w[j];
      s[2 * q + 1] += f.y * taps.w[j];
    }
  }
  uint4 o;
  uint32_t* o32 = reinterpret_cast<uint32_t*>(&o);
#pragma unroll
  for (int q = 0; q < 4; ++q) o32[q] = vfm::pack_bf16(s[2 * q], s[2 * q + 1]);
  *reinterpret_cast<uint4*>(dst + e0) = o;
}

}  // namespace

extern "C" int vfm_fused_upsample_blur(const void* x, const float* a, const float* c,
                                       const float* dw, const void* pw, const float* taps_host,
                                       int kb, void* hblur, void* out, int B, int H, int W,
                                       int Ci, int Co, void* stream) {
  if (kb < 1 || kb > kMaxTaps || kb % 2 == 0 || Ci % kKC != 0 || Co % kNC != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Taps taps;
  taps.n = kb;
  for (int j = 0; j < kMaxTaps; ++j) taps.w[j] = j < kb ? taps_host[j] : 0.f;
  dim3 grid1((W + kOut - 1) / kOut, B * H, Co / kNC);
  upsample_hblur_kernel<<<grid1, kThreads, 0, s>>>(
      static_cast<const bf16*>(x), a, c, dw, static_cast<const bf16*>(pw),
      static_cast<bf16*>(hblur), H, W, Ci, Co, taps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t n8 = (size_t)B * 2 * H * 2 * W * Co / 8;
  const unsigned blocks = (unsigned)((n8 + 255) / 256);
  vblur_kernel<<<blocks, 256, 0, s>>>(static_cast<const bf16*>(hblur), static_cast<bf16*>(out),
                                      B, 2 * H, 2 * W, Co, taps);
  return (int)cudaGetLastError();
}

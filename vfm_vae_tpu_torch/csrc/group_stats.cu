// K5: per-(sample, channel) fp32 moments of a (B, H, W, C) map for Hopper.
//
// Replaces vfm_vae_tpu/ops/pallas/group_stats.py:_moments (Pallas body
// _kernel): s1 = sum over (H, W) of x, s2 = sum of x^2, both (B, C) fp32,
// the GroupNorm statistics that ops/groupnorm.py folds into groups.
//
// Bound on the H100: one read of x and three flops per element, so bytes
// bound (0.75 flop per byte in bf16). The TPU kernel walked the rows of one
// sample in sequence on one core; here that would leave the card nearly
// empty (one CTA per sample at C = 128), so the reduction is split in two
// fixed-order passes: (1) one CTA of 256 threads per (sample, row chunk,
// 128-channel block) reads its chunk with 16-byte loads, each thread
// summing its channels over a strided set of rows in fp32, then the CTA
// adds its row lanes in lane order and writes one fp32 partial per channel
// to a workspace; (2) sum_partials_kernel adds a sample's partials in chunk
// order in fp64. The chunk count depends only on the shape, and there are
// no float atomics, so two launches on the same input give the same bits.
//
// Layouts: x (B, HW, C) bf16 or fp32, C a multiple of 8 (bf16) or 4 (fp32);
// part (2, B, nchunk, C) fp32 workspace; s1, s2 (B, C) fp32.
#include "common.cuh"
#include "partials.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kCB = 128;  // channels per CTA

template <typename T>
struct Lanes {
  static constexpr int V = 16 / sizeof(T);   // channels per 16-byte load
  static constexpr int TX = kCB / V;         // threads across the channel block
  static constexpr int TY = kThreads / TX;   // row lanes
};

__device__ __forceinline__ void to_float(const uint4& u, const vfm::bf16*, float* f) {
  const uint32_t* e = reinterpret_cast<const uint32_t*>(&u);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 p = vfm::unpack_bf16(e[j]);
    f[2 * j] = p.x;
    f[2 * j + 1] = p.y;
  }
}

__device__ __forceinline__ void to_float(const uint4& u, const float*, float* f) {
  const float* e = reinterpret_cast<const float*>(&u);
#pragma unroll
  for (int j = 0; j < 4; ++j) f[j] = e[j];
}

template <typename T>
__global__ void __launch_bounds__(kThreads) moments_partial_kernel(
    const T* __restrict__ x, float* __restrict__ part1, float* __restrict__ part2, int HW, int C,
    int rows_per_chunk, int nchunk) {
  using L = Lanes<T>;
  __shared__ float red1[L::TY][kCB], red2[L::TY][kCB];
  const int chunk = blockIdx.x, cb = blockIdx.y, b = blockIdx.z;
  const int tx = threadIdx.x % L::TX, ty = threadIdx.x / L::TX;
  const int c0 = cb * kCB + tx * L::V;
  const int r0 = chunk * rows_per_chunk;
  const int r1 = min(HW, r0 + rows_per_chunk);
  float a1[L::V], a2[L::V];
#pragma unroll
  for (int j = 0; j < L::V; ++j) a1[j] = a2[j] = 0.f;
  if (c0 < C) {
    const T* base = x + (size_t)b * HW * C + c0;
    for (int r = r0 + ty; r < r1; r += L::TY) {
      const uint4 u = *reinterpret_cast<const uint4*>(base + (size_t)r * C);
      float f[L::V];
      to_float(u, x, f);
#pragma unroll
      for (int j = 0; j < L::V; ++j) {
        a1[j] += f[j];
        a2[j] = fmaf(f[j], f[j], a2[j]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < L::V; ++j) {
    red1[ty][tx * L::V + j] = a1[j];
    red2[ty][tx * L::V + j] = a2[j];
  }
  __syncthreads();
  const int c = threadIdx.x;
  if (c < kCB && cb * kCB + c < C) {
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int y = 0; y < L::TY; ++y) {
      s1 += red1[y][c];
      s2 += red2[y][c];
    }
    const size_t o = ((size_t)b * nchunk + chunk) * C + cb * kCB + c;
    part1[o] = s1;
    part2[o] = s2;
  }
}

template <typename T>
cudaError_t launch(const void* x, float* part, float* s1, float* s2, int B, int HW, int C,
                   int nchunk, cudaStream_t stream) {
  const int rows = (HW + nchunk - 1) / nchunk;
  float* part1 = part;
  float* part2 = part + (size_t)B * nchunk * C;
  dim3 grid(nchunk, (C + kCB - 1) / kCB, B);
  moments_partial_kernel<T><<<grid, kThreads, 0, stream>>>(static_cast<const T*>(x), part1,
                                                           part2, HW, C, rows, nchunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  sum_partials_kernel<<<(B * C + 255) / 256, 256, 0, stream>>>(part1, part2, s1, s2, B, nchunk, C);
  return cudaGetLastError();
}

}  // namespace

// s1, s2 (B, C) of x (B, HW, C); `part` holds 2 * B * nchunk * C floats.
// fp32 == 0: bf16 input, C % 8 == 0; fp32 == 1: fp32 input, C % 4 == 0.
extern "C" int vfm_channel_moments(const void* x, float* part, float* s1, float* s2, int B,
                                   int HW, int C, int nchunk, int fp32, void* stream) {
  if (B <= 0 || HW <= 0 || C <= 0 || nchunk <= 0 || C % (fp32 ? 4 : 8) != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fp32) return (int)launch<float>(x, part, s1, s2, B, HW, C, nchunk, s);
  return (int)launch<vfm::bf16>(x, part, s1, s2, B, HW, C, nchunk, s);
}

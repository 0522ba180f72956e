// K5: per-(sample, channel) fp32 moments of a (B, H, W, C) map for Hopper.
//
// Replaces vfm_vae_tpu/ops/pallas/group_stats.py:_moments (Pallas body
// _kernel): s1 = sum over (H, W) of x, s2 = sum of x^2, both (B, C) fp32,
// the GroupNorm statistics that ops/groupnorm.py folds into groups.
//
// Bound on the H100: one read of x and three flops per element, so bytes
// bound (0.75 flop per byte in bf16). The TPU kernel walked the rows of one
// sample in sequence on one core; here that would leave the card nearly
// empty (one CTA per sample at C = 128), so the rows are split into chunks
// over many CTAs and the chunks' partials summed in a fixed order. The
// first design did that in two launches (and three allocations a call);
// this one is one launch: every CTA of a (sample, 128-channel block) writes
// its fp32 partials to a workspace, and the last of them to arrive (a
// counter per block, incremented after a fence) adds the block's partials
// in chunk order in fp64 and resets the counter to 0 for the next call.
// The counters belong to a workspace that the wrapper keeps per (device,
// stream): calls on one stream run in order, so no two kernels share one.
// Each thread keeps kUnroll 16-byte loads in flight per loop trip, into as
// many accumulators, combined in a fixed order. The chunk count depends
// only on the shape, and no float is summed by an atomic, so two launches
// on the same input give the same bits.
//
// Layouts: x (B, HW, C) bf16 or fp32, C a multiple of 8 (bf16) or 4 (fp32);
// part (2, B, nchunk, C) fp32 and counters (B, ceil(C / 128)) int32 (zero
// between calls) workspace; s (2, B, C) fp32: s1 then s2.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kCB = 128;     // channels per CTA
constexpr int kUnroll = 4;   // 16-byte loads in flight per thread and loop trip
constexpr int kSplit = 4;    // thread groups of the last CTA's sum over chunks

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
__global__ void __launch_bounds__(kThreads) channel_moments_kernel(
    const T* __restrict__ x, float* __restrict__ part1, float* __restrict__ part2,
    int* __restrict__ counters, float* __restrict__ s1, float* __restrict__ s2, int B, int HW,
    int C, int rows_per_chunk, int nchunk) {
  using L = Lanes<T>;
  __shared__ float red1[L::TY][kCB], red2[L::TY][kCB];
  __shared__ double fin[kSplit][2][kCB];
  __shared__ int last;
  const int chunk = blockIdx.x, cb = blockIdx.y, b = blockIdx.z;
  const int tx = threadIdx.x % L::TX, ty = threadIdx.x / L::TX;
  const int c0 = cb * kCB + tx * L::V;
  const int r0 = chunk * rows_per_chunk;
  const int r1 = min(HW, r0 + rows_per_chunk);
  float a1[kUnroll][L::V], a2[kUnroll][L::V];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u)
#pragma unroll
    for (int j = 0; j < L::V; ++j) a1[u][j] = a2[u][j] = 0.f;
  if (c0 < C) {
    const T* base = x + (size_t)b * HW * C + c0;
    for (int r = r0 + ty; r < r1; r += kUnroll * L::TY) {
      uint4 v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int rr = r + u * L::TY;
        v[u] = rr < r1 ? __ldg(reinterpret_cast<const uint4*>(base + (size_t)rr * C))
                       : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        float f[L::V];
        to_float(v[u], x, f);
#pragma unroll
        for (int j = 0; j < L::V; ++j) {
          a1[u][j] += f[j];
          a2[u][j] = fmaf(f[j], f[j], a2[u][j]);
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < L::V; ++j) {
    float t1 = a1[0][j], t2 = a2[0][j];
#pragma unroll
    for (int u = 1; u < kUnroll; ++u) {
      t1 += a1[u][j];
      t2 += a2[u][j];
    }
    red1[ty][tx * L::V + j] = t1;
    red2[ty][tx * L::V + j] = t2;
  }
  __syncthreads();
  const int c = threadIdx.x;
  const size_t row = (size_t)b * nchunk;  // this block's partials: rows row .. row + nchunk - 1
  if (c < kCB && cb * kCB + c < C) {
    float t1 = 0.f, t2 = 0.f;
#pragma unroll
    for (int y = 0; y < L::TY; ++y) {
      t1 += red1[y][c];
      t2 += red2[y][c];
    }
    const size_t o = (row + chunk) * C + cb * kCB + c;
    part1[o] = t1;
    part2[o] = t2;
  }
  // The last CTA of the block to finish adds the block's partials.
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    int* counter = counters + b * gridDim.y + cb;
    last = atomicAdd(counter, 1) == nchunk - 1;
    if (last) *counter = 0;  // every CTA of the block has arrived: ready for the next call
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  // Thread group g (of kSplit) sums chunks [g n / kSplit, (g + 1) n / kSplit)
  // of one moment for 4 channels in fp64; the groups are then added in order.
  const int g = threadIdx.x / (kThreads / kSplit), t = threadIdx.x % (kThreads / kSplit);
  const int m = t / (kCB / 4), cc = 4 * (t % (kCB / 4));
  double d[4] = {0.0, 0.0, 0.0, 0.0};
  if (cb * kCB + cc < C) {
    const float* p = (m ? part2 : part1) + row * C + cb * kCB + cc;
    const int j1 = (g + 1) * nchunk / kSplit;
    int j = g * nchunk / kSplit;
    for (; j + 4 <= j1; j += 4) {
      float4 v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        v[u] = __ldcg(reinterpret_cast<const float4*>(p + (size_t)(j + u) * C));
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        d[0] += (double)v[u].x;
        d[1] += (double)v[u].y;
        d[2] += (double)v[u].z;
        d[3] += (double)v[u].w;
      }
    }
    for (; j < j1; ++j) {
      const float4 v = __ldcg(reinterpret_cast<const float4*>(p + (size_t)j * C));
      d[0] += (double)v.x;
      d[1] += (double)v.y;
      d[2] += (double)v.z;
      d[3] += (double)v.w;
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) fin[g][m][cc + i] = d[i];
  __syncthreads();
  const int mm = threadIdx.x / kCB, ch = threadIdx.x % kCB;
  if (cb * kCB + ch < C) {
    double s = fin[0][mm][ch];
#pragma unroll
    for (int q = 1; q < kSplit; ++q) s += fin[q][mm][ch];
    (mm ? s2 : s1)[(size_t)b * C + cb * kCB + ch] = (float)s;
  }
}

template <typename T>
cudaError_t launch(const void* x, float* part, int* counters, float* s, int B, int HW, int C,
                   int nchunk, cudaStream_t stream) {
  const int rows = (HW + nchunk - 1) / nchunk;
  float* part1 = part;
  float* part2 = part + (size_t)B * nchunk * C;
  dim3 grid(nchunk, (C + kCB - 1) / kCB, B);
  channel_moments_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), part1, part2, counters, s, s + (size_t)B * C, B, HW, C, rows,
      nchunk);
  return cudaGetLastError();
}

}  // namespace

// s (2, B, C): the sums s1 and s2 of x (B, HW, C); `part` holds 2 * B * nchunk
// * C floats and `counters` B * ceil(C / 128) ints that are 0 (and are 0
// again when the kernel ends). fp32 == 0: bf16 input, C % 8 == 0; fp32 == 1:
// fp32 input, C % 4 == 0.
extern "C" int vfm_channel_moments(const void* x, float* part, int* counters, float* s, int B,
                                   int HW, int C, int nchunk, int fp32, void* stream) {
  if (B <= 0 || HW <= 0 || C <= 0 || nchunk <= 0 || C % (fp32 ? 4 : 8) != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (fp32) return (int)launch<float>(x, part, counters, s, B, HW, C, nchunk, st);
  return (int)launch<vfm::bf16>(x, part, counters, s, B, HW, C, nchunk, st);
}

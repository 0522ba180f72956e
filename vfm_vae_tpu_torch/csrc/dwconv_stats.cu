// K7 and K8: depthwise k x k stride-1 SAME convolution for Hopper, with
// bias + legacy noise + fp32 moment sums (K7) or bias alone (K8).
//
// K7 replaces vfm_vae_tpu/ops/pallas/dwconv_stats.py:_fused (Pallas body
// _kernel): t = round(conv(x, w)) + b (+ noise), each add in the activation
// dtype, and s1 = sum over (H, W) of t, s2 = sum of t^2, per (sample,
// channel) in fp32, of the rounded t. K8 replaces
// vfm_vae_tpu/ops/pallas/dwconv.py:_dwconv_same (Pallas body _dw_kernel):
// t = round(conv(x, w) + b), the bias added in fp32 before the one rounding.
// The two rounding orders are those of the TPU kernels and the twins.
//
// Bound on the H100: 2 k^2 fp32 flops on the CUDA cores per output element
// against 4 bytes (bf16 in and out), ~25 flops per byte at k = 7: near the
// fp32 ridge (67 TFLOP/s over 3.35 TB/s, ~20). Design: one CTA of 256
// threads per (8-row x 16-column tile, 64-channel block, sample). The tile
// and its k/2 halo are staged once in shared memory (zero outside the image,
// so halo rows add nothing to the sums), the k^2 weights of the block too;
// warp w computes output row w, each lane two adjacent channels over the 16
// columns, sliding a (16 + k - 1)-column window of one input row through
// registers per kernel row. K7's statistics follow K5's fixed-order
// two-stage reduction: each lane sums its valid outputs, the CTA adds its 8
// rows in row order into one fp32 partial per channel and tile, and
// sum_partials_kernel adds a sample's tiles in tile order in fp64.
//
// Layouts: x, out (B, H, W, C) bf16, C a multiple of 64; w (k, k, C) fp32;
// b (C,) fp32 or null; noise (H, W) fp32 or null; part (2, B, ntiles, C)
// fp32 workspace; s1, s2 (B, C) fp32. K7 rounds w, b and the noise to bf16
// as it reads them, as the twin casts them to x's dtype.
#include "common.cuh"
#include "partials.cuh"

namespace {

using vfm::bf16;

constexpr int kTH = 8;       // output rows per tile (one per warp)
constexpr int kTW = 16;      // output columns per tile
constexpr int kCB = 64;      // channels per CTA (two per lane)
constexpr int kThreads = 256;

template <int K>
constexpr size_t smem_bytes() {
  return sizeof(bf16) * (size_t)((kTH + K - 1) * (kTW + K - 1) * kCB) +
         sizeof(float) * (size_t)(K * K * kCB + 2 * kTH * kCB);
}

// kStats: K7 (round, + b, + noise in bf16, moment partials); else K8.
template <int K, bool kStats>
__global__ void __launch_bounds__(kThreads) dwconv_kernel(
    const bf16* __restrict__ x, const float* __restrict__ w, const float* __restrict__ bias,
    const float* __restrict__ noise, bf16* __restrict__ out, float* __restrict__ part1,
    float* __restrict__ part2, int H, int W, int C, int tiles_w, int ntiles) {
  constexpr int P = K / 2;
  constexpr int IH = kTH + K - 1, IW = kTW + K - 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);                  // [IH][IW][kCB]
  float* ws = reinterpret_cast<float*>(xs + IH * IW * kCB);      // [K*K][kCB]
  float* red = ws + K * K * kCB;                                 // [2][kTH][kCB]

  const int tile = blockIdx.x, cb = blockIdx.y, b = blockIdx.z;
  const int h0 = (tile / tiles_w) * kTH, w0 = (tile % tiles_w) * kTW;
  const int c0 = cb * kCB;
  const int tid = threadIdx.x, lane = tid & 31, row = tid >> 5;
  const size_t img = (size_t)b * H * W * C;

  // Input tile with its halo, eight channels (16 bytes) per load.
  for (int i = tid; i < IH * IW * (kCB / 8); i += kThreads) {
    const int p = i / (kCB / 8), c8 = (i % (kCB / 8)) * 8;
    const int hh = h0 - P + p / IW, ww = w0 - P + p % IW;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (hh >= 0 && hh < H && ww >= 0 && ww < W)
      v = *reinterpret_cast<const uint4*>(x + img + ((size_t)hh * W + ww) * C + c0 + c8);
    *reinterpret_cast<uint4*>(xs + p * kCB + c8) = v;
  }
  for (int i = tid; i < K * K * kCB; i += kThreads) {
    const float wv = w[(size_t)(i / kCB) * C + c0 + i % kCB];
    ws[i] = kStats ? vfm::round_bf16(wv) : wv;
  }
  __syncthreads();

  float acc[kTW][2];
#pragma unroll
  for (int o = 0; o < kTW; ++o) acc[o][0] = acc[o][1] = 0.f;
#pragma unroll 1
  for (int dy = 0; dy < K; ++dy) {
    float2 in[IW];
#pragma unroll
    for (int j = 0; j < IW; ++j)
      in[j] = vfm::unpack_bf16(
          *reinterpret_cast<const uint32_t*>(xs + ((row + dy) * IW + j) * kCB + 2 * lane));
#pragma unroll
    for (int dx = 0; dx < K; ++dx) {
      const float2 wv = *reinterpret_cast<const float2*>(ws + (dy * K + dx) * kCB + 2 * lane);
#pragma unroll
      for (int o = 0; o < kTW; ++o) {
        acc[o][0] = fmaf(in[o + dx].x, wv.x, acc[o][0]);
        acc[o][1] = fmaf(in[o + dx].y, wv.y, acc[o][1]);
      }
    }
  }

  const int c = c0 + 2 * lane;
  const int hh = h0 + row;
  float b0 = bias != nullptr ? bias[c] : 0.f, b1 = bias != nullptr ? bias[c + 1] : 0.f;
  if (kStats) {
    b0 = vfm::round_bf16(b0);
    b1 = vfm::round_bf16(b1);
  }
  float s1[2] = {0.f, 0.f}, s2[2] = {0.f, 0.f};
#pragma unroll
  for (int o = 0; o < kTW; ++o) {
    const int ww = w0 + o;
    if (hh >= H || ww >= W) continue;
    float t0, t1;
    if constexpr (kStats) {
      // fp32 accumulator -> bf16, then + bias, + noise, each add in bf16.
      t0 = vfm::round_bf16(vfm::round_bf16(acc[o][0]) + b0);
      t1 = vfm::round_bf16(vfm::round_bf16(acc[o][1]) + b1);
      if (noise != nullptr) {
        const float n = vfm::round_bf16(noise[(size_t)hh * W + ww]);
        t0 = vfm::round_bf16(t0 + n);
        t1 = vfm::round_bf16(t1 + n);
      }
      s1[0] += t0;
      s1[1] += t1;
      s2[0] = fmaf(t0, t0, s2[0]);
      s2[1] = fmaf(t1, t1, s2[1]);
    } else {
      t0 = acc[o][0] + b0;
      t1 = acc[o][1] + b1;
    }
    *reinterpret_cast<uint32_t*>(out + img + ((size_t)hh * W + ww) * C + c) =
        vfm::pack_bf16(t0, t1);
  }
  if constexpr (kStats) {
    red[row * kCB + 2 * lane] = s1[0];
    red[row * kCB + 2 * lane + 1] = s1[1];
    red[(kTH + row) * kCB + 2 * lane] = s2[0];
    red[(kTH + row) * kCB + 2 * lane + 1] = s2[1];
    __syncthreads();
    if (tid < kCB) {
      float a1 = 0.f, a2 = 0.f;
#pragma unroll
      for (int r = 0; r < kTH; ++r) {
        a1 += red[r * kCB + tid];
        a2 += red[(kTH + r) * kCB + tid];
      }
      const size_t o = ((size_t)b * ntiles + tile) * C + c0 + tid;
      part1[o] = a1;
      part2[o] = a2;
    }
  }
}

template <int K, bool kStats>
cudaError_t launch(const void* x, const float* w, const float* b, const float* noise, void* out,
                   float* part, float* s1, float* s2, int B, int H, int W, int C,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<K>();
  cudaError_t err = cudaFuncSetAttribute(dwconv_kernel<K, kStats>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int tiles_w = (W + kTW - 1) / kTW;
  const int ntiles = tiles_w * ((H + kTH - 1) / kTH);
  float* part1 = part;
  float* part2 = part ? part + (size_t)B * ntiles * C : nullptr;
  dim3 grid(ntiles, C / kCB, B);
  dwconv_kernel<K, kStats><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(x), w, b, noise, static_cast<bf16*>(out), part1, part2, H, W, C,
      tiles_w, ntiles);
  err = cudaGetLastError();
  if (err != cudaSuccess || !kStats) return err;
  sum_partials_kernel<<<(B * C + 255) / 256, 256, 0, stream>>>(part1, part2, s1, s2, B, ntiles, C);
  return cudaGetLastError();
}

}  // namespace

// Tiles per (sample, channel block) of an H x W map: the workspace of K7 is
// 2 * B * tiles * C floats.
extern "C" int vfm_dwconv_tiles(int H, int W) {
  return ((W + kTW - 1) / kTW) * ((H + kTH - 1) / kTH);
}

// K7: t, s1, s2 of x; k in {5, 7}; b and `part` required, noise optional.
extern "C" int vfm_dwconv_noise_stats(const void* x, const float* w, const float* b,
                                      const float* noise, void* out, float* part, float* s1,
                                      float* s2, int B, int H, int W, int C, int k, void* stream) {
  if (C % kCB != 0 || b == nullptr || part == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k == 5) return (int)launch<5, true>(x, w, b, noise, out, part, s1, s2, B, H, W, C, s);
  if (k == 7) return (int)launch<7, true>(x, w, b, noise, out, part, s1, s2, B, H, W, C, s);
  return (int)cudaErrorInvalidValue;
}

// K8: t of x; k in {3, 5, 7}; b optional.
extern "C" int vfm_depthwise_conv2d_same(const void* x, const float* w, const float* b,
                                         void* out, int B, int H, int W, int C, int k,
                                         void* stream) {
  if (C % kCB != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k == 3) return (int)launch<3, false>(x, w, b, nullptr, out, nullptr, nullptr, nullptr, B, H,
                                           W, C, s);
  if (k == 5) return (int)launch<5, false>(x, w, b, nullptr, out, nullptr, nullptr, nullptr, B, H,
                                           W, C, s);
  if (k == 7) return (int)launch<7, false>(x, w, b, nullptr, out, nullptr, nullptr, nullptr, B, H,
                                           W, C, s);
  return (int)cudaErrorInvalidValue;
}

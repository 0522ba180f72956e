// K3: flash attention with a learned null key/value, forward, for Hopper.
//
// Replaces vfm_vae_tpu/ops/pallas/flash_attention.py:flash_attention_nullkv
// (jax's library Pallas TPU flash kernel behind a pad-to-128 + segment-id
// mask). Computes softmax(q [null_k; k]^T * scale) [null_v; v] per (sample,
// head) with the online softmax in fp32.
//
// Bound on the H100: at the decoder's T <= 1024 and d = 64, 4*T*T*d flops
// against 4*T*d*2 bytes per head, i.e. ~T/2 flops per byte: compute bound,
// and the (T, T+1) logits must never reach device memory. Design: one CTA
// of four warps per (64-query tile, head, sample); each warp owns 16 query
// rows. Keys are walked in 64-key tiles of the virtual sequence
// [null; k_0 .. k_{T-1}]: key 0 is read from the null pointer, key j >= 1
// from k[j-1], keys past T are masked to -inf. No concat, no padding to 128,
// no segment ids; any T works (the decoder runs 64, 256 and 1024). S = QK^T
// and O += PV are mma.sync bf16 tiles; P is rounded to bf16 for the PV
// product, as every flash kernel does.
//
// Training mode: given an `lse` pointer, the kernel also writes each query
// row's log-sum-exp over [null; k] (natural-log units, fp32), the residual
// that the backward kernels (flash_attention_nullkv_bwd.cu) recompute P from.
//
// Layouts: q, k, v, out (B, T, N, 64) bf16; null_k, null_v (B, 1, N, 64) bf16;
// lse (B, N, T) fp32 or null.
#include "common.cuh"

namespace {

using vfm::bf16;

constexpr int kD = 64;
constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kLD = kD + 8;
constexpr int kLDV = kBK + 8;
constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads) flash_nullkv_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ nk, const bf16* __restrict__ nv, bf16* __restrict__ out,
    float* __restrict__ lse, int T, int N, float scale_log2) {
  __shared__ __align__(16) bf16 qs[kBQ * kLD];
  __shared__ __align__(16) bf16 ks[kBK * kLD];    // [key][d]
  __shared__ __align__(16) bf16 vts[kD * kLDV];   // [d][key]

  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const size_t rs = (size_t)N * kD;  // stride between tokens
  const size_t head = (size_t)b * T * rs + (size_t)h * kD;
  const size_t nhead = (size_t)b * rs + (size_t)h * kD;

  for (int i = tid; i < kBQ * kD / 8; i += kThreads) {
    const int r = i / (kD / 8), c8 = (i % (kD / 8)) * 8;
    const int tok = q0 + r;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (tok < T) val = *reinterpret_cast<const uint4*>(q + head + tok * rs + c8);
    *reinterpret_cast<uint4*>(qs + r * kLD + c8) = val;
  }

  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  float o[kD / 8][4];
#pragma unroll
  for (int n = 0; n < kD / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

  const int Tk = T + 1;
  for (int kb = 0; kb < Tk; kb += kBK) {
    __syncthreads();
    for (int i = tid; i < kBK * kD / 8; i += kThreads) {
      const int r = i / (kD / 8), c8 = (i % (kD / 8)) * 8;
      const int j = kb + r;
      uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
      if (j == 0) {
        kv = *reinterpret_cast<const uint4*>(nk + nhead + c8);
        vv = *reinterpret_cast<const uint4*>(nv + nhead + c8);
      } else if (j <= T) {
        kv = *reinterpret_cast<const uint4*>(k + head + (size_t)(j - 1) * rs + c8);
        vv = *reinterpret_cast<const uint4*>(v + head + (size_t)(j - 1) * rs + c8);
      }
      *reinterpret_cast<uint4*>(ks + r * kLD + c8) = kv;
      const bf16* ve = reinterpret_cast<const bf16*>(&vv);
#pragma unroll
      for (int e = 0; e < 8; ++e) vts[(c8 + e) * kLDV + r] = ve[e];
    }
    __syncthreads();

    float s[kBK / 8][4];
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kD; kk += 16) {
      uint32_t af[4];
      vfm::load_a(af, qs + (warp * 16) * kLD + kk, kLD, lane);
#pragma unroll
      for (int nt = 0; nt < kBK / 8; ++nt) {
        uint32_t bf[2];
        vfm::load_b(bf, ks + (nt * 8) * kLD + kk, kLD, lane);
        vfm::mma_16816(s[nt], af, bf);
      }
    }

    // Scale into log2 units, mask keys past the sequence, online softmax.
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = kb + nt * 8 + 2 * t + (e & 1);
        s[nt][e] = j < Tk ? s[nt][e] * scale_log2 : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
      }
    }
    float alpha[2], rowsum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float mnew = fmaxf(m[r], mx[r]);  // finite: key kb is always valid
      alpha[r] = exp2f(m[r] - mnew);
      m[r] = mnew;
    }
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = exp2f(s[nt][e] - m[e >> 1]);
        rowsum[e >> 1] += s[nt][e];
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rowsum[r] += __shfl_xor_sync(0xffffffffu, rowsum[r], 1);
      rowsum[r] += __shfl_xor_sync(0xffffffffu, rowsum[r], 2);
      l[r] = l[r] * alpha[r] + rowsum[r];
    }
#pragma unroll
    for (int n = 0; n < kD / 8; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

    // O += P V with P's accumulator fragments reused as A fragments.
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t af[4];
      af[0] = vfm::pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      af[1] = vfm::pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      af[2] = vfm::pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      af[3] = vfm::pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int nt = 0; nt < kD / 8; ++nt) {
        uint32_t bf[2];
        vfm::load_b(bf, vts + (nt * 8) * kLDV + kk * 16, kLDV, lane);
        vfm::mma_16816(o[nt], af, bf);
      }
    }
  }

  const float inv[2] = {1.f / l[0], 1.f / l[1]};
#pragma unroll
  for (int nt = 0; nt < kD / 8; ++nt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int tok = q0 + warp * 16 + g + half * 8;
      if (tok >= T) continue;
      const int col = nt * 8 + 2 * t;
      *reinterpret_cast<uint32_t*>(out + head + (size_t)tok * rs + col) =
          vfm::pack_bf16(o[nt][half * 2] * inv[half], o[nt][half * 2 + 1] * inv[half]);
    }
  }
  if (lse != nullptr && t == 0) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int tok = q0 + warp * 16 + g + half * 8;
      if (tok < T)
        lse[((size_t)b * N + h) * T + tok] = (m[half] + log2f(l[half])) * 0.6931471805599453f;
    }
  }
}

}  // namespace

extern "C" int vfm_flash_attention_nullkv(const void* q, const void* k, const void* v,
                                          const void* null_k, const void* null_v, void* out,
                                          float* lse, int B, int T, int N, int D, float scale,
                                          void* stream) {
  if (D != kD) return (int)cudaErrorInvalidValue;
  const float scale_log2 = scale * 1.4426950408889634f;
  dim3 grid((T + kBQ - 1) / kBQ, N, B);
  flash_nullkv_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(null_k), static_cast<const bf16*>(null_v), static_cast<bf16*>(out),
      lse, T, N, scale_log2);
  return (int)cudaGetLastError();
}

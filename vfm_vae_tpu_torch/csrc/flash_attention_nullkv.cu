// K3 and K4: flash attention forward for Hopper, with a learned null
// key/value (K3) or without one (K4).
//
// K3 replaces vfm_vae_tpu/ops/pallas/flash_attention.py:flash_attention_nullkv
// (jax's library Pallas TPU flash kernel behind a pad-to-128 + segment-id
// mask): softmax(q [null_k; k]^T * scale) [null_v; v] per (sample, head).
// K4 replaces vfm_vae_tpu/ops/pallas/flash_attention.py:flash_attention (the
// same library kernel without the null token, full-sequence blocks):
// softmax(q k^T * scale) v, for the SigLIP tower and the adapter's
// AttnProjections. Both keep the online softmax in fp32.
//
// Bound on the H100: at T <= 1024 and d = 64, 4*Tq*Tk*d flops against
// 2*(Tq + 2*Tk)*d bytes per head, i.e. ~T/2 flops per byte: compute bound,
// and the (Tq, Tk) logits must never reach device memory.
//
// bf16 design: one CTA of four warps per (64-query tile, head, sample); each
// warp owns 16 query rows. Keys are walked in 64-key tiles of the virtual
// sequence [null; k_0 .. k_{Tk-1}] (K3) or [k_0 .. k_{Tk-1}] (K4): with a null
// pointer key 0 is read from it, otherwise the walk starts at k's key 0; keys
// past the sequence are masked to -inf. No concat, no padding, no segment
// ids; any Tq, Tk work. S = QK^T and O += PV are mma.sync bf16 tiles; P is
// rounded to bf16 for the PV product, as every flash kernel does. The head
// dim is a template parameter (64, or 128 for K4).
//
// fp32 design (K4 at the adapter, which computes in fp32 in both packages):
// fp32 FMA on the CUDA cores, no TF32. One CTA of 256 threads per (64-query
// tile, head, sample); thread (ty, tx) owns query rows 4ty..4ty+3, keys
// tx + 16i of each 64-key tile and output columns 4tx.. (+64); P goes through
// shared memory between the two products.
//
// Training mode: given an `lse` pointer, the kernel (bf16 or fp32) also
// writes each query row's log-sum-exp over the walk (natural-log units,
// fp32), the residual that the backward kernels
// (flash_attention_nullkv_bwd.cu) recompute P from.
//
// Layouts: q, out (B, Tq, N, D); k, v (B, Tk, N, D); null_k, null_v
// (B, 1, N, D) or null; bf16 or (K4) fp32; lse (B, N, Tq) fp32 or null.
#include "common.cuh"

namespace {

using vfm::bf16;

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 128;
constexpr int kThreadsF32 = 256;

template <int D>
constexpr size_t smem_bf16() {
  return sizeof(bf16) * (size_t)(kBQ * (D + 8) + kBK * (D + 8) + D * (kBK + 8));
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ nk, const bf16* __restrict__ nv, bf16* __restrict__ out,
    float* __restrict__ lse, int Tq, int Tk, int N, float scale_log2) {
  constexpr int LD = D + 8;
  constexpr int LDV = kBK + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [query][d]
  bf16* ks = qs + kBQ * LD;                       // [key][d]
  bf16* vts = ks + kBK * LD;                      // [d][key]

  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int has_null = nk != nullptr;
  const size_t rs = (size_t)N * D;  // stride between tokens
  const size_t qhead = (size_t)b * Tq * rs + (size_t)h * D;
  const size_t khead = (size_t)b * Tk * rs + (size_t)h * D;
  const size_t nhead = (size_t)b * rs + (size_t)h * D;

  for (int i = tid; i < kBQ * D / 8; i += kThreads) {
    const int r = i / (D / 8), c8 = (i % (D / 8)) * 8;
    const int tok = q0 + r;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (tok < Tq) val = *reinterpret_cast<const uint4*>(q + qhead + tok * rs + c8);
    *reinterpret_cast<uint4*>(qs + r * LD + c8) = val;
  }

  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

  const int Tv = Tk + has_null;  // keys of the walk
  for (int kb = 0; kb < Tv; kb += kBK) {
    __syncthreads();
    for (int i = tid; i < kBK * D / 8; i += kThreads) {
      const int r = i / (D / 8), c8 = (i % (D / 8)) * 8;
      const int j = kb + r, jk = j - has_null;
      uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
      if (has_null && j == 0) {
        kv = *reinterpret_cast<const uint4*>(nk + nhead + c8);
        vv = *reinterpret_cast<const uint4*>(nv + nhead + c8);
      } else if (jk < Tk) {
        kv = *reinterpret_cast<const uint4*>(k + khead + (size_t)jk * rs + c8);
        vv = *reinterpret_cast<const uint4*>(v + khead + (size_t)jk * rs + c8);
      }
      *reinterpret_cast<uint4*>(ks + r * LD + c8) = kv;
      const bf16* ve = reinterpret_cast<const bf16*>(&vv);
#pragma unroll
      for (int e = 0; e < 8; ++e) vts[(c8 + e) * LDV + r] = ve[e];
    }
    __syncthreads();

    float s[kBK / 8][4];
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D; kk += 16) {
      uint32_t af[4];
      vfm::load_a(af, qs + (warp * 16) * LD + kk, LD, lane);
#pragma unroll
      for (int nt = 0; nt < kBK / 8; ++nt) {
        uint32_t bf[2];
        vfm::load_b(bf, ks + (nt * 8) * LD + kk, LD, lane);
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
        s[nt][e] = j < Tv ? s[nt][e] * scale_log2 : -INFINITY;
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
    for (int n = 0; n < D / 8; ++n) {
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
      for (int nt = 0; nt < D / 8; ++nt) {
        uint32_t bf[2];
        vfm::load_b(bf, vts + (nt * 8) * LDV + kk * 16, LDV, lane);
        vfm::mma_16816(o[nt], af, bf);
      }
    }
  }

  const float inv[2] = {1.f / l[0], 1.f / l[1]};
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int tok = q0 + warp * 16 + g + half * 8;
      if (tok >= Tq) continue;
      const int col = nt * 8 + 2 * t;
      *reinterpret_cast<uint32_t*>(out + qhead + (size_t)tok * rs + col) =
          vfm::pack_bf16(o[nt][half * 2] * inv[half], o[nt][half * 2 + 1] * inv[half]);
    }
  }
  if (lse != nullptr && t == 0) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int tok = q0 + warp * 16 + g + half * 8;
      if (tok < Tq)
        lse[((size_t)b * N + h) * Tq + tok] = (m[half] + log2f(l[half])) * 0.6931471805599453f;
    }
  }
}

template <int D>
constexpr size_t smem_f32() {
  return sizeof(float) * (size_t)(kBQ * (D + 4) + kBK * (D + 4) + kBK * D + kBQ * (kBK + 4));
}

template <int D>
__global__ void __launch_bounds__(kThreadsF32) flash_fwd_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    float* __restrict__ out, float* __restrict__ lse, int Tq, int Tk, int N, float scale_log2) {
  constexpr int LD = D + 4;       // q and k rows: conflict-free float4 loads across keys
  constexpr int LDP = kBK + 4;
  constexpr int CJ = D / 64;      // float4 column groups per thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);  // [query][d]
  float* ks = qs + kBQ * LD;                        // [key][d]
  float* vs = ks + kBK * LD;                        // [key][d]
  float* ps = vs + kBK * D;                         // [query][key]

  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const size_t rs = (size_t)N * D;
  const size_t qhead = (size_t)b * Tq * rs + (size_t)h * D;
  const size_t khead = (size_t)b * Tk * rs + (size_t)h * D;

  for (int i = tid; i < kBQ * D / 4; i += kThreadsF32) {
    const int r = i / (D / 4), c4 = (i % (D / 4)) * 4;
    const int tok = q0 + r;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (tok < Tq) val = *reinterpret_cast<const float4*>(q + qhead + tok * rs + c4);
    *reinterpret_cast<float4*>(qs + r * LD + c4) = val;
  }

  float m[4], l[4], o[4][4 * CJ];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * CJ; ++c) o[r][c] = 0.f;
  }

  for (int kb = 0; kb < Tk; kb += kBK) {
    __syncthreads();
    for (int i = tid; i < kBK * D / 4; i += kThreadsF32) {
      const int r = i / (D / 4), c4 = (i % (D / 4)) * 4;
      const int j = kb + r;
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
      if (j < Tk) {
        kv = *reinterpret_cast<const float4*>(k + khead + (size_t)j * rs + c4);
        vv = *reinterpret_cast<const float4*>(v + khead + (size_t)j * rs + c4);
      }
      *reinterpret_cast<float4*>(ks + r * LD + c4) = kv;
      *reinterpret_cast<float4*>(vs + r * D + c4) = vv;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r) s[r][0] = s[r][1] = s[r][2] = s[r][3] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        qv[r] = *reinterpret_cast<const float4*>(qs + (4 * ty + r) * LD + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        kv[i] = *reinterpret_cast<const float4*>(ks + (tx + 16 * i) * LD + d);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float a = s[r][i];
          a = fmaf(qv[r].x, kv[i].x, a);
          a = fmaf(qv[r].y, kv[i].y, a);
          a = fmaf(qv[r].z, kv[i].z, a);
          a = fmaf(qv[r].w, kv[i].w, a);
          s[r][i] = a;
        }
      }
    }

    // Online softmax over this thread's 4 x 4 logits; a row's 16 threads are
    // the 16 consecutive lanes that share ty.
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int j = kb + tx + 16 * i;
        s[r][i] = j < Tk ? s[r][i] * scale_log2 : -INFINITY;
        mx = fmaxf(mx, s[r][i]);
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float mnew = fmaxf(m[r], mx);  // finite: key kb is always valid
      const float alpha = exp2f(m[r] - mnew);
      m[r] = mnew;
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[r][i] = exp2f(s[r][i] - mnew);
        sum += s[r][i];
        ps[(4 * ty + r) * LDP + tx + 16 * i] = s[r][i];
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[r] = l[r] * alpha + sum;
#pragma unroll
      for (int c = 0; c < 4 * CJ; ++c) o[r][c] *= alpha;
    }
    __syncthreads();

    // O += P V over the tile's 64 keys.
#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float p[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) p[r] = ps[(4 * ty + r) * LDP + j];
#pragma unroll
      for (int cj = 0; cj < CJ; ++cj) {
        const float4 vv = *reinterpret_cast<const float4*>(vs + j * D + 64 * cj + 4 * tx);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          o[r][4 * cj + 0] = fmaf(p[r], vv.x, o[r][4 * cj + 0]);
          o[r][4 * cj + 1] = fmaf(p[r], vv.y, o[r][4 * cj + 1]);
          o[r][4 * cj + 2] = fmaf(p[r], vv.z, o[r][4 * cj + 2]);
          o[r][4 * cj + 3] = fmaf(p[r], vv.w, o[r][4 * cj + 3]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int tok = q0 + 4 * ty + r;
    if (tok >= Tq) continue;
    const float inv = 1.f / l[r];
#pragma unroll
    for (int cj = 0; cj < CJ; ++cj) {
      const float4 val = make_float4(o[r][4 * cj] * inv, o[r][4 * cj + 1] * inv,
                                     o[r][4 * cj + 2] * inv, o[r][4 * cj + 3] * inv);
      *reinterpret_cast<float4*>(out + qhead + (size_t)tok * rs + 64 * cj + 4 * tx) = val;
    }
    if (lse != nullptr && tx == 0)
      lse[((size_t)b * N + h) * Tq + tok] = (m[r] + log2f(l[r])) * 0.6931471805599453f;
  }
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, const void* nk,
                        const void* nv, void* out, float* lse, int B, int Tq, int Tk, int N,
                        float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bf16<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Tq + kBQ - 1) / kBQ, N, B);
  flash_fwd_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(nk), static_cast<const bf16*>(nv), static_cast<bf16*>(out), lse,
      Tq, Tk, N, scale * 1.4426950408889634f);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* out, float* lse, int B,
                       int Tq, int Tk, int N, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_f32<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_f32_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Tq + kBQ - 1) / kBQ, N, B);
  flash_fwd_f32_kernel<D><<<grid, kThreadsF32, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), lse, Tq, Tk, N, scale * 1.4426950408889634f);
  return cudaGetLastError();
}

}  // namespace

// K3: attention over [null; k], [null; v]; q, k, v (B, T, N, 64) bf16.
extern "C" int vfm_flash_attention_nullkv(const void* q, const void* k, const void* v,
                                          const void* null_k, const void* null_v, void* out,
                                          float* lse, int B, int T, int N, int D, float scale,
                                          void* stream) {
  if (D != 64 || null_k == nullptr || null_v == nullptr) return (int)cudaErrorInvalidValue;
  return (int)launch_bf16<64>(q, k, v, null_k, null_v, out, lse, B, T, T, N, scale,
                              static_cast<cudaStream_t>(stream));
}

// K4: attention without a null token; q (B, Tq, N, D), k, v (B, Tk, N, D),
// D in {64, 128}, bf16 (fp32 == 0) or fp32 (fp32 == 1); lse (B, N, Tq) or null.
extern "C" int vfm_flash_attention(const void* q, const void* k, const void* v, void* out,
                                   float* lse, int B, int Tq, int Tk, int N, int D, float scale,
                                   int fp32, void* stream) {
  if (Tk <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fp32) {
    if (D == 64) return (int)launch_f32<64>(q, k, v, out, lse, B, Tq, Tk, N, scale, s);
    if (D == 128) return (int)launch_f32<128>(q, k, v, out, lse, B, Tq, Tk, N, scale, s);
  } else {
    if (D == 64) return (int)launch_bf16<64>(q, k, v, nullptr, nullptr, out, lse, B, Tq, Tk, N,
                                             scale, s);
    if (D == 128) return (int)launch_bf16<128>(q, k, v, nullptr, nullptr, out, lse, B, Tq, Tk, N,
                                               scale, s);
  }
  return (int)cudaErrorInvalidValue;
}

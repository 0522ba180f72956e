// K3 and K4 backward: gradients of flash attention with a learned null
// key/value (K3) or without one (K4), for Hopper.
//
// Replaces the two backward Pallas TPU kernels that the JAX K3 and K4
// reach through the library's custom VJP (jax 0.9.0 jax/experimental/
// pallas/ops/tpu/flash_attention.py: _flash_attention_bwd_dkv and
// _flash_attention_bwd_dq), together with the plain-XLA pre-pass
// D = rowsum(dO * O) of _flash_attention_bwd. With S = q K^T * scale over the
// key walk ([null_k; k] for K3, k for K4), P = softmax(S), O = P V, and the
// forward's per-row log-sum-exp L:
//   P  = exp(S - L)              (recomputed, never stored)
//   dV = P^T dO,  dP = dO V^T,  dS = P * (dP - D)
//   dK = dS^T q * scale,  dQ = dS K * scale
// With null pointers for the null token (K4) the walk starts at key 0 of k;
// otherwise key 0 of the walk is the null token, read from and its gradient
// written to its own pointers, as in the forward. Keys past the walk and
// queries past Tq are masked, so every Tq, Tk works.
//
// Bound on the H100: five Tq x Tk x d products per (sample, head) against
// one read of q, k, v, dO and O and one write of dq, dk, dv, so ~0.6 T flops
// per byte at d = 64: bytes bound below T ~ 500 in bf16 (the card's ridge
// is ~295 flops per byte), compute bound at T = 576 and 1024; in fp32 on
// the CUDA cores (67 TFLOP/s, ridge ~20) compute bound at every T here.
//
// bf16 design: three kernels. (1) delta: one warp per (sample, token, head)
// row computes D. (2) dkv: one CTA of four warps per (64-key tile, head,
// sample); each warp owns 16 keys and accumulates their dK and dV in
// registers while the CTA walks the query tiles, with K, V, q and dO (the
// last two also transposed) staged in shared memory. (3) dq: one CTA per
// (64-query tile, head, sample); each warp owns 16 queries and accumulates
// dQ while the CTA walks the key tiles. All products are mma.sync.m16n8k16
// bf16 tiles with fp32 accumulation; P and dS are rounded to bf16 as the A
// operand of the products that consume them, as every flash backward does.
// The head dim is a template parameter (64, or 128 for K4).
//
// fp32 design (K4 at the adapter, which computes in fp32): the same three
// kernels on fp32 FMA (no TF32). One CTA of 256 threads per 64-row tile;
// thread (ty, tx) owns rows 4ty..4ty+3 of its tile and columns tx + 16i of
// the walked tile for the logits, P (or dS) goes through shared memory, and
// the thread owns output columns 4tx.. (+64) of its four rows for the
// accumulators, as in the fp32 forward.
//
// Layouts: q, out, dout, dq (B, Tq, N, D); k, v, dk, dv (B, Tk, N, D);
// null_k, null_v, dnull_k, dnull_v (B, 1, N, D) or null; lse and delta
// (B, N, Tq) fp32 (lse in natural-log units). bf16 or (K4) fp32.
#include "common.cuh"

namespace {

using vfm::bf16;

constexpr int kBT = 64;         // rows per tile (queries or keys)
constexpr int kLDT = kBT + 8;   // leading dimension of a transposed [d][row] tile
constexpr int kThreads = 128;   // four warps, 16 rows each
constexpr int kThreadsF32 = 256;
constexpr float kLog2e = 1.4426950408889634f;

// ------------------------------------------------------------------ delta

template <typename T, int D>
__global__ void __launch_bounds__(256) delta_kernel(const T* __restrict__ out,
                                                    const T* __restrict__ dout,
                                                    float* __restrict__ delta, int B, int T_,
                                                    int N) {
  constexpr int E = D / 32;  // elements per lane
  const int lane = threadIdx.x & 31;
  const long row = (long)blockIdx.x * 8 + (threadIdx.x >> 5);  // (b, t, h) in memory order
  if (row >= (long)B * T_ * N) return;
  float s = 0.f;
#pragma unroll
  for (int e = 0; e < E; e += 2) {
    float2 o, g;
    if constexpr (sizeof(T) == 2) {
      o = vfm::unpack_bf16(*reinterpret_cast<const uint32_t*>(out + row * D + lane * E + e));
      g = vfm::unpack_bf16(*reinterpret_cast<const uint32_t*>(dout + row * D + lane * E + e));
    } else {
      o = *reinterpret_cast<const float2*>(out + row * D + lane * E + e);
      g = *reinterpret_cast<const float2*>(dout + row * D + lane * E + e);
    }
    s = fmaf(o.x, g.x, s);
    s = fmaf(o.y, g.y, s);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) {
    const int h = (int)(row % N);
    const long bt = row / N;
    const int t = (int)(bt % T_), b = (int)(bt / T_);
    delta[((long)b * N + h) * T_ + t] = s;
  }
}

template <typename T, int D>
cudaError_t launch_delta(const void* out, const void* dout, float* delta, int B, int Tq, int N,
                         cudaStream_t s) {
  const long rows = (long)B * Tq * N;
  delta_kernel<T, D><<<(unsigned)((rows + 7) / 8), 256, 0, s>>>(
      static_cast<const T*>(out), static_cast<const T*>(dout), delta, B, Tq, N);
  return cudaGetLastError();
}

// ------------------------------------------------------------------ bf16

// Copy a 64-row token tile of one head into `dst` [r][d] (ld D + 8) and
// optionally its transpose into `dstT` [d][r] (ld kLDT). Rows are the walk's:
// with a null source (`nsrc`), row 0 is the null token and row j > 0 is
// src row j - 1; rows past the walk are zero.
template <int D>
__device__ __forceinline__ void stage_tile(const bf16* __restrict__ src,
                                           const bf16* __restrict__ nsrc, size_t head,
                                           size_t nhead, size_t rs, int row0, int T_, bf16* dst,
                                           bf16* dstT, int tid) {
  const int has_null = nsrc != nullptr;
  for (int i = tid; i < kBT * D / 8; i += kThreads) {
    const int r = i / (D / 8), c8 = (i % (D / 8)) * 8;
    const int j = row0 + r, js = j - has_null;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (has_null && j == 0) val = *reinterpret_cast<const uint4*>(nsrc + nhead + c8);
    else if (js < T_) val = *reinterpret_cast<const uint4*>(src + head + (size_t)js * rs + c8);
    if (dst) *reinterpret_cast<uint4*>(dst + r * (D + 8) + c8) = val;
    if (dstT) {
      const bf16* ve = reinterpret_cast<const bf16*>(&val);
#pragma unroll
      for (int e = 0; e < 8; ++e) dstT[(c8 + e) * kLDT + r] = ve[e];
    }
  }
}

// Two fp32 accumulator tiles (n-tiles 2kk, 2kk+1) as one bf16 A fragment.
__device__ __forceinline__ void acc_to_a(uint32_t af[4], const float lo[4], const float hi[4]) {
  af[0] = vfm::pack_bf16(lo[0], lo[1]);
  af[1] = vfm::pack_bf16(lo[2], lo[3]);
  af[2] = vfm::pack_bf16(hi[0], hi[1]);
  af[3] = vfm::pack_bf16(hi[2], hi[3]);
}

template <int D>
constexpr size_t smem_dkv() {  // ks, vs, qs, dos [64][D+8]; qts, dots [D][72]
  return sizeof(bf16) * (size_t)(4 * kBT * (D + 8) + 2 * D * kLDT);
}

template <int D>
__global__ void __launch_bounds__(kThreads) dkv_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ nk, const bf16* __restrict__ nv, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta, bf16* __restrict__ dk,
    bf16* __restrict__ dv, bf16* __restrict__ dnk, bf16* __restrict__ dnv, int Tq, int Tk, int N,
    float scale, float scale_log2) {
  constexpr int LD = D + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);  // [key][d]
  bf16* vs = ks + kBT * LD;                       // [key][d]
  bf16* qs = vs + kBT * LD;                       // [query][d]
  bf16* dos = qs + kBT * LD;                      // [query][d]
  bf16* qts = dos + kBT * LD;                     // [d][query]
  bf16* dots = qts + D * kLDT;                    // [d][query]
  __shared__ float lse_s[kBT], delta_s[kBT];

  const int j0 = blockIdx.x * kBT, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int has_null = nk != nullptr;
  const size_t rs = (size_t)N * D;
  const size_t qhead = (size_t)b * Tq * rs + (size_t)h * D;
  const size_t khead = (size_t)b * Tk * rs + (size_t)h * D;
  const size_t nhead = (size_t)b * rs + (size_t)h * D;
  const size_t srow = ((size_t)b * N + h) * Tq;  // lse / delta row base

  // This CTA's 64 keys of the walk.
  stage_tile<D>(k, nk, khead, nhead, rs, j0, Tk, ks, nullptr, tid);
  stage_tile<D>(v, nv, khead, nhead, rs, j0, Tk, vs, nullptr, tid);

  float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;

  for (int qb = 0; qb < Tq; qb += kBT) {
    __syncthreads();  // previous tile consumed (and the K/V staging above)
    stage_tile<D>(q, nullptr, qhead, 0, rs, qb, Tq, qs, qts, tid);
    stage_tile<D>(dout, nullptr, qhead, 0, rs, qb, Tq, dos, dots, tid);
    for (int r = tid; r < kBT; r += kThreads) {
      const int tok = qb + r;
      lse_s[r] = tok < Tq ? lse[srow + tok] * kLog2e : INFINITY;  // +inf: P = 0
      delta_s[r] = tok < Tq ? delta[srow + tok] : 0.f;
    }
    __syncthreads();

    // S^T = K q^T for this warp's 16 keys x 64 queries, then P^T.
    float st[kBT / 8][4];
#pragma unroll
    for (int n = 0; n < kBT / 8; ++n) st[n][0] = st[n][1] = st[n][2] = st[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t af[4];
      vfm::load_a(af, ks + (warp * 16) * LD + kk * 16, LD, lane);
#pragma unroll
      for (int nt = 0; nt < kBT / 8; ++nt) {
        uint32_t bf[2];
        vfm::load_b(bf, qs + (nt * 8) * LD + kk * 16, LD, lane);
        vfm::mma_16816(st[nt], af, bf);
      }
    }
#pragma unroll
    for (int nt = 0; nt < kBT / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        st[nt][e] = exp2f(st[nt][e] * scale_log2 - lse_s[nt * 8 + 2 * t + (e & 1)]);

    // dV += P^T dO (B operand: dO stored [d][query]).
#pragma unroll
    for (int kk = 0; kk < kBT / 16; ++kk) {
      uint32_t af[4];
      acc_to_a(af, st[2 * kk], st[2 * kk + 1]);
#pragma unroll
      for (int nt = 0; nt < D / 8; ++nt) {
        uint32_t bf[2];
        vfm::load_b(bf, dots + (nt * 8) * kLDT + kk * 16, kLDT, lane);
        vfm::mma_16816(dva[nt], af, bf);
      }
    }

    // dP^T = V dO^T (B operand: dO stored [query][d]); dS^T = P^T (dP^T - D).
    float dpt[kBT / 8][4];
#pragma unroll
    for (int n = 0; n < kBT / 8; ++n) dpt[n][0] = dpt[n][1] = dpt[n][2] = dpt[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t af[4];
      vfm::load_a(af, vs + (warp * 16) * LD + kk * 16, LD, lane);
#pragma unroll
      for (int nt = 0; nt < kBT / 8; ++nt) {
        uint32_t bf[2];
        vfm::load_b(bf, dos + (nt * 8) * LD + kk * 16, LD, lane);
        vfm::mma_16816(dpt[nt], af, bf);
      }
    }
#pragma unroll
    for (int nt = 0; nt < kBT / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        st[nt][e] *= dpt[nt][e] - delta_s[nt * 8 + 2 * t + (e & 1)];

    // dK += dS^T q (B operand: q stored [d][query]).
#pragma unroll
    for (int kk = 0; kk < kBT / 16; ++kk) {
      uint32_t af[4];
      acc_to_a(af, st[2 * kk], st[2 * kk + 1]);
#pragma unroll
      for (int nt = 0; nt < D / 8; ++nt) {
        uint32_t bf[2];
        vfm::load_b(bf, qts + (nt * 8) * kLDT + kk * 16, kLDT, lane);
        vfm::mma_16816(dka[nt], af, bf);
      }
    }
  }

  // Key j of the walk: with a null token 0 -> its own gradient, j -> k[j-1].
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int j = j0 + warp * 16 + g + half * 8, jk = j - has_null;
    if (jk >= Tk) continue;
    bf16* dkp = jk < 0 ? dnk + nhead : dk + khead + (size_t)jk * rs;
    bf16* dvp = jk < 0 ? dnv + nhead : dv + khead + (size_t)jk * rs;
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt) {
      const int col = nt * 8 + 2 * t;
      *reinterpret_cast<uint32_t*>(dkp + col) =
          vfm::pack_bf16(dka[nt][half * 2] * scale, dka[nt][half * 2 + 1] * scale);
      *reinterpret_cast<uint32_t*>(dvp + col) =
          vfm::pack_bf16(dva[nt][half * 2], dva[nt][half * 2 + 1]);
    }
  }
}

template <int D>
constexpr size_t smem_dq() {  // qs, dos, ks, vs [64][D+8]; kts [D][72]
  return sizeof(bf16) * (size_t)(4 * kBT * (D + 8) + D * kLDT);
}

template <int D>
__global__ void __launch_bounds__(kThreads) dq_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ nk, const bf16* __restrict__ nv, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta, bf16* __restrict__ dq, int Tq,
    int Tk, int N, float scale, float scale_log2) {
  constexpr int LD = D + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [query][d]
  bf16* dos = qs + kBT * LD;                      // [query][d]
  bf16* ks = dos + kBT * LD;                      // [key][d]
  bf16* vs = ks + kBT * LD;                       // [key][d]
  bf16* kts = vs + kBT * LD;                      // [d][key]

  const int q0 = blockIdx.x * kBT, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const size_t rs = (size_t)N * D;
  const size_t qhead = (size_t)b * Tq * rs + (size_t)h * D;
  const size_t khead = (size_t)b * Tk * rs + (size_t)h * D;
  const size_t nhead = (size_t)b * rs + (size_t)h * D;
  const size_t srow = ((size_t)b * N + h) * Tq;
  const int Tv = Tk + (nk != nullptr);  // keys of the walk

  // This CTA's 64 queries of q and dO, and each warp row's L and D.
  stage_tile<D>(q, nullptr, qhead, 0, rs, q0, Tq, qs, nullptr, tid);
  stage_tile<D>(dout, nullptr, qhead, 0, rs, q0, Tq, dos, nullptr, tid);
  float lr[2], dr[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int tok = q0 + warp * 16 + g + half * 8;
    lr[half] = tok < Tq ? lse[srow + tok] * kLog2e : INFINITY;
    dr[half] = tok < Tq ? delta[srow + tok] : 0.f;
  }

  float dqa[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) dqa[n][0] = dqa[n][1] = dqa[n][2] = dqa[n][3] = 0.f;

  for (int kb = 0; kb < Tv; kb += kBT) {
    __syncthreads();
    stage_tile<D>(k, nk, khead, nhead, rs, kb, Tk, ks, kts, tid);
    stage_tile<D>(v, nv, khead, nhead, rs, kb, Tk, vs, nullptr, tid);
    __syncthreads();

    // S = q K^T and dP = dO V^T for this warp's 16 queries x 64 keys.
    float s[kBT / 8][4], dp[kBT / 8][4];
#pragma unroll
    for (int n = 0; n < kBT / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t qf[4], df[4];
      vfm::load_a(qf, qs + (warp * 16) * LD + kk * 16, LD, lane);
      vfm::load_a(df, dos + (warp * 16) * LD + kk * 16, LD, lane);
#pragma unroll
      for (int nt = 0; nt < kBT / 8; ++nt) {
        uint32_t bk[2], bv[2];
        vfm::load_b(bk, ks + (nt * 8) * LD + kk * 16, LD, lane);
        vfm::load_b(bv, vs + (nt * 8) * LD + kk * 16, LD, lane);
        vfm::mma_16816(s[nt], qf, bk);
        vfm::mma_16816(dp[nt], df, bv);
      }
    }
    // dS = P (dP - D), with P = exp(S - L) and keys past the walk masked.
#pragma unroll
    for (int nt = 0; nt < kBT / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = kb + nt * 8 + 2 * t + (e & 1);
        const float p = j < Tv ? exp2f(s[nt][e] * scale_log2 - lr[e >> 1]) : 0.f;
        s[nt][e] = p * (dp[nt][e] - dr[e >> 1]);
      }
    }
    // dQ += dS K (B operand: K stored [d][key]).
#pragma unroll
    for (int kk = 0; kk < kBT / 16; ++kk) {
      uint32_t af[4];
      acc_to_a(af, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int nt = 0; nt < D / 8; ++nt) {
        uint32_t bf[2];
        vfm::load_b(bf, kts + (nt * 8) * kLDT + kk * 16, kLDT, lane);
        vfm::mma_16816(dqa[nt], af, bf);
      }
    }
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int tok = q0 + warp * 16 + g + half * 8;
    if (tok >= Tq) continue;
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt) {
      const int col = nt * 8 + 2 * t;
      *reinterpret_cast<uint32_t*>(dq + qhead + (size_t)tok * rs + col) =
          vfm::pack_bf16(dqa[nt][half * 2] * scale, dqa[nt][half * 2 + 1] * scale);
    }
  }
}

template <int D>
cudaError_t launch_dkv_bf16(const void* q, const void* k, const void* v, const void* nk,
                            const void* nv, const void* out, const void* dout, const float* lse,
                            float* delta, void* dk, void* dv, void* dnk, void* dnv, int B, int Tq,
                            int Tk, int N, float scale, cudaStream_t s) {
  cudaError_t err = launch_delta<bf16, D>(out, dout, delta, B, Tq, N, s);
  if (err != cudaSuccess) return err;
  constexpr size_t smem = smem_dkv<D>();
  err = cudaFuncSetAttribute(dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Tk + (nk != nullptr) + kBT - 1) / kBT, N, B);
  dkv_kernel<D><<<grid, kThreads, smem, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(nk), static_cast<const bf16*>(nv), static_cast<const bf16*>(dout),
      lse, delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv), static_cast<bf16*>(dnk),
      static_cast<bf16*>(dnv), Tq, Tk, N, scale, scale * kLog2e);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq_bf16(const void* q, const void* k, const void* v, const void* nk,
                           const void* nv, const void* dout, const float* lse, const float* delta,
                           void* dq, int B, int Tq, int Tk, int N, float scale, cudaStream_t s) {
  constexpr size_t smem = smem_dq<D>();
  cudaError_t err = cudaFuncSetAttribute(dq_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Tq + kBT - 1) / kBT, N, B);
  dq_kernel<D><<<grid, kThreads, smem, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(nk), static_cast<const bf16*>(nv), static_cast<const bf16*>(dout),
      lse, delta, static_cast<bf16*>(dq), Tq, Tk, N, scale, scale * kLog2e);
  return cudaGetLastError();
}

// ------------------------------------------------------------------ fp32

// Copy a 64-row fp32 token tile of one head into dst [r][d] (ld D + 4);
// rows past T_ are zero.
template <int D>
__device__ __forceinline__ void stage_f32(const float* __restrict__ src, size_t head, size_t rs,
                                          int row0, int T_, float* dst, int tid) {
  for (int i = tid; i < kBT * D / 4; i += kThreadsF32) {
    const int r = i / (D / 4), c4 = (i % (D / 4)) * 4;
    const int j = row0 + r;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (j < T_) val = *reinterpret_cast<const float4*>(src + head + (size_t)j * rs + c4);
    *reinterpret_cast<float4*>(dst + r * (D + 4) + c4) = val;
  }
}

// acc[r][i] += A[4ty + r] . Bm[tx + 16i] over d, for two pairs of tiles at
// once (A1 with B1 into acc1, A2 with B2 into acc2); rows of ld D + 4.
template <int D>
__device__ __forceinline__ void dots4x4(float acc1[4][4], float acc2[4][4], const float* A1,
                                        const float* B1, const float* A2, const float* B2, int ty,
                                        int tx) {
  constexpr int LD = D + 4;
#pragma unroll 2
  for (int d = 0; d < D; d += 4) {
    float4 a1[4], b1[4], a2[4], b2[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      a1[r] = *reinterpret_cast<const float4*>(A1 + (4 * ty + r) * LD + d);
      a2[r] = *reinterpret_cast<const float4*>(A2 + (4 * ty + r) * LD + d);
      b1[r] = *reinterpret_cast<const float4*>(B1 + (tx + 16 * r) * LD + d);
      b2[r] = *reinterpret_cast<const float4*>(B2 + (tx + 16 * r) * LD + d);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float x = acc1[r][i], y = acc2[r][i];
        x = fmaf(a1[r].x, b1[i].x, x);
        x = fmaf(a1[r].y, b1[i].y, x);
        x = fmaf(a1[r].z, b1[i].z, x);
        x = fmaf(a1[r].w, b1[i].w, x);
        y = fmaf(a2[r].x, b2[i].x, y);
        y = fmaf(a2[r].y, b2[i].y, y);
        y = fmaf(a2[r].z, b2[i].z, y);
        y = fmaf(a2[r].w, b2[i].w, y);
        acc1[r][i] = x;
        acc2[r][i] = y;
      }
    }
  }
}

// acc[r][c] += sum_j Pm[4ty + r][j] * M[j][64cj + 4tx + c] over 64 rows j
// of M (ld D + 4); Pm [64][68].
template <int D>
__device__ __forceinline__ void rows_times_tile(float acc[4][D / 16], const float* Pm,
                                                const float* M, int ty, int tx) {
  constexpr int CJ = D / 64;
#pragma unroll 4
  for (int j = 0; j < kBT; ++j) {
    float p[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) p[r] = Pm[(4 * ty + r) * (kBT + 4) + j];
#pragma unroll
    for (int cj = 0; cj < CJ; ++cj) {
      const float4 m = *reinterpret_cast<const float4*>(M + j * (D + 4) + 64 * cj + 4 * tx);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        acc[r][4 * cj + 0] = fmaf(p[r], m.x, acc[r][4 * cj + 0]);
        acc[r][4 * cj + 1] = fmaf(p[r], m.y, acc[r][4 * cj + 1]);
        acc[r][4 * cj + 2] = fmaf(p[r], m.z, acc[r][4 * cj + 2]);
        acc[r][4 * cj + 3] = fmaf(p[r], m.w, acc[r][4 * cj + 3]);
      }
    }
  }
}

// Rows 4ty..4ty+3 of a (64, D) accumulator, times `mul`, to rows row0 + r < T_.
template <int D>
__device__ __forceinline__ void store_rows_f32(float* __restrict__ dst, const float acc[4][D / 16],
                                               size_t head, size_t rs, int row0, int T_,
                                               float mul, int ty, int tx) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int j = row0 + 4 * ty + r;
    if (j >= T_) continue;
#pragma unroll
    for (int cj = 0; cj < D / 64; ++cj) {
      const float4 val = make_float4(acc[r][4 * cj] * mul, acc[r][4 * cj + 1] * mul,
                                     acc[r][4 * cj + 2] * mul, acc[r][4 * cj + 3] * mul);
      *reinterpret_cast<float4*>(dst + head + (size_t)j * rs + 64 * cj + 4 * tx) = val;
    }
  }
}

template <int D>
constexpr size_t smem_f32() {  // four [64][D+4] tiles, two [64][68] tiles, L and D
  return sizeof(float) * (size_t)(4 * kBT * (D + 4) + 2 * kBT * (kBT + 4) + 2 * kBT);
}

template <int D>
__global__ void __launch_bounds__(kThreadsF32) dkv_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dk, float* __restrict__ dv, int Tq,
    int Tk, int N, float scale, float scale_log2) {
  constexpr int LD = D + 4, LDP = kBT + 4;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ks = reinterpret_cast<float*>(smem_raw);  // [key][d]
  float* vs = ks + kBT * LD;                        // [key][d]
  float* qs = vs + kBT * LD;                        // [query][d]
  float* dos = qs + kBT * LD;                       // [query][d]
  float* pts = dos + kBT * LD;                      // P^T [key][query]
  float* dsts = pts + kBT * LDP;                    // dS^T [key][query]
  float* lse_s = dsts + kBT * LDP;
  float* delta_s = lse_s + kBT;

  const int j0 = blockIdx.x * kBT, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const size_t rs = (size_t)N * D;
  const size_t qhead = (size_t)b * Tq * rs + (size_t)h * D;
  const size_t khead = (size_t)b * Tk * rs + (size_t)h * D;
  const size_t srow = ((size_t)b * N + h) * Tq;
  stage_f32<D>(k, khead, rs, j0, Tk, ks, tid);
  stage_f32<D>(v, khead, rs, j0, Tk, vs, tid);

  float dka[4][D / 16], dva[4][D / 16];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < D / 16; ++c) dka[r][c] = dva[r][c] = 0.f;

  for (int qb = 0; qb < Tq; qb += kBT) {
    __syncthreads();  // previous tile consumed (and the K/V staging above)
    stage_f32<D>(q, qhead, rs, qb, Tq, qs, tid);
    stage_f32<D>(dout, qhead, rs, qb, Tq, dos, tid);
    for (int r = tid; r < kBT; r += kThreadsF32) {
      const int tok = qb + r;
      lse_s[r] = tok < Tq ? lse[srow + tok] * kLog2e : INFINITY;  // +inf: P = 0
      delta_s[r] = tok < Tq ? delta[srow + tok] : 0.f;
    }
    __syncthreads();

    // S^T = K q^T and dP^T = V dO^T: keys 4ty + r x queries tx + 16i.
    float st[4][4], dpt[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int i = 0; i < 4; ++i) st[r][i] = dpt[r][i] = 0.f;
    dots4x4<D>(st, dpt, ks, qs, vs, dos, ty, tx);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int jq = tx + 16 * i;
        const float p = exp2f(st[r][i] * scale_log2 - lse_s[jq]);
        pts[(4 * ty + r) * LDP + jq] = p;
        dsts[(4 * ty + r) * LDP + jq] = p * (dpt[r][i] - delta_s[jq]);
      }
    }
    __syncthreads();
    rows_times_tile<D>(dva, pts, dos, ty, tx);   // dV += P^T dO
    rows_times_tile<D>(dka, dsts, qs, ty, tx);   // dK += dS^T q
  }
  store_rows_f32<D>(dk, dka, khead, rs, j0, Tk, scale, ty, tx);
  store_rows_f32<D>(dv, dva, khead, rs, j0, Tk, 1.f, ty, tx);
}

template <int D>
__global__ void __launch_bounds__(kThreadsF32) dq_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dq, int Tq, int Tk, int N, float scale,
    float scale_log2) {
  constexpr int LD = D + 4, LDP = kBT + 4;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);  // [query][d]
  float* dos = qs + kBT * LD;                       // [query][d]
  float* ks = dos + kBT * LD;                       // [key][d]
  float* vs = ks + kBT * LD;                        // [key][d]
  float* dss = vs + kBT * LD;                       // dS [query][key]

  const int q0 = blockIdx.x * kBT, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const size_t rs = (size_t)N * D;
  const size_t qhead = (size_t)b * Tq * rs + (size_t)h * D;
  const size_t khead = (size_t)b * Tk * rs + (size_t)h * D;
  const size_t srow = ((size_t)b * N + h) * Tq;
  stage_f32<D>(q, qhead, rs, q0, Tq, qs, tid);
  stage_f32<D>(dout, qhead, rs, q0, Tq, dos, tid);
  float lr[4], dr[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int tok = q0 + 4 * ty + r;
    lr[r] = tok < Tq ? lse[srow + tok] * kLog2e : INFINITY;
    dr[r] = tok < Tq ? delta[srow + tok] : 0.f;
  }

  float dqa[4][D / 16];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < D / 16; ++c) dqa[r][c] = 0.f;

  for (int kb = 0; kb < Tk; kb += kBT) {
    __syncthreads();
    stage_f32<D>(k, khead, rs, kb, Tk, ks, tid);
    stage_f32<D>(v, khead, rs, kb, Tk, vs, tid);
    __syncthreads();

    // S = q K^T and dP = dO V^T: queries 4ty + r x keys tx + 16i.
    float s[4][4], dp[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[r][i] = dp[r][i] = 0.f;
    dots4x4<D>(s, dp, qs, ks, dos, vs, ty, tx);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int j = kb + tx + 16 * i;
        const float p = j < Tk ? exp2f(s[r][i] * scale_log2 - lr[r]) : 0.f;
        dss[(4 * ty + r) * LDP + tx + 16 * i] = p * (dp[r][i] - dr[r]);
      }
    }
    __syncthreads();
    rows_times_tile<D>(dqa, dss, ks, ty, tx);  // dQ += dS K
  }
  store_rows_f32<D>(dq, dqa, qhead, rs, q0, Tq, scale, ty, tx);
}

template <int D>
cudaError_t launch_dkv_f32(const void* q, const void* k, const void* v, const void* out,
                           const void* dout, const float* lse, float* delta, void* dk, void* dv,
                           int B, int Tq, int Tk, int N, float scale, cudaStream_t s) {
  cudaError_t err = launch_delta<float, D>(out, dout, delta, B, Tq, N, s);
  if (err != cudaSuccess) return err;
  constexpr size_t smem = smem_f32<D>();
  err = cudaFuncSetAttribute(dkv_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Tk + kBT - 1) / kBT, N, B);
  dkv_f32_kernel<D><<<grid, kThreadsF32, smem, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), lse, delta, static_cast<float*>(dk),
      static_cast<float*>(dv), Tq, Tk, N, scale, scale * kLog2e);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq_f32(const void* q, const void* k, const void* v, const void* dout,
                          const float* lse, const float* delta, void* dq, int B, int Tq, int Tk,
                          int N, float scale, cudaStream_t s) {
  constexpr size_t smem = smem_f32<D>();
  cudaError_t err = cudaFuncSetAttribute(dq_f32_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Tq + kBT - 1) / kBT, N, B);
  dq_f32_kernel<D><<<grid, kThreadsF32, smem, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), lse, delta, static_cast<float*>(dq), Tq, Tk, N, scale,
      scale * kLog2e);
  return cudaGetLastError();
}

}  // namespace

// K3: D = rowsum(dO * O) into `delta`, then dK, dV, d null_k, d null_v;
// bf16, head dim 64.
extern "C" int vfm_flash_attention_nullkv_bwd_dkv(
    const void* q, const void* k, const void* v, const void* null_k, const void* null_v,
    const void* out, const void* dout, const float* lse, float* delta, void* dk, void* dv,
    void* dnull_k, void* dnull_v, int B, int T, int N, int D, float scale, void* stream) {
  if (D != 64 || null_k == nullptr || null_v == nullptr) return (int)cudaErrorInvalidValue;
  return (int)launch_dkv_bf16<64>(q, k, v, null_k, null_v, out, dout, lse, delta, dk, dv,
                                  dnull_k, dnull_v, B, T, T, N, scale,
                                  static_cast<cudaStream_t>(stream));
}

// K3: dQ from the same inputs and the `delta` written by the dkv entry point.
extern "C" int vfm_flash_attention_nullkv_bwd_dq(
    const void* q, const void* k, const void* v, const void* null_k, const void* null_v,
    const void* dout, const float* lse, const float* delta, void* dq, int B, int T, int N, int D,
    float scale, void* stream) {
  if (D != 64 || null_k == nullptr || null_v == nullptr) return (int)cudaErrorInvalidValue;
  return (int)launch_dq_bf16<64>(q, k, v, null_k, null_v, dout, lse, delta, dq, B, T, T, N,
                                 scale, static_cast<cudaStream_t>(stream));
}

// K4: D = rowsum(dO * O), then dK, dV of attention without a null token;
// q, out, dout (B, Tq, N, D), k, v (B, Tk, N, D), D in {64, 128}, bf16
// (fp32 == 0) or fp32 (fp32 == 1).
extern "C" int vfm_flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                           const void* out, const void* dout, const float* lse,
                                           float* delta, void* dk, void* dv, int B, int Tq,
                                           int Tk, int N, int D, float scale, int fp32,
                                           void* stream) {
  if (Tq <= 0 || Tk <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fp32) {
    if (D == 64) return (int)launch_dkv_f32<64>(q, k, v, out, dout, lse, delta, dk, dv, B, Tq, Tk,
                                                N, scale, s);
    if (D == 128) return (int)launch_dkv_f32<128>(q, k, v, out, dout, lse, delta, dk, dv, B, Tq,
                                                  Tk, N, scale, s);
  } else {
    if (D == 64) return (int)launch_dkv_bf16<64>(q, k, v, nullptr, nullptr, out, dout, lse, delta,
                                                 dk, dv, nullptr, nullptr, B, Tq, Tk, N, scale, s);
    if (D == 128) return (int)launch_dkv_bf16<128>(q, k, v, nullptr, nullptr, out, dout, lse,
                                                   delta, dk, dv, nullptr, nullptr, B, Tq, Tk, N,
                                                   scale, s);
  }
  return (int)cudaErrorInvalidValue;
}

// K4: dQ from the same inputs and the `delta` written by the dkv entry point.
extern "C" int vfm_flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                                          const void* dout, const float* lse, const float* delta,
                                          void* dq, int B, int Tq, int Tk, int N, int D,
                                          float scale, int fp32, void* stream) {
  if (Tq <= 0 || Tk <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fp32) {
    if (D == 64) return (int)launch_dq_f32<64>(q, k, v, dout, lse, delta, dq, B, Tq, Tk, N, scale,
                                               s);
    if (D == 128) return (int)launch_dq_f32<128>(q, k, v, dout, lse, delta, dq, B, Tq, Tk, N,
                                                 scale, s);
  } else {
    if (D == 64) return (int)launch_dq_bf16<64>(q, k, v, nullptr, nullptr, dout, lse, delta, dq, B,
                                                Tq, Tk, N, scale, s);
    if (D == 128) return (int)launch_dq_bf16<128>(q, k, v, nullptr, nullptr, dout, lse, delta, dq,
                                                  B, Tq, Tk, N, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}

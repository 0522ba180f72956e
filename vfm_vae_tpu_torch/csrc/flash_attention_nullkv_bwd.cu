// K3 backward: gradients of flash attention with a learned null key/value,
// for Hopper.
//
// Replaces the two backward Pallas TPU kernels that the JAX K3 reaches
// through its custom VJP (jax 0.9.0 jax/experimental/pallas/ops/tpu/
// flash_attention.py: _flash_attention_bwd_dkv and _flash_attention_bwd_dq),
// together with the plain-XLA pre-pass D = rowsum(dO * O) of
// _flash_attention_bwd. With S = q [null_k; k]^T * scale, P = softmax(S),
// O = P [null_v; v], and the forward's per-row log-sum-exp L:
//   P  = exp(S - L)              (recomputed, never stored)
//   dV = P^T dO,  dP = dO V^T,  dS = P * (dP - D)
//   dK = dS^T q * scale,  dQ = dS K * scale
// Key 0 of the walk is the null token: it is read from and its gradient is
// written to its own pointers, as in the forward. Keys past T + 1 and
// queries past T are masked, so every T from 1 to 1024 works.
//
// Bound on the H100: five T x (T+1) x 64 products per (sample, head) against
// one read of q, k, v, dO and O and one write of dq, dk, dv, so ~0.6 T flops
// per byte at d = 64: bytes bound below T ~ 500 (the card's ridge is ~295
// flops per byte), compute bound at T = 576 and 1024. Design: three
// kernels. (1) delta: one warp per (sample, token, head) row computes D.
// (2) dkv: one CTA of four warps per (64-key tile, head, sample); each warp
// keeps its 16 keys' K and V fragments in registers for the whole walk and
// accumulates dK and dV in registers while the CTA walks the query tiles,
// staging q and dO (row-major and transposed) in shared memory. (3) dq: one
// CTA per (64-query tile, head, sample); each warp keeps its 16 queries' q
// and dO fragments in registers and accumulates dQ while the CTA walks the
// key tiles. All products are mma.sync.m16n8k16 bf16 tiles with fp32
// accumulation; P and dS are rounded to bf16 as the A operand of the
// products that consume them, as every flash backward does. No wgmma, TMA
// or warp specialisation yet: a simple, right first version.
//
// Layouts: q, k, v, out, dout, dq, dk, dv (B, T, N, 64) bf16; null_k,
// null_v, dnull_k, dnull_v (B, 1, N, 64) bf16; lse and delta (B, N, T) fp32
// (lse in natural-log units).
#include "common.cuh"

namespace {

using vfm::bf16;

constexpr int kD = 64;
constexpr int kBT = 64;        // rows per tile (queries or keys)
constexpr int kLD = kD + 8;    // padded leading dimension of every smem tile
constexpr int kThreads = 128;  // four warps, 16 rows each
constexpr float kLog2e = 1.4426950408889634f;

// Copy a 64-row token tile (rows `row0 + r` of one head) into `dst` [r][d]
// and optionally its transpose into `dstT` [d][r]. Row -1 of the virtual key
// sequence is not used: `null_row` (or nullptr) supplies row 0 when `virt`.
__device__ __forceinline__ void stage_tile(const bf16* __restrict__ src, const bf16* __restrict__ nsrc,
                                           size_t head, size_t nhead, size_t rs, int row0, int T,
                                           bool virt, bf16* dst, bf16* dstT, int tid) {
  for (int i = tid; i < kBT * kD / 8; i += kThreads) {
    const int r = i / (kD / 8), c8 = (i % (kD / 8)) * 8;
    const int j = row0 + r;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (virt) {
      if (j == 0) val = *reinterpret_cast<const uint4*>(nsrc + nhead + c8);
      else if (j <= T) val = *reinterpret_cast<const uint4*>(src + head + (size_t)(j - 1) * rs + c8);
    } else if (j < T) {
      val = *reinterpret_cast<const uint4*>(src + head + (size_t)j * rs + c8);
    }
    if (dst) *reinterpret_cast<uint4*>(dst + r * kLD + c8) = val;
    if (dstT) {
      const bf16* ve = reinterpret_cast<const bf16*>(&val);
#pragma unroll
      for (int e = 0; e < 8; ++e) dstT[(c8 + e) * kLD + r] = ve[e];
    }
  }
}

// A fragments (16 rows x 64 columns, four k-chunks) of this warp's rows of a
// row-major smem tile.
__device__ __forceinline__ void load_rows(uint32_t f[kD / 16][4], const bf16* tile, int warp,
                                          int lane) {
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) vfm::load_a(f[kk], tile + (warp * 16) * kLD + kk * 16, kLD, lane);
}

// Two fp32 accumulator tiles (n-tiles 2kk, 2kk+1) as one bf16 A fragment.
__device__ __forceinline__ void acc_to_a(uint32_t af[4], const float lo[4], const float hi[4]) {
  af[0] = vfm::pack_bf16(lo[0], lo[1]);
  af[1] = vfm::pack_bf16(lo[2], lo[3]);
  af[2] = vfm::pack_bf16(hi[0], hi[1]);
  af[3] = vfm::pack_bf16(hi[2], hi[3]);
}

__global__ void __launch_bounds__(256) delta_kernel(const bf16* __restrict__ out,
                                                    const bf16* __restrict__ dout,
                                                    float* __restrict__ delta, int B, int T, int N) {
  const int lane = threadIdx.x & 31;
  const long row = (long)blockIdx.x * 8 + (threadIdx.x >> 5);  // (b, t, h) in memory order
  if (row >= (long)B * T * N) return;
  const float2 o = vfm::unpack_bf16(*reinterpret_cast<const uint32_t*>(out + row * kD + 2 * lane));
  const float2 g = vfm::unpack_bf16(*reinterpret_cast<const uint32_t*>(dout + row * kD + 2 * lane));
  float s = o.x * g.x + o.y * g.y;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) {
    const int h = (int)(row % N);
    const long bt = row / N;
    const int t = (int)(bt % T), b = (int)(bt / T);
    delta[((long)b * N + h) * T + t] = s;
  }
}

__global__ void __launch_bounds__(kThreads) dkv_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ nk, const bf16* __restrict__ nv, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta, bf16* __restrict__ dk,
    bf16* __restrict__ dv, bf16* __restrict__ dnk, bf16* __restrict__ dnv, int T, int N,
    float scale, float scale_log2) {
  __shared__ __align__(16) bf16 qs[kBT * kLD];    // [query][d]
  __shared__ __align__(16) bf16 qts[kD * kLD];    // [d][query]
  __shared__ __align__(16) bf16 dos[kBT * kLD];   // [query][d]
  __shared__ __align__(16) bf16 dots[kD * kLD];   // [d][query]
  __shared__ float lse_s[kBT], delta_s[kBT];

  const int j0 = blockIdx.x * kBT, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const size_t rs = (size_t)N * kD;
  const size_t head = (size_t)b * T * rs + (size_t)h * kD;
  const size_t nhead = (size_t)b * rs + (size_t)h * kD;
  const size_t srow = ((size_t)b * N + h) * T;  // lse / delta row base

  // This warp's 16 keys of the virtual sequence [null; k] as A fragments.
  uint32_t kf[kD / 16][4], vf[kD / 16][4];
  stage_tile(k, nk, head, nhead, rs, j0, T, true, qs, nullptr, tid);
  stage_tile(v, nv, head, nhead, rs, j0, T, true, dos, nullptr, tid);
  __syncthreads();
  load_rows(kf, qs, warp, lane);
  load_rows(vf, dos, warp, lane);

  float dka[kD / 8][4], dva[kD / 8][4];
#pragma unroll
  for (int n = 0; n < kD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;

  for (int qb = 0; qb < T; qb += kBT) {
    __syncthreads();  // previous tile consumed (and the K/V staging above)
    stage_tile(q, nullptr, head, 0, rs, qb, T, false, qs, qts, tid);
    stage_tile(dout, nullptr, head, 0, rs, qb, T, false, dos, dots, tid);
    for (int r = tid; r < kBT; r += kThreads) {
      const int tok = qb + r;
      lse_s[r] = tok < T ? lse[srow + tok] * kLog2e : INFINITY;  // +inf: P = 0
      delta_s[r] = tok < T ? delta[srow + tok] : 0.f;
    }
    __syncthreads();

    // S^T = K q^T for this warp's 16 keys x 64 queries, then P^T.
    float st[kBT / 8][4];
#pragma unroll
    for (int n = 0; n < kBT / 8; ++n) st[n][0] = st[n][1] = st[n][2] = st[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
#pragma unroll
      for (int nt = 0; nt < kBT / 8; ++nt) {
        uint32_t bf[2];
        vfm::load_b(bf, qs + (nt * 8) * kLD + kk * 16, kLD, lane);
        vfm::mma_16816(st[nt], kf[kk], bf);
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
      for (int nt = 0; nt < kD / 8; ++nt) {
        uint32_t bf[2];
        vfm::load_b(bf, dots + (nt * 8) * kLD + kk * 16, kLD, lane);
        vfm::mma_16816(dva[nt], af, bf);
      }
    }

    // dP^T = V dO^T (B operand: dO stored [query][d]); dS^T = P^T (dP^T - D).
    float dpt[kBT / 8][4];
#pragma unroll
    for (int n = 0; n < kBT / 8; ++n) dpt[n][0] = dpt[n][1] = dpt[n][2] = dpt[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
#pragma unroll
      for (int nt = 0; nt < kBT / 8; ++nt) {
        uint32_t bf[2];
        vfm::load_b(bf, dos + (nt * 8) * kLD + kk * 16, kLD, lane);
        vfm::mma_16816(dpt[nt], vf[kk], bf);
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
      for (int nt = 0; nt < kD / 8; ++nt) {
        uint32_t bf[2];
        vfm::load_b(bf, qts + (nt * 8) * kLD + kk * 16, kLD, lane);
        vfm::mma_16816(dka[nt], af, bf);
      }
    }
  }

  // Key j of the walk: 0 -> the null token's own gradient, 1..T -> k[j-1].
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int j = j0 + warp * 16 + g + half * 8;
    if (j > T) continue;
    bf16* dkp = j == 0 ? dnk + nhead : dk + head + (size_t)(j - 1) * rs;
    bf16* dvp = j == 0 ? dnv + nhead : dv + head + (size_t)(j - 1) * rs;
#pragma unroll
    for (int nt = 0; nt < kD / 8; ++nt) {
      const int col = nt * 8 + 2 * t;
      *reinterpret_cast<uint32_t*>(dkp + col) =
          vfm::pack_bf16(dka[nt][half * 2] * scale, dka[nt][half * 2 + 1] * scale);
      *reinterpret_cast<uint32_t*>(dvp + col) =
          vfm::pack_bf16(dva[nt][half * 2], dva[nt][half * 2 + 1]);
    }
  }
}

__global__ void __launch_bounds__(kThreads) dq_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ nk, const bf16* __restrict__ nv, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta, bf16* __restrict__ dq, int T,
    int N, float scale, float scale_log2) {
  __shared__ __align__(16) bf16 ks[kBT * kLD];   // [key][d]
  __shared__ __align__(16) bf16 vs[kBT * kLD];   // [key][d]
  __shared__ __align__(16) bf16 kts[kD * kLD];   // [d][key]

  const int q0 = blockIdx.x * kBT, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const size_t rs = (size_t)N * kD;
  const size_t head = (size_t)b * T * rs + (size_t)h * kD;
  const size_t nhead = (size_t)b * rs + (size_t)h * kD;
  const size_t srow = ((size_t)b * N + h) * T;
  const int Tk = T + 1;

  // This warp's 16 queries of q and dO as A fragments, and their L and D.
  uint32_t qf[kD / 16][4], dof[kD / 16][4];
  stage_tile(q, nullptr, head, 0, rs, q0, T, false, ks, nullptr, tid);
  stage_tile(dout, nullptr, head, 0, rs, q0, T, false, vs, nullptr, tid);
  __syncthreads();
  load_rows(qf, ks, warp, lane);
  load_rows(dof, vs, warp, lane);
  float lr[2], dr[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int tok = q0 + warp * 16 + g + half * 8;
    lr[half] = tok < T ? lse[srow + tok] * kLog2e : INFINITY;
    dr[half] = tok < T ? delta[srow + tok] : 0.f;
  }

  float dqa[kD / 8][4];
#pragma unroll
  for (int n = 0; n < kD / 8; ++n) dqa[n][0] = dqa[n][1] = dqa[n][2] = dqa[n][3] = 0.f;

  for (int kb = 0; kb < Tk; kb += kBT) {
    __syncthreads();
    stage_tile(k, nk, head, nhead, rs, kb, T, true, ks, kts, tid);
    stage_tile(v, nv, head, nhead, rs, kb, T, true, vs, nullptr, tid);
    __syncthreads();

    // S = q K^T and dP = dO V^T for this warp's 16 queries x 64 keys.
    float s[kBT / 8][4], dp[kBT / 8][4];
#pragma unroll
    for (int n = 0; n < kBT / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
#pragma unroll
      for (int nt = 0; nt < kBT / 8; ++nt) {
        uint32_t bk[2], bv[2];
        vfm::load_b(bk, ks + (nt * 8) * kLD + kk * 16, kLD, lane);
        vfm::load_b(bv, vs + (nt * 8) * kLD + kk * 16, kLD, lane);
        vfm::mma_16816(s[nt], qf[kk], bk);
        vfm::mma_16816(dp[nt], dof[kk], bv);
      }
    }
    // dS = P (dP - D), with P = exp(S - L) and keys past T + 1 masked.
#pragma unroll
    for (int nt = 0; nt < kBT / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = kb + nt * 8 + 2 * t + (e & 1);
        const float p = j < Tk ? exp2f(s[nt][e] * scale_log2 - lr[e >> 1]) : 0.f;
        s[nt][e] = p * (dp[nt][e] - dr[e >> 1]);
      }
    }
    // dQ += dS K (B operand: K stored [d][key]).
#pragma unroll
    for (int kk = 0; kk < kBT / 16; ++kk) {
      uint32_t af[4];
      acc_to_a(af, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int nt = 0; nt < kD / 8; ++nt) {
        uint32_t bf[2];
        vfm::load_b(bf, kts + (nt * 8) * kLD + kk * 16, kLD, lane);
        vfm::mma_16816(dqa[nt], af, bf);
      }
    }
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int tok = q0 + warp * 16 + g + half * 8;
    if (tok >= T) continue;
#pragma unroll
    for (int nt = 0; nt < kD / 8; ++nt) {
      const int col = nt * 8 + 2 * t;
      *reinterpret_cast<uint32_t*>(dq + head + (size_t)tok * rs + col) =
          vfm::pack_bf16(dqa[nt][half * 2] * scale, dqa[nt][half * 2 + 1] * scale);
    }
  }
}

}  // namespace

// D = rowsum(dO * O) into `delta`, then dK, dV, d null_k, d null_v.
extern "C" int vfm_flash_attention_nullkv_bwd_dkv(
    const void* q, const void* k, const void* v, const void* null_k, const void* null_v,
    const void* out, const void* dout, const float* lse, float* delta, void* dk, void* dv,
    void* dnull_k, void* dnull_v, int B, int T, int N, int D, float scale, void* stream) {
  if (D != kD) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long rows = (long)B * T * N;
  delta_kernel<<<(unsigned)((rows + 7) / 8), 256, 0, s>>>(
      static_cast<const bf16*>(out), static_cast<const bf16*>(dout), delta, B, T, N);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T + 1 + kBT - 1) / kBT, N, B);
  dkv_kernel<<<grid, kThreads, 0, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(null_k), static_cast<const bf16*>(null_v),
      static_cast<const bf16*>(dout), lse, delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      static_cast<bf16*>(dnull_k), static_cast<bf16*>(dnull_v), T, N, scale, scale * kLog2e);
  return (int)cudaGetLastError();
}

// dQ from the same inputs and the `delta` written by the dkv entry point.
extern "C" int vfm_flash_attention_nullkv_bwd_dq(
    const void* q, const void* k, const void* v, const void* null_k, const void* null_v,
    const void* dout, const float* lse, const float* delta, void* dq, int B, int T, int N, int D,
    float scale, void* stream) {
  if (D != kD) return (int)cudaErrorInvalidValue;
  dim3 grid((T + kBT - 1) / kBT, N, B);
  dq_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(null_k), static_cast<const bf16*>(null_v),
      static_cast<const bf16*>(dout), lse, delta, static_cast<bf16*>(dq), T, N, scale,
      scale * kLog2e);
  return (int)cudaGetLastError();
}

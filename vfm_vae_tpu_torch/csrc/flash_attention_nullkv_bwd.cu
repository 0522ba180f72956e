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
// Keys past Tk and queries past Tq are masked, so every Tq, Tk works.
//
// Bound on the H100: per (sample, head) the dK/dV kernel does four Tq x Tk x
// d products and the dQ kernel three, against one read of q, k, v, dO and O
// and one write of dq, dk, dv: ~0.6 T flops per byte at d = 64, so bytes
// bound below T ~ 500 in bf16 (the card's ridge is ~295 flops per byte) and
// the tensor cores at T = 576 and 1024; there a call's few microseconds of
// work make the host's launch path the limit. In fp32 (K4 at the adapter)
// compute bound at every T here: 3xTF32 on the tensor cores runs three
// products per fp32 product at 495 TFLOP/s, 165 TFLOP/s of fp32 work, 2.5x
// the CUDA cores' 67 of fp32 FMA.
//
// bf16 design (d = 64 and 128), on the forward's machinery (flash.cuh):
// - One entry point per mode enqueues the pre-pass, the dK/dV kernel and the
//   dQ kernel on the caller's stream (either kernel may be left out), encodes
//   four tensor maps (q, dO, k, v; boxes of 64 rows) and sets each kernel's
//   shared-memory limit once per template instance and device.
// - dK/dV (flash_bwd_dkv_kernel): a work tile is a block of 64 NWG keys of
//   one (sample, head). K and V stay in shared memory; a producer warpgroup
//   streams 64-query tiles of q and dO by TMA through a four-stage ring, and
//   its second warp writes each stage's L (log2 units, +inf past Tq so that
//   P = 0 there) and D. Each consumer warpgroup holds its 64 keys' dK and dV
//   in registers for the whole query walk: S^T = K q^T and dP^T = V dO^T
//   (wgmma SS, m64n64, both operands K-major as stored), P^T = exp2(S^T - L)
//   in registers, dV += P^T dO (wgmma RS: P^T packed to bf16 as the A
//   operand, dO read MN-major as stored), dS^T = P^T (dP^T - D), dK += dS^T q
//   (RS, q MN-major). No operand is transposed by a copy. Software
//   pipeline: tile j+1's S^T and dP^T are issued together with tile j's dK,
//   so tile j+1's exponentials overlap dK(j), and dS(j) is computed while
//   dV(j) runs (the last tile is peeled off, so every wait in the loop
//   covers the same products).
// - dQ (flash_bwd_dq_kernel): the forward's structure: a work tile is a
//   block of 64 NWG queries, q and dO stay in shared memory, 64-key tiles of
//   K and V stream through the ring; S = q K^T and dP = dO V^T (SS), P and
//   dS in registers, dQ += dS K (RS, K MN-major). Tile j+1's S and dP are
//   issued together with tile j's dQ, and two consumer warpgroups take turns
//   to issue (named barriers 1 and 2), as in the forward; turns made the
//   dK/dV kernel slower in a development A/B, so it has none.
// - The null token is not in the tile walk, so every key tile starts at a
//   row of k and TMA loads it from the native (B, T, N, D) layout. Its terms
//   depend on per-query values only: the dQ kernel adds dS0 null_k, with
//   dS0 = P0 (dO . null_v - D) from rows of its resident q and dO; the
//   pre-pass (null_prepass_kernel), which also writes D, sums P0 dO and
//   dS0 q over each 64-query chunk; the dK/dV kernel's first work tile of
//   each head adds the chunks in order into d null_v and d null_k * scale.
//   No float atomics: every gradient is bit-identical from run to run.
//   K4's pre-pass (delta_bf16_kernel) computes D alone, with 16-byte loads.
// - Persistent CTAs (at most one per SM) walk the work tiles; two consumer
//   warpgroups (128 rows) per CTA unless 64-row blocks fit on the SMs in one
//   wave. With two, the producer hands its registers to the consumers
//   (setmaxnreg: 40 and 232); the kernels hold no __trap(), which would make
//   the compiler ignore setmaxnreg.
// P and dS are rounded to bf16 as the A operands of the products that
// consume them, as every flash backward does (P0 and dS0 of the null token
// too); the accumulators are fp32.
//
// fp32 design (K4 at the adapter, which computes in fp32; d = 64 and 128):
// D = rowsum(dO O) in delta_kernel, then the dK/dV and dQ kernels with every
// product on the tensor cores as 3xTF32 (mma.sync m16n8k8): each operand is
// split where its fragment is loaded into hi = tf32(x) (rounded to nearest)
// and lo = x - hi, and a b = a_lo b_hi + a_hi b_lo + a_hi b_hi is accumulated
// in fp32; the dropped a_lo b_lo and the splits' rounding stay near 2^-21 of
// each product. Measured against fp64 the gradients are 0.6x as far off as
// the fp32 twin's; one TF32 product alone (1xTF32) is 800x. Warp-level tiles: each warp
// owns 16 rows of its CTA's block (keys for dK/dV, queries for dQ). The
// resident pair (K and V, or q and dO) and two stages of the streamed pair
// (q, dO and their L and D rows, or K and V) live in shared memory as rows of
// D + 4 floats, loaded by cp.async (zero-filled past Tq, Tk) one tile ahead;
// the dK/dV kernel splits each streamed q and dO tile once into hi and lo
// planes (all its warps read all of it), the rest is split where loaded.
// K-major operands (rows as stored: the first products S = q K^T and dP =
// dO V^T, in either orientation) come in by ldmatrix, which moves 32-bit
// words as pairs of b16 in exactly the TF32 fragment layout; P^T, dS^T (dK/
// dV) and dS (dQ) stay in the C registers and serve as A operands with the k
// axis permuted within each block of 8, so the B operand (dO, q or K read
// along the token axis) is two scalar loads of rows 2t and 2t + 1, free of
// bank conflicts with rows of D + 4. Each k block of 8 sums its three
// products into a fresh accumulator that one fp32 add (round to nearest)
// folds into the running sum: the tensor cores' accumulation rounds towards
// zero, which over a whole chain is 3-4x fp32's error. Two CTAs of four
// warps fit an SM at d = 64; two warps per CTA when four would leave SMs
// without a CTA.
// Every output element is summed by one thread in a fixed order: no atomics,
// bit-identical on repeat.
//
// Layouts: q, out, dout, dq (B, Tq, N, D); k, v, dk, dv (B, Tk, N, D);
// null_k, null_v, dnull_k, dnull_v (B, 1, N, D) or null; lse and delta
// (B, N, Tq) fp32 (lse in natural-log units); K3's partial sums (B, N,
// ceil(Tq / 64), 2, D) fp32. bf16 or (K4) fp32.
#include "flash.cuh"

namespace {

using vfm::bf16;
using vfm::fence_all;

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kPrepassRows = 64;  // query rows per pre-pass CTA (one partial sum each)
constexpr int kBwdProducerRegs = 40, kBwdConsumerRegs = 232;

// ---------------------------------------------------------------- pre-pass

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

// K4's bf16 pre-pass: D = rowsum(dO O) with D / 8 threads per (sample,
// head, query) row, each with one 16-byte load of O and one of dO; rows in
// the order of D's (B, N, Tq) layout, so its stores are contiguous.
template <int D>
__global__ void __launch_bounds__(256) delta_bf16_kernel(const bf16* __restrict__ out,
                                                         const bf16* __restrict__ dout,
                                                         float* __restrict__ delta, int B, int T_,
                                                         int N) {
  constexpr int kLanes = D / 8;
  const long r = ((long)blockIdx.x * 256 + threadIdx.x) / kLanes, rows = (long)B * N * T_;
  const int sub = threadIdx.x % kLanes;
  float s = 0.f;
  if (r < rows) {
    const long t = r % T_, bh = r / T_;
    const long o = (((bh / N) * T_ + t) * N + bh % N) * D + sub * 8;
    const uint4 ov = *reinterpret_cast<const uint4*>(out + o);
    const uint4 gv = *reinterpret_cast<const uint4*>(dout + o);
    const uint32_t ow[4] = {ov.x, ov.y, ov.z, ov.w}, gw[4] = {gv.x, gv.y, gv.z, gv.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 a = vfm::unpack_bf16(ow[e]), g = vfm::unpack_bf16(gw[e]);
      s = fmaf(a.x, g.x, s);
      s = fmaf(a.y, g.y, s);
    }
  }
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (sub == 0 && r < rows) delta[r] = s;
}

template <int D>
cudaError_t launch_delta_bf16(const void* out, const void* dout, float* delta, int B, int Tq,
                              int N, cudaStream_t s) {
  const long threads = (long)B * N * Tq * (D / 8);
  delta_bf16_kernel<D><<<(unsigned)((threads + 255) / 256), 256, 0, s>>>(
      static_cast<const bf16*>(out), static_cast<const bf16*>(dout), delta, B, Tq, N);
  return cudaGetLastError();
}

// K3's pre-pass: one CTA per (64-query chunk, head, sample), one warp per
// query row at a time. Writes D = rowsum(dO O) and, for the null token, the
// chunk's sums of bf16(P0) dO (d null_v) and bf16(dS0) q (d null_k / scale)
// with P0 = exp(q . null_k scale - L), dS0 = P0 (dO . null_v - D): each warp
// sums its rows in order, then the 8 warps are added in order.
template <int D>
__global__ void __launch_bounds__(256) null_prepass_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ out, const bf16* __restrict__ dout,
    const bf16* __restrict__ nk, const bf16* __restrict__ nv, const float* __restrict__ lse,
    float* __restrict__ delta, float* __restrict__ parts, int Tq, int N, float scale_log2) {
  constexpr int E = D / 32;  // elements per lane
  constexpr int kRowsPerWarp = kPrepassRows / 8;
  __shared__ float red[8][2 * D];
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t rs = (size_t)N * D, head = ((size_t)b * Tq * N + h) * D;
  const size_t nhead = ((size_t)b * N + h) * D, srow = ((size_t)b * N + h) * Tq;
  float nkv[E], nvv[E], acc_k[E], acc_v[E];
#pragma unroll
  for (int e = 0; e < E; e += 2) {
    const size_t o = nhead + lane * E + e;
    const float2 a = vfm::unpack_bf16(*reinterpret_cast<const uint32_t*>(nk + o));
    const float2 bb = vfm::unpack_bf16(*reinterpret_cast<const uint32_t*>(nv + o));
    nkv[e] = a.x, nkv[e + 1] = a.y, nvv[e] = bb.x, nvv[e + 1] = bb.y;
  }
#pragma unroll
  for (int e = 0; e < E; ++e) acc_k[e] = acc_v[e] = 0.f;
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int tok = c * kPrepassRows + warp * kRowsPerWarp + r;
    if (tok >= Tq) break;
    const size_t o = head + (size_t)tok * rs + lane * E;
    float qv[E], ov[E], gv[E];
#pragma unroll
    for (int e = 0; e < E; e += 2) {
      const float2 a = vfm::unpack_bf16(*reinterpret_cast<const uint32_t*>(q + o + e));
      const float2 x = vfm::unpack_bf16(*reinterpret_cast<const uint32_t*>(out + o + e));
      const float2 y = vfm::unpack_bf16(*reinterpret_cast<const uint32_t*>(dout + o + e));
      qv[e] = a.x, qv[e + 1] = a.y, ov[e] = x.x, ov[e + 1] = x.y, gv[e] = y.x, gv[e + 1] = y.y;
    }
    float dl = 0.f, s0 = 0.f, dp0 = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      dl = fmaf(ov[e], gv[e], dl);
      s0 = fmaf(qv[e], nkv[e], s0);
      dp0 = fmaf(gv[e], nvv[e], dp0);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {  // every lane ends with the same sums
      dl += __shfl_xor_sync(0xffffffffu, dl, off);
      s0 += __shfl_xor_sync(0xffffffffu, s0, off);
      dp0 += __shfl_xor_sync(0xffffffffu, dp0, off);
    }
    if (lane == 0) delta[srow + tok] = dl;
    const float p0 = vfm::ex2(fmaf(s0, scale_log2, -lse[srow + tok] * kLog2e));
    const float pr = vfm::round_bf16(p0), dr = vfm::round_bf16(p0 * (dp0 - dl));
#pragma unroll
    for (int e = 0; e < E; ++e) {
      acc_v[e] = fmaf(pr, gv[e], acc_v[e]);
      acc_k[e] = fmaf(dr, qv[e], acc_k[e]);
    }
  }
#pragma unroll
  for (int e = 0; e < E; ++e) {
    red[warp][lane * E + e] = acc_k[e];
    red[warp][D + lane * E + e] = acc_v[e];
  }
  __syncthreads();
  float* dst = parts + (((size_t)b * N + h) * gridDim.x + c) * 2 * D;
  for (int i = threadIdx.x; i < 2 * D; i += 256) {
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < 8; ++w) sum += red[w][i];
    dst[i] = sum;
  }
}

template <int D>
cudaError_t launch_null_prepass(const void* q, const void* out, const void* dout, const void* nk,
                                const void* nv, const float* lse, float* delta, float* parts,
                                int B, int Tq, int N, float scale, cudaStream_t s) {
  dim3 grid((Tq + kPrepassRows - 1) / kPrepassRows, N, B);
  null_prepass_kernel<D><<<grid, 256, 0, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(out), static_cast<const bf16*>(dout),
      static_cast<const bf16*>(nk), static_cast<const bf16*>(nv), lse, delta, parts, Tq, N,
      scale * kLog2e);
  return cudaGetLastError();
}

// ------------------------------------------------------------------ bf16

// Shared-memory layout of the bf16 backward kernels with NWG consumer
// warpgroups (flash.cuh): two resident tensors of 64 NWG rows, loaded in
// 64-row boxes, and two streamed tensors in 64-row tiles through four
// stages; the dK/dV kernel also keeps each stage's L and D (128 floats).
template <int D, int NWG>
using DkvLayout = vfm::RingLayout<D, NWG, 2, 64, 64, 4, 128>;
template <int D, int NWG>
using DqLayout = vfm::RingLayout<D, NWG, 2, 64, 64, 4, 0>;

// The dK/dV kernel's second producer warp: each stage's 64 query rows' L in
// log2 units (+inf past Tq, so that P = 0 there) and D (0 past Tq), written
// once the stage is free and announced on its b_full barrier.
template <typename L>
__device__ __forceinline__ void produce_rows(const vfm::Ring<L>& ld, float* rows,
                                             const float* __restrict__ lse,
                                             const float* __restrict__ delta, int Tq, int lane) {
  for (int it = 0; ld.work(it) < ld.n_work; ++it) {
    const vfm::WorkTile wt = ld.tile(it);
    const size_t srow = ((size_t)wt.b * ld.N + wt.h) * Tq;
    for (int j = 0; j < ld.n_tiles; ++j) {
      const int gi = it * ld.n_tiles + j, s = gi % L::kStages;
      if (gi >= L::kStages) vfm::mbar_wait(ld.empty(s), ((gi / L::kStages) & 1) ^ 1);
      float* l2 = rows + s * L::kRowFloats;
      for (int i = lane; i < L::kKT; i += 32) {
        const int tok = j * L::kKT + i;
        l2[i] = tok < Tq ? lse[srow + tok] * kLog2e : INFINITY;
        l2[L::kKT + i] = tok < Tq ? delta[srow + tok] : 0.f;
      }
      vfm::mbar_arrive(ld.b_full(s));
    }
  }
}

// One consumer warpgroup `wg` of flash_bwd_dkv_kernel on the CTA's it-th
// work tile: its 64 keys against every query tile, then their dK and dV
// rows (and, on each head's first work tile, the null token's gradients).
// In the wgmma accumulator layout this thread holds keys r0 and r0 + 8 and
// columns 8 c + 2 t, 8 c + 2 t + 1 of every 8-column chunk c (queries in
// S^T and dP^T, d in dK and dV).
template <int D, typename L>
__device__ __forceinline__ void consume_dkv(const vfm::Ring<L>& ld, const float* rows,
                                            const float* __restrict__ parts,
                                            bf16* __restrict__ dk, bf16* __restrict__ dv,
                                            bf16* __restrict__ dnk, bf16* __restrict__ dnv,
                                            int it, int wg, int Tq, int Tk, int N, float scale,
                                            float scale_log2) {
  const int lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  const int r0 = wg * 64 + (threadIdx.x / 32 % 4) * 16 + g;
  const vfm::WorkTile wt = ld.tile(it);
  const int n_tiles = ld.n_tiles, g0 = it * n_tiles;
  const uint32_t k_rows = ld.res_s + wg * 64 * 128, v_rows = k_rows + L::kBoxes * L::kResBox;
  float dka[D / 2], dva[D / 2], st[L::kKT / 2], dpt[L::kKT / 2];
  uint32_t pa[L::kKT / 16][4], da[L::kKT / 16][4];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;
  auto stage = [](int gi) { return gi % L::kStages; };
  auto parity = [](int gi) { return (uint32_t)(gi / L::kStages) & 1; };
  // S^T = K q^T and dP^T = V dO^T of query tile `gi` of the ring walk.
  auto issue_scores = [&](int gi) {
    const int s = stage(gi);
    vfm::mbar_wait(ld.a_full(s), parity(gi));
    vfm::mbar_wait(ld.b_full(s), parity(gi));
    vfm::issue_ss<D, L>(st, k_rows, ld.a_s + s * L::kTile);
    vfm::issue_ss<D, L>(dpt, v_rows, ld.b_s + s * L::kTile);
    vfm::wgmma_commit();
  };
  // Tile gi's P^T = exp2(S^T scale log2(e) - L) (in st), the dV product
  // issued with it, then dS^T = P^T (dP^T - D) (in dpt) while dV runs.
  auto p_dv_ds = [&](int gi) {
    const int s = stage(gi);
    const float* l2 = rows + s * L::kRowFloats;  // L, then D, of the tile's queries
#pragma unroll
    for (int c = 0; c < L::kKT / 8; ++c) {
      const float2 lc = *reinterpret_cast<const float2*>(l2 + 8 * c + 2 * t);
      st[4 * c] = vfm::ex2(fmaf(st[4 * c], scale_log2, -lc.x));
      st[4 * c + 1] = vfm::ex2(fmaf(st[4 * c + 1], scale_log2, -lc.y));
      st[4 * c + 2] = vfm::ex2(fmaf(st[4 * c + 2], scale_log2, -lc.x));
      st[4 * c + 3] = vfm::ex2(fmaf(st[4 * c + 3], scale_log2, -lc.y));
    }
    vfm::pack_a<L::kKT>(pa, st);
    vfm::wgmma_fence();
    vfm::issue_rs<D, L>(dva, pa, ld.b_s + s * L::kTile);  // dV += P^T dO
    vfm::wgmma_commit();
#pragma unroll
    for (int c = 0; c < L::kKT / 8; ++c) {
      const float2 dc = *reinterpret_cast<const float2*>(l2 + L::kKT + 8 * c + 2 * t);
      dpt[4 * c] = st[4 * c] * (dpt[4 * c] - dc.x);
      dpt[4 * c + 1] = st[4 * c + 1] * (dpt[4 * c + 1] - dc.y);
      dpt[4 * c + 2] = st[4 * c + 2] * (dpt[4 * c + 2] - dc.x);
      dpt[4 * c + 3] = st[4 * c + 3] * (dpt[4 * c + 3] - dc.y);
    }
  };
  // Software pipeline: tile j+1's S^T and dP^T are issued together with tile
  // j's dK product, so tile j+1's exponentials run while dK(j) holds the
  // tensor cores, and dS(j) is computed while dV(j) runs. The last tile is
  // peeled off, so that every wait in the loop covers the same products. A
  // stage is released once the dK product of its tile has completed.
  vfm::mbar_wait(ld.res_full(), it & 1);
  vfm::wgmma_fence();
  issue_scores(g0);
  vfm::wgmma_wait<0>();
  fence_all(st);
  fence_all(dpt);
  for (int j = 0; j + 1 < n_tiles; ++j) {
    const int gi = g0 + j;
    p_dv_ds(gi);
    vfm::wgmma_wait<1>();  // dK(j-1); dV(j) may still run
    fence_all(dka);
    fence_all(da);
    if (j > 0) vfm::mbar_arrive(ld.empty(stage(gi - 1)));
    vfm::pack_a<L::kKT>(da, dpt);
    vfm::wgmma_fence();
    issue_scores(gi + 1);
    vfm::issue_rs<D, L>(dka, da, ld.a_s + stage(gi) * L::kTile);  // dK += dS^T q
    vfm::wgmma_commit();
    vfm::wgmma_wait<1>();  // S^T(j+1), dP^T(j+1) and dV(j); dK(j) may still run
    fence_all(st);
    fence_all(dpt);
    fence_all(dva);
    fence_all(pa);
  }
  const int gl = g0 + n_tiles - 1;
  p_dv_ds(gl);
  vfm::wgmma_wait<1>();  // dK of the tile before
  fence_all(dka);
  fence_all(da);
  if (n_tiles > 1) vfm::mbar_arrive(ld.empty(stage(gl - 1)));
  vfm::pack_a<L::kKT>(da, dpt);
  vfm::wgmma_fence();
  vfm::issue_rs<D, L>(dka, da, ld.a_s + stage(gl) * L::kTile);
  vfm::wgmma_commit();
  vfm::wgmma_wait<0>();
  fence_all(dva);
  fence_all(dka);
  fence_all(pa);
  fence_all(da);
  vfm::mbar_arrive(ld.empty(stage(gl)));
  vfm::mbar_arrive(ld.res_empty());

  const size_t rs = (size_t)N * D;
  const size_t khead = (size_t)wt.b * Tk * rs + (size_t)wt.h * D;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int key = wt.r0 + r0 + 8 * hf;
    if (key >= Tk) continue;
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      const size_t o = khead + (size_t)key * rs + 8 * c + 2 * t;
      *reinterpret_cast<uint32_t*>(dk + o) =
          vfm::pack_bf16(dka[4 * c + 2 * hf] * scale, dka[4 * c + 2 * hf + 1] * scale);
      *reinterpret_cast<uint32_t*>(dv + o) =
          vfm::pack_bf16(dva[4 * c + 2 * hf], dva[4 * c + 2 * hf + 1]);
    }
  }
  if (dnk != nullptr && wt.r0 == 0 && wg == 0) {
    // The null token: the pre-pass's chunk sums over the queries, in order.
    const int chunks = (Tq + kPrepassRows - 1) / kPrepassRows;
    const size_t nhead = ((size_t)wt.b * N + wt.h) * D;
    const float* p = parts + nhead * 2 * chunks;
    for (int i = threadIdx.x % 128; i < 2 * D; i += 128) {
      float sum = 0.f;
      for (int c = 0; c < chunks; ++c) sum += p[c * 2 * D + i];
      if (i < D)
        dnk[nhead + i] = __float2bfloat16_rn(sum * scale);
      else
        dnv[nhead + i - D] = __float2bfloat16_rn(sum);
    }
  }
}

// dK/dV: persistent CTAs walk the (key block, head, sample) work tiles; the
// ring of q/dO tiles runs on across work tiles. Warpgroup 0 produces (lane 0
// of warp 0 the TMA loads, warp 1 the rows' L and D); the role is read
// through a shuffle so that the compiler sees it is warp-uniform, and the two
// paths never rejoin.
template <int D, int NWG>
__global__ void __launch_bounds__((NWG + 1) * 128, 1) flash_bwd_dkv_kernel(
    const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const float* __restrict__ parts, bf16* __restrict__ dk, bf16* __restrict__ dv,
    bf16* __restrict__ dnk, bf16* __restrict__ dnv, int B, int Tq, int Tk, int N, float scale,
    float scale_log2) {
  using L = DkvLayout<D, NWG>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = vfm::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  float* rows = reinterpret_cast<float*>(smem_raw + (base - raw) + L::kRows);
  const int n_blocks = (Tk + L::kRowsRes - 1) / L::kRowsRes;
  const vfm::Ring<L> ld{{&tk, &tv}, &tq, &tdo, base, base + L::kA, base + L::kB, base + L::kBar,
                        (Tq + L::kKT - 1) / L::kKT, n_blocks, n_blocks * N * B, N, Tk};
  if (threadIdx.x == 0) ld.init();
  __syncthreads();

  const int role = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (role == 0) {
    if constexpr (NWG > 1) vfm::reg_dealloc<kBwdProducerRegs>();
    const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0);
    if (threadIdx.x == 0)
      ld.produce();
    else if (warp == 1)
      produce_rows<L>(ld, rows, lse, delta, Tq, threadIdx.x % 32);
  } else {
    if constexpr (NWG > 1) vfm::reg_alloc<kBwdConsumerRegs>();
    for (int it = 0; ld.work(it) < ld.n_work; ++it)
      consume_dkv<D, L>(ld, rows, parts, dk, dv, dnk, dnv, it, role - 1, Tq, Tk, N, scale,
                        scale_log2);
  }
}

// One consumer warpgroup `wg` of flash_bwd_dq_kernel on the CTA's it-th work
// tile: its 64 queries (rows r0 and r0 + 8 of this thread) against every key
// tile, then their dQ rows.
template <int D, typename L>
__device__ __forceinline__ void consume_dq(const vfm::Ring<L>& ld, const unsigned char* smem,
                                           const bf16* __restrict__ nk,
                                           const bf16* __restrict__ nv,
                                           const float* __restrict__ lse,
                                           const float* __restrict__ delta, bf16* __restrict__ dq,
                                           int it, int wg, int Tq, int Tk, int N, float scale,
                                           float scale_log2) {
  const int lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  const int r0 = wg * 64 + (threadIdx.x / 32 % 4) * 16 + g;
  const vfm::WorkTile wt = ld.tile(it);
  const int n_tiles = ld.n_tiles, g0 = it * n_tiles;
  const size_t srow = ((size_t)wt.b * N + wt.h) * Tq, nhead = ((size_t)wt.b * N + wt.h) * D;
  float l2[2], dl[2], ds0[2] = {0.f, 0.f};
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {  // L in log2 units (+inf past Tq: P = 0) and D
    const int tok = wt.r0 + r0 + 8 * hf;
    l2[hf] = tok < Tq ? lse[srow + tok] * kLog2e : INFINITY;
    dl[hf] = tok < Tq ? delta[srow + tok] : 0.f;
  }
  const uint32_t q_rows = ld.res_s + wg * 64 * 128, do_rows = q_rows + L::kBoxes * L::kResBox;
  float dqa[D / 2], sc[L::kKT / 2], dp[L::kKT / 2];
  uint32_t da[L::kKT / 16][4];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dqa[i] = 0.f;
  vfm::mbar_wait(ld.res_full(), it & 1);
  if (nk != nullptr) {
    // The null token, key 0 of [null; k]: dS0 = P0 (dO . null_v - D), rounded
    // to bf16 as every dS is; its dQ term is added in the epilogue.
    float s0[2], dp0[2];
    vfm::rows_dot<D>(s0, smem, L::kResBox, nk + nhead, r0, t);
    vfm::rows_dot<D>(dp0, smem + L::kBoxes * L::kResBox, L::kResBox, nv + nhead, r0, t);
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
      ds0[hf] = vfm::round_bf16(vfm::ex2(fmaf(s0[hf], scale_log2, -l2[hf])) * (dp0[hf] - dl[hf]));
  }
  auto stage = [](int gi) { return gi % L::kStages; };
  auto parity = [](int gi) { return (uint32_t)(gi / L::kStages) & 1; };
  // S = q K^T and dP = dO V^T of key tile `gi` of the ring walk.
  auto issue_scores = [&](int gi) {
    const int s = stage(gi);
    vfm::mbar_wait(ld.a_full(s), parity(gi));
    vfm::mbar_wait(ld.b_full(s), parity(gi));
    vfm::issue_ss<D, L>(sc, q_rows, ld.a_s + s * L::kTile);
    vfm::issue_ss<D, L>(dp, do_rows, ld.b_s + s * L::kTile);
    vfm::wgmma_commit();
  };
  // With two consumer warpgroups, each issues its products only in its turn
  // (named barrier 1 + wg) and then passes the turn to the other.
  auto take_turn = [&] {
    if constexpr (L::kThreadsConsumer > 128)
      wg == 0 ? vfm::named_sync<1, 256>() : vfm::named_sync<2, 256>();
  };
  auto pass_turn = [&] {
    if constexpr (L::kThreadsConsumer > 128)
      wg == 0 ? vfm::named_arrive<2, 256>() : vfm::named_arrive<1, 256>();
  };
  // dS = P (dP - D) of key tile j (in dp), keys past Tk masked.
  auto ds_of = [&](int j) {
    const int kb = j * L::kKT;
    const bool edge = kb + L::kKT > Tk;
#pragma unroll
    for (int c = 0; c < L::kKT / 8; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = vfm::ex2(fmaf(sc[4 * c + e], scale_log2, -l2[e >> 1]));
        if (edge && kb + 8 * c + 2 * t + (e & 1) >= Tk) p = 0.f;
        dp[4 * c + e] = p * (dp[4 * c + e] - dl[e >> 1]);
      }
  };
  // Software pipeline: tile j+1's S and dP are issued together with tile j's
  // dQ product, so tile j+1's exponentials run while dQ(j) holds the tensor
  // cores. The last tile is peeled off, so that every wait in the loop
  // covers the same products. A stage is released once the dQ product of
  // its tile has completed.
  take_turn();
  vfm::wgmma_fence();
  issue_scores(g0);
  pass_turn();
  vfm::wgmma_wait<0>();
  fence_all(sc);
  fence_all(dp);
  for (int j = 0; j + 1 < n_tiles; ++j) {
    const int gi = g0 + j;
    ds_of(j);
    vfm::wgmma_wait<0>();  // dQ(j-1)
    fence_all(dqa);
    fence_all(da);
    if (j > 0) vfm::mbar_arrive(ld.empty(stage(gi - 1)));
    vfm::pack_a<L::kKT>(da, dp);
    take_turn();
    vfm::wgmma_fence();
    issue_scores(gi + 1);
    vfm::issue_rs<D, L>(dqa, da, ld.a_s + stage(gi) * L::kTile);  // dQ += dS K
    vfm::wgmma_commit();
    pass_turn();
    vfm::wgmma_wait<1>();  // S(j+1) and dP(j+1); dQ(j) may still run
    fence_all(sc);
    fence_all(dp);
  }
  const int gl = g0 + n_tiles - 1;
  ds_of(n_tiles - 1);
  vfm::wgmma_wait<0>();
  fence_all(dqa);
  fence_all(da);
  if (n_tiles > 1) vfm::mbar_arrive(ld.empty(stage(gl - 1)));
  vfm::pack_a<L::kKT>(da, dp);
  take_turn();
  vfm::wgmma_fence();
  vfm::issue_rs<D, L>(dqa, da, ld.a_s + stage(gl) * L::kTile);
  vfm::wgmma_commit();
  pass_turn();
  vfm::wgmma_wait<0>();
  fence_all(dqa);
  fence_all(da);
  vfm::mbar_arrive(ld.empty(stage(gl)));
  vfm::mbar_arrive(ld.res_empty());

  const size_t rs = (size_t)N * D;
  const size_t qhead = (size_t)wt.b * Tq * rs + (size_t)wt.h * D;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int tok = wt.r0 + r0 + 8 * hf;
    if (tok >= Tq) continue;
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      float x0 = dqa[4 * c + 2 * hf], x1 = dqa[4 * c + 2 * hf + 1];
      if (nk != nullptr) {
        const float2 n =
            vfm::unpack_bf16(*reinterpret_cast<const uint32_t*>(nk + nhead + 8 * c + 2 * t));
        x0 = fmaf(ds0[hf], n.x, x0);
        x1 = fmaf(ds0[hf], n.y, x1);
      }
      *reinterpret_cast<uint32_t*>(dq + qhead + (size_t)tok * rs + 8 * c + 2 * t) =
          vfm::pack_bf16(x0 * scale, x1 * scale);
    }
  }
}

// dQ: persistent CTAs walk the (query block, head, sample) work tiles; the
// ring of K/V tiles runs on across work tiles.
template <int D, int NWG>
__global__ void __launch_bounds__((NWG + 1) * 128, 1) flash_bwd_dq_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
    const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
    const bf16* __restrict__ nk, const bf16* __restrict__ nv, const float* __restrict__ lse,
    const float* __restrict__ delta, bf16* __restrict__ dq, int B, int Tq, int Tk, int N,
    float scale, float scale_log2) {
  using L = DqLayout<D, NWG>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = vfm::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const unsigned char* smem = smem_raw + (base - raw);  // generic pointer to `base`
  const int n_blocks = (Tq + L::kRowsRes - 1) / L::kRowsRes;
  const vfm::Ring<L> ld{{&tq, &tdo}, &tk, &tv, base, base + L::kA, base + L::kB, base + L::kBar,
                        (Tk + L::kKT - 1) / L::kKT, n_blocks, n_blocks * N * B, N, Tq};
  if (threadIdx.x == 0) ld.init();
  __syncthreads();

  const int role = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (role == 0) {
    if constexpr (NWG > 1) vfm::reg_dealloc<kBwdProducerRegs>();
    if (threadIdx.x == 0) ld.produce();
  } else {
    if constexpr (NWG > 1) vfm::reg_alloc<kBwdConsumerRegs>();
    if (NWG > 1 && role == 2) vfm::named_arrive<1, 256>();  // warpgroup 0 goes first
    for (int it = 0; ld.work(it) < ld.n_work; ++it)
      consume_dq<D, L>(ld, smem, nk, nv, lse, delta, dq, it, role - 1, Tq, Tk, N, scale,
                       scale_log2);
    if (NWG > 1 && role == 1) vfm::named_sync<1, 256>();  // the other warpgroup's last pass
  }
}

// ------------------------------------------------------------------ fp32

// Warps per CTA of an fp32 backward kernel whose CTAs own blocks of 16 W rows
// of T (keys for dK/dV, queries for dQ): four (64 rows) when B N ceil(T / 64)
// such blocks give every SM one, else two, which doubles the CTAs.
int f32_warps(int B, int T, int N, int sms) {
  return (long long)B * N * ((T + 63) / 64) >= sms ? 4 : 2;
}

// Shared memory of the fp32 kernels, in floats, rows of D + 4 (a 16-byte
// shift per row: conflict-free ldmatrix phases and column reads). A CTA of
// W warps owns 16 W rows of the resident pair (K and V, or q and dO) and
// streams tiles of kWalk rows of the other pair through two stages. The
// dK/dV kernel's stages hold each streamed tensor as hi and lo planes
// (split once per CTA, split_rows) and the tile's L and D; the dQ kernel's
// hold K and V as loaded (each warp splits what it reads).
template <int D, int W, bool DKV>
struct F32Layout {
  static constexpr int kLd = D + 4;
  static constexpr int kRows = 16 * W;        // resident rows
  static constexpr int kWalk = DKV ? 32 : 64;  // streamed rows per tile
  static constexpr int kThreads = 32 * W;
  static constexpr int kStages = 2;
  static constexpr int kStage = DKV ? 4 * kWalk * kLd + 2 * kWalk : 2 * kWalk * kLd;
  static constexpr int kSmem = (int)sizeof(float) * (2 * kRows * kLd + kStages * kStage);
};

// x = hi + lo with hi = tf32(x) rounded to nearest and lo = x - hi (exact in
// fp32): the tensor cores read lo's top 19 bits, so x is represented to within
// 2^-21 |x|, as accurate in the products as rounding lo too (one instruction
// more per operand).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a0 b0 + a1 b1 over two k blocks of 8 of an m16n8k8 tile as 3xTF32: per
// block a_lo b_hi + a_hi b_lo + a_hi b_hi (small terms first; a_lo b_lo, near
// 2^-21 of the product, is dropped). The six products are summed on the
// tensor cores into a fresh accumulator that one fp32 add (round to nearest)
// folds into c. The tensor cores' fp32 accumulation rounds towards zero:
// chained over a whole reduction it puts the gradients 12x as far from fp64
// as the fp32 twin's; chains of three products 0.6x, of six 0.7x (the probe).
__device__ __forceinline__ void mma_3xtf32_x2(float c[4], const uint32_t (&ah)[2][4],
                                              const uint32_t (&al)[2][4],
                                              const uint32_t (&bh)[2][2],
                                              const uint32_t (&bl)[2][2]) {
  float z[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mma_tf32(z, al[h], bh[h]);
    mma_tf32(z, ah[h], bl[h]);
    mma_tf32(z, ah[h], bh[h]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) c[i] += z[i];
}

// Four 8 x 4 fp32 blocks of shared memory, one register each: ldmatrix's
// 8 x 8 b16 matrices read as 8 rows of four 32-bit words, so lane 4g + t
// gets word t of row g, the m16n8k8 TF32 fragments' layout. Lane l gives
// the address of row l % 8 of block l / 8.
__device__ __forceinline__ void ldsm_x4(uint32_t r[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void split4(const uint32_t x[4], uint32_t hi[4], uint32_t lo[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) split_tf32(__uint_as_float(x[i]), hi[i], lo[i]);
}

// 16-byte and 4-byte asynchronous copies that read `bytes` (16 or 0, 4 or 0)
// and zero-fill the rest.
__device__ __forceinline__ void cp_async16_zfill(float* smem, const float* gmem, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(vfm::smem_u32(smem)),
               "l"(gmem), "r"(bytes));
}

__device__ __forceinline__ void cp_async4_zfill(float* smem, const float* gmem, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(vfm::smem_u32(smem)),
               "l"(gmem), "r"(bytes));
}

template <int N_>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N_) : "memory");
}

// Rows row0 .. row0 + rows - 1 of one head's token rows (`src` at row 0,
// row stride rs floats) into dst [rows][D + 4]; rows past T_ are zeros.
template <int D>
__device__ __forceinline__ void stage_rows(float* dst, const float* src, size_t rs, int rows,
                                           int row0, int T_, int tid, int nthreads) {
  for (int i = tid; i < rows * (D / 4); i += nthreads) {
    const int r = i / (D / 4), c = (i % (D / 4)) * 4;
    const bool in = row0 + r < T_;
    cp_async16_zfill(dst + r * (D + 4) + c, in ? src + (size_t)(row0 + r) * rs + c : src,
                     in ? 16 : 0);
  }
}

// A landed tile of `rows` rows split in place: the raw fp32 in `hi` becomes
// its TF32 high parts, the remainders go to `lo` (the same layout).
template <int D>
__device__ __forceinline__ void split_rows(float* hi, float* lo, int rows, int tid,
                                           int nthreads) {
  for (int i = tid; i < rows * (D / 4); i += nthreads) {
    const int o = (i / (D / 4)) * (D + 4) + (i % (D / 4)) * 4;
    const float4 x = *reinterpret_cast<const float4*>(hi + o);
    uint4 h, l;
    split_tf32(x.x, h.x, l.x);
    split_tf32(x.y, h.y, l.y);
    split_tf32(x.z, h.z, l.z);
    split_tf32(x.w, h.w, l.w);
    *reinterpret_cast<uint4*>(hi + o) = h;
    *reinterpret_cast<uint4*>(lo + o) = l;
  }
}

// acc (this warp's 16 rows x 8 columns per n-tile) += A B over k = D: A (16 x
// D) from ldmatrix at row `a_base` of a [.][D + 4] tile, B stored [n][k]
// (rows from `b_base` of a [.][D + 4] tile, two n-tiles per ldmatrix). The A
// operand is the resident tile (K or V rows in dK/dV, q or dO rows in dQ),
// split where loaded, B the streamed one: split where loaded, or with
// kPlanes its hi (`b_base`) and lo (`bl_base`) planes. Two k blocks a step.
template <int D, int NT, bool kPlanes>
__device__ __forceinline__ void rows_dot_rows(float acc[NT][4], uint32_t a_base,
                                              uint32_t b_base, uint32_t bl_base, int lane) {
  constexpr int LDB = (D + 4) * 4;  // bytes per row
  const int r = lane & 7, j = lane >> 3;
  // A blocks: (rows 0-7, k 0-3), (rows 8-15, k 0-3), (rows 0-7, k 4-7), (rows 8-15, k 4-7).
  const uint32_t a_addr = a_base + (r + 8 * (j & 1)) * LDB + 16 * (j >> 1);
  // B blocks: (n 0-7, k 0-3), (n 0-7, k 4-7), (n 8-15, k 0-3), (n 8-15, k 4-7).
  const uint32_t b_off = (r + 8 * (j >> 1)) * LDB + 16 * (j & 1);
#pragma unroll 1
  for (int kc = 0; kc < D / 8; kc += 2) {
    uint32_t ah[2][4], al[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t x[4];
      ldsm_x4(x, a_addr + 32 * (kc + h));
      split4(x, ah[h], al[h]);
    }
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t bh[2][4], bl[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t off = b_off + 16 * np * LDB + 32 * (kc + h);
        if constexpr (kPlanes) {
          ldsm_x4(bh[h], b_base + off);
          ldsm_x4(bl[h], bl_base + off);
        } else {
          uint32_t x[4];
          ldsm_x4(x, b_base + off);
          split4(x, bh[h], bl[h]);
        }
      }
#pragma unroll
      for (int m = 0; m < 2; ++m) {  // n-tiles 2np and 2np + 1
        const uint32_t mh[2][2] = {{bh[0][2 * m], bh[0][2 * m + 1]},
                                   {bh[1][2 * m], bh[1][2 * m + 1]}};
        const uint32_t ml[2][2] = {{bl[0][2 * m], bl[0][2 * m + 1]},
                                   {bl[1][2 * m], bl[1][2 * m + 1]}};
        mma_3xtf32_x2(acc[2 * np + m], ah, al, mh, ml);
      }
    }
  }
}

// acc (16 rows x D columns) += A M, where A (16 x KT) is held as the C
// fragments of a product whose columns are M's rows (P^T or dS^T against
// queries, dS against keys) and M is [KT][D + 4] in shared memory (split
// where loaded, or with kPlanes its hi `m` and lo `mlo` planes). The k axis
// is permuted within each block of 8 (fragment k index t is column 2t, t + 4
// is 2t + 1), so the C registers serve as A fragments as they are and B
// reads rows 2t and 2t + 1 of M. Two k blocks per step.
template <int D, int KT, bool kPlanes>
__device__ __forceinline__ void frag_times_rows(float acc[D / 8][4], const float a[KT / 8][4],
                                                const float* m, const float* mlo, int lane) {
  constexpr int LD = D + 4;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kc = 0; kc < KT / 8; kc += 2) {
    uint32_t ah[2][4], al[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      split_tf32(a[kc + h][0], ah[h][0], al[h][0]);
      split_tf32(a[kc + h][2], ah[h][1], al[h][1]);
      split_tf32(a[kc + h][1], ah[h][2], al[h][2]);
      split_tf32(a[kc + h][3], ah[h][3], al[h][3]);
    }
    const int o = (8 * kc + 2 * t) * LD + g;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      uint32_t bh[2][2], bl[2][2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int at = o + (8 * h + e) * LD + 8 * n;
          if constexpr (kPlanes) {
            bh[h][e] = __float_as_uint(m[at]);
            bl[h][e] = __float_as_uint(mlo[at]);
          } else {
            split_tf32(m[at], bh[h][e], bl[h][e]);
          }
        }
      }
      mma_3xtf32_x2(acc[n], ah, al, bh, bl);
    }
  }
}

// This warp's 16 rows of a (T_, D) fp32 gradient, times `mul`, from C
// fragments: rows row0 + g and row0 + g + 8 (if < T_), columns 8n + 2t, +1.
template <int D>
__device__ __forceinline__ void store_frag_rows(float* __restrict__ dst, const float acc[D / 8][4],
                                                size_t rs, int row0, int T_, float mul,
                                                int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int row = row0 + g + 8 * hf;
    if (row >= T_) continue;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<float2*>(dst + (size_t)row * rs + 8 * n + 2 * t) =
          make_float2(acc[n][2 * hf] * mul, acc[n][2 * hf + 1] * mul);
  }
}

// dK and dV: one CTA per block of 16 W keys of one (sample, head), warp w
// owning keys 16w .. 16w + 15; K and V stay in shared memory and 32-query
// tiles of q, dO, L and D stream through two stages of cp.async, q and dO
// split into hi and lo planes once per tile (every warp reads all of them).
// Per tile: S^T = K q^T (A: K rows, B: q rows as stored), P^T = exp2(S^T
// scale log2(e) - L log2(e)) in registers, dV += P^T dO with P^T as A
// fragments; then dP^T = V dO^T, dS^T = P^T (dP^T - D), dK += dS^T q (dP^T
// after dV: one tile of logits fewer live while dV runs). Query rows past
// Tq are zeros (q, dO, L and D), so their P^T = 1 meets dO = q = 0 and adds
// exactly nothing.
template <int D, int W>
__global__ void __launch_bounds__(32 * W, D == 64 ? 2 : 1) dkv_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dk, float* __restrict__ dv, int Tq,
    int Tk, int N, float scale, float scale_log2) {
  using L = F32Layout<D, W, true>;
  constexpr int LD = L::kLd, BQ = L::kWalk, NT = BQ / 8;
  extern __shared__ __align__(16) float smem_f[];
  float* ks = smem_f;                    // [key][d]
  float* vs = ks + L::kRows * LD;        // [key][d]
  float* stages = vs + L::kRows * LD;    // per stage: q, dO hi and lo [query][d], L, D

  const int j0 = blockIdx.x * L::kRows, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, t = lane & 3;
  const size_t rs = (size_t)N * D;
  const float* qh = q + (size_t)b * Tq * rs + (size_t)h * D;
  const float* oh = dout + (size_t)b * Tq * rs + (size_t)h * D;
  const size_t khead = (size_t)b * Tk * rs + (size_t)h * D;
  const size_t srow = ((size_t)b * N + h) * Tq;
  const int n_tiles = (Tq + BQ - 1) / BQ;

  auto load_tile = [&](int it) {
    float* st = stages + (it & 1) * L::kStage;
    const int q0 = it * BQ;
    stage_rows<D>(st, qh, rs, BQ, q0, Tq, tid, L::kThreads);
    stage_rows<D>(st + 2 * BQ * LD, oh, rs, BQ, q0, Tq, tid, L::kThreads);
    for (int i = tid; i < BQ; i += L::kThreads) {
      const bool in = q0 + i < Tq;
      cp_async4_zfill(st + 4 * BQ * LD + i, lse + (in ? srow + q0 + i : 0), in ? 4 : 0);
      cp_async4_zfill(st + 4 * BQ * LD + BQ + i, delta + (in ? srow + q0 + i : 0), in ? 4 : 0);
    }
  };
  stage_rows<D>(ks, k + khead, rs, L::kRows, j0, Tk, tid, L::kThreads);
  stage_rows<D>(vs, v + khead, rs, L::kRows, j0, Tk, tid, L::kThreads);
  load_tile(0);
  vfm::cp_async_commit();

  float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;
  const uint32_t k_base = vfm::smem_u32(ks + 16 * warp * LD);
  const uint32_t v_base = vfm::smem_u32(vs + 16 * warp * LD);

  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) load_tile(it + 1);
    vfm::cp_async_commit();
    cp_async_wait<1>();  // every group but the newest: tile it (and K, V) landed
    __syncthreads();
    float* qs = stages + (it & 1) * L::kStage;  // hi planes, then lo
    float* ql = qs + BQ * LD;
    float* dos = ql + BQ * LD;
    float* dol = dos + BQ * LD;
    const float* ls = dol + BQ * LD;
    const float* ds = ls + BQ;
    split_rows<D>(qs, ql, BQ, tid, L::kThreads);
    split_rows<D>(dos, dol, BQ, tid, L::kThreads);
    __syncthreads();

    float st[NT][4], dpt[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[n][e] = 0.f;
    rows_dot_rows<D, NT, true>(st, k_base, vfm::smem_u32(qs), vfm::smem_u32(ql),
                               lane);  // S^T = K q^T
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const float2 l = *reinterpret_cast<const float2*>(ls + 8 * n + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e)  // P^T
        st[n][e] = vfm::ex2(fmaf(st[n][e], scale_log2, -((e & 1) ? l.y : l.x) * kLog2e));
    }
    frag_times_rows<D, BQ, true>(dva, st, dos, dol, lane);  // dV += P^T dO
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dpt[n][e] = 0.f;
    rows_dot_rows<D, NT, true>(dpt, v_base, vfm::smem_u32(dos), vfm::smem_u32(dol),
                               lane);  // dP^T = V dO^T
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const float2 dd = *reinterpret_cast<const float2*>(ds + 8 * n + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) dpt[n][e] = st[n][e] * (dpt[n][e] - ((e & 1) ? dd.y : dd.x));
    }
    frag_times_rows<D, BQ, true>(dka, dpt, qs, ql, lane);  // dK += dS^T q
    __syncthreads();  // this stage is refilled at iteration it + 1
  }
  store_frag_rows<D>(dk + khead, dka, rs, j0 + 16 * warp, Tk, scale, lane);
  store_frag_rows<D>(dv + khead, dva, rs, j0 + 16 * warp, Tk, 1.f, lane);
}

// dQ: one CTA per block of 16 W queries, warp w owning queries 16w ..
// 16w + 15; q and dO stay in shared memory, 64-key tiles of K and V stream
// through two stages. Per tile: S = q K^T and dP = dO V^T, P = exp2(S scale
// log2(e) - L log2(e)) (0 for keys past Tk) and dS = P (dP - D) in
// registers, dQ += dS K with dS as A fragments. L and D of the warp's rows
// stay in registers (+inf and 0 past Tq: P = 0).
template <int D, int W>
__global__ void __launch_bounds__(32 * W, D == 64 ? 2 : 1) dq_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dq, int Tq, int Tk, int N, float scale,
    float scale_log2) {
  using L = F32Layout<D, W, false>;
  constexpr int LD = L::kLd, BK = L::kWalk, NT = BK / 8;
  extern __shared__ __align__(16) float smem_f[];
  float* qs = smem_f;                    // [query][d]
  float* dos = qs + L::kRows * LD;       // [query][d]
  float* stages = dos + L::kRows * LD;   // per stage: K, V [key][d]

  const int q0 = blockIdx.x * L::kRows, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const size_t rs = (size_t)N * D;
  const size_t qhead = (size_t)b * Tq * rs + (size_t)h * D;
  const float* kh = k + (size_t)b * Tk * rs + (size_t)h * D;
  const float* vh = v + (size_t)b * Tk * rs + (size_t)h * D;
  const size_t srow = ((size_t)b * N + h) * Tq;
  const int n_tiles = (Tk + BK - 1) / BK;

  auto load_tile = [&](int it) {
    float* st = stages + (it & 1) * L::kStage;
    stage_rows<D>(st, kh, rs, BK, it * BK, Tk, tid, L::kThreads);
    stage_rows<D>(st + BK * LD, vh, rs, BK, it * BK, Tk, tid, L::kThreads);
  };
  stage_rows<D>(qs, q + qhead, rs, L::kRows, q0, Tq, tid, L::kThreads);
  stage_rows<D>(dos, dout + qhead, rs, L::kRows, q0, Tq, tid, L::kThreads);
  load_tile(0);
  vfm::cp_async_commit();

  float lr[2], dr[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int row = q0 + 16 * warp + g + 8 * hf;
    lr[hf] = row < Tq ? lse[srow + row] * kLog2e : INFINITY;
    dr[hf] = row < Tq ? delta[srow + row] : 0.f;
  }
  float dqa[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[n][e] = 0.f;
  const uint32_t q_base = vfm::smem_u32(qs + 16 * warp * LD);
  const uint32_t o_base = vfm::smem_u32(dos + 16 * warp * LD);

  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) load_tile(it + 1);
    vfm::cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* kts = stages + (it & 1) * L::kStage;
    const float* vts = kts + BK * LD;

    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
    rows_dot_rows<D, NT, false>(s, q_base, vfm::smem_u32(kts), 0, lane);   // S = q K^T
    rows_dot_rows<D, NT, false>(dp, o_base, vfm::smem_u32(vts), 0, lane);  // dP = dO V^T
    const int kb = it * BK;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kb + 8 * n + 2 * t + (e & 1);
        const float p = key < Tk ? vfm::ex2(fmaf(s[n][e], scale_log2, -lr[e >> 1])) : 0.f;
        s[n][e] = p * (dp[n][e] - dr[e >> 1]);  // dS
      }
    }
    frag_times_rows<D, BK, false>(dqa, s, kts, nullptr, lane);  // dQ += dS K
    __syncthreads();
  }
  store_frag_rows<D>(dq + qhead, dqa, rs, q0 + 16 * warp, Tq, scale, lane);
}

// Consumer warpgroups per CTA of a bf16 backward kernel whose work tiles are
// blocks of T rows (keys for dK/dV, queries for dQ) on `sms` SMs: one (64
// rows) when the 64-row blocks fit on the SMs in one wave, else two.
int bwd_wgs(int B, int T, int N, int sms) {
  return (long long)B * N * ((T + 63) / 64) > sms ? 2 : 1;
}

// Persistent: at most one CTA per SM, each walking work tiles.
int bwd_grid(long long n_work) {
  return (int)(n_work < vfm::sm_count() ? n_work : vfm::sm_count());
}

// q and dO (B, Tq, N, D), k and v (B, Tk, N, D) as tensor maps of 64-row boxes.
struct BwdMaps {
  CUtensorMap q, dout, k, v;
};

template <int D, int NWG>
cudaError_t launch_dkv(const BwdMaps& m, const float* lse, const float* delta,
                       const float* parts, void* dk, void* dv, void* dnk, void* dnv, int B, int Tq,
                       int Tk, int N, float scale, cudaStream_t s) {
  using L = DkvLayout<D, NWG>;
  static std::atomic<unsigned long long> attr_done{0};
  const cudaError_t err = vfm::smem_limit_once(flash_bwd_dkv_kernel<D, NWG>, L::kSmem, attr_done);
  if (err != cudaSuccess) return err;
  const long long n_work = (long long)((Tk + L::kRowsRes - 1) / L::kRowsRes) * N * B;
  flash_bwd_dkv_kernel<D, NWG><<<bwd_grid(n_work), L::kThreads, L::kSmem, s>>>(
      m.k, m.v, m.q, m.dout, lse, delta, parts, static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      static_cast<bf16*>(dnk), static_cast<bf16*>(dnv), B, Tq, Tk, N, scale, scale * kLog2e);
  return cudaGetLastError();
}

template <int D, int NWG>
cudaError_t launch_dq(const BwdMaps& m, const void* nk, const void* nv, const float* lse,
                      const float* delta, void* dq, int B, int Tq, int Tk, int N, float scale,
                      cudaStream_t s) {
  using L = DqLayout<D, NWG>;
  static std::atomic<unsigned long long> attr_done{0};
  const cudaError_t err = vfm::smem_limit_once(flash_bwd_dq_kernel<D, NWG>, L::kSmem, attr_done);
  if (err != cudaSuccess) return err;
  const long long n_work = (long long)((Tq + L::kRowsRes - 1) / L::kRowsRes) * N * B;
  flash_bwd_dq_kernel<D, NWG><<<bwd_grid(n_work), L::kThreads, L::kSmem, s>>>(
      m.q, m.dout, m.k, m.v, static_cast<const bf16*>(nk), static_cast<const bf16*>(nv), lse,
      delta, static_cast<bf16*>(dq), B, Tq, Tk, N, scale, scale * kLog2e);
  return cudaGetLastError();
}

// The bf16 backward: with `out`, the pre-pass (D, and K3's null-token sums);
// with dk, the dK/dV kernel; with dq, the dQ kernel; all on stream s.
template <int D>
cudaError_t launch_bwd_bf16(const void* q, const void* k, const void* v, const void* nk,
                            const void* nv, const void* out, const void* dout, const float* lse,
                            float* delta, float* parts, void* dq, void* dk, void* dv, void* dnk,
                            void* dnv, int B, int Tq, int Tk, int N, float scale,
                            cudaStream_t s) {
  cudaError_t err = cudaSuccess;
  if (out != nullptr) {
    err = nk != nullptr
              ? launch_null_prepass<D>(q, out, dout, nk, nv, lse, delta, parts, B, Tq, N, scale, s)
              : launch_delta_bf16<D>(out, dout, delta, B, Tq, N, s);
    if (err != cudaSuccess) return err;
  }
  if (dk == nullptr && dq == nullptr) return cudaSuccess;
  BwdMaps m;
  if ((err = vfm::tensor_map(&m.q, q, B, Tq, N, D, 64)) != cudaSuccess) return err;
  if ((err = vfm::tensor_map(&m.dout, dout, B, Tq, N, D, 64)) != cudaSuccess) return err;
  if ((err = vfm::tensor_map(&m.k, k, B, Tk, N, D, 64)) != cudaSuccess) return err;
  if ((err = vfm::tensor_map(&m.v, v, B, Tk, N, D, 64)) != cudaSuccess) return err;
  const int sms = vfm::sm_count();
  if (dk != nullptr) {
    err = bwd_wgs(B, Tk, N, sms) == 2
              ? launch_dkv<D, 2>(m, lse, delta, parts, dk, dv, dnk, dnv, B, Tq, Tk, N, scale, s)
              : launch_dkv<D, 1>(m, lse, delta, parts, dk, dv, dnk, dnv, B, Tq, Tk, N, scale, s);
    if (err != cudaSuccess) return err;
  }
  if (dq != nullptr)
    err = bwd_wgs(B, Tq, N, sms) == 2
              ? launch_dq<D, 2>(m, nk, nv, lse, delta, dq, B, Tq, Tk, N, scale, s)
              : launch_dq<D, 1>(m, nk, nv, lse, delta, dq, B, Tq, Tk, N, scale, s);
  return err;
}

template <int D, int W>
cudaError_t launch_dkv_f32(const void* q, const void* k, const void* v, const void* dout,
                           const float* lse, const float* delta, void* dk, void* dv, int B,
                           int Tq, int Tk, int N, float scale, cudaStream_t s) {
  using L = F32Layout<D, W, true>;
  static std::atomic<unsigned long long> attr_done{0};
  const cudaError_t err = vfm::smem_limit_once(dkv_f32_kernel<D, W>, L::kSmem, attr_done);
  if (err != cudaSuccess) return err;
  dim3 grid((Tk + L::kRows - 1) / L::kRows, N, B);
  dkv_f32_kernel<D, W><<<grid, L::kThreads, L::kSmem, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), lse, delta, static_cast<float*>(dk),
      static_cast<float*>(dv), Tq, Tk, N, scale, scale * kLog2e);
  return cudaGetLastError();
}

template <int D, int W>
cudaError_t launch_dq_f32(const void* q, const void* k, const void* v, const void* dout,
                          const float* lse, const float* delta, void* dq, int B, int Tq, int Tk,
                          int N, float scale, cudaStream_t s) {
  using L = F32Layout<D, W, false>;
  static std::atomic<unsigned long long> attr_done{0};
  const cudaError_t err = vfm::smem_limit_once(dq_f32_kernel<D, W>, L::kSmem, attr_done);
  if (err != cudaSuccess) return err;
  dim3 grid((Tq + L::kRows - 1) / L::kRows, N, B);
  dq_f32_kernel<D, W><<<grid, L::kThreads, L::kSmem, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), lse, delta, static_cast<float*>(dq), Tq, Tk, N, scale,
      scale * kLog2e);
  return cudaGetLastError();
}

// The fp32 backward, as launch_bwd_bf16 (no null token).
template <int D>
cudaError_t launch_bwd_f32(const void* q, const void* k, const void* v, const void* out,
                           const void* dout, const float* lse, float* delta, void* dq, void* dk,
                           void* dv, int B, int Tq, int Tk, int N, float scale, cudaStream_t s) {
  cudaError_t err = cudaSuccess;
  if (out != nullptr &&
      (err = launch_delta<float, D>(out, dout, delta, B, Tq, N, s)) != cudaSuccess)
    return err;
  const int sms = vfm::sm_count();
  if (dk != nullptr) {
    err = f32_warps(B, Tk, N, sms) == 4
              ? launch_dkv_f32<D, 4>(q, k, v, dout, lse, delta, dk, dv, B, Tq, Tk, N, scale, s)
              : launch_dkv_f32<D, 2>(q, k, v, dout, lse, delta, dk, dv, B, Tq, Tk, N, scale, s);
    if (err != cudaSuccess) return err;
  }
  if (dq != nullptr)
    err = f32_warps(B, Tq, N, sms) == 4
              ? launch_dq_f32<D, 4>(q, k, v, dout, lse, delta, dq, B, Tq, Tk, N, scale, s)
              : launch_dq_f32<D, 2>(q, k, v, dout, lse, delta, dq, B, Tq, Tk, N, scale, s);
  return err;
}

}  // namespace

// K3's backward, one call: q, k, v, out, dout (B, T, N, 64) bf16, null_k,
// null_v (B, 1, N, 64), lse (B, N, T). With `out`, the pre-pass writes D into
// `delta` (B, N, T) and the null token's chunk sums into `partials` (B, N,
// ceil(T / 64), 2, 64 floats); without it `delta` is read. With dk (then dv,
// dnull_k, dnull_v and `out` too) the dK/dV kernel runs, with dq the dQ kernel.
extern "C" int vfm_flash_attention_nullkv_bwd(
    const void* q, const void* k, const void* v, const void* null_k, const void* null_v,
    const void* out, const void* dout, const float* lse, float* delta, float* partials, void* dq,
    void* dk, void* dv, void* dnull_k, void* dnull_v, int B, int T, int N, int D, float scale,
    void* stream) {
  if (D != 64 || T <= 0 || null_k == nullptr || null_v == nullptr)
    return (int)cudaErrorInvalidValue;
  if (dk != nullptr && (out == nullptr || partials == nullptr || dv == nullptr ||
                        dnull_k == nullptr || dnull_v == nullptr))
    return (int)cudaErrorInvalidValue;
  return (int)launch_bwd_bf16<64>(q, k, v, null_k, null_v, out, dout, lse, delta, partials, dq,
                                  dk, dv, dnull_k, dnull_v, B, T, T, N, scale,
                                  static_cast<cudaStream_t>(stream));
}

// K4's backward, one call: q, out, dout (B, Tq, N, D), k, v (B, Tk, N, D), D in
// {64, 128}, bf16 (fp32 == 0) or fp32 (fp32 == 1); lse, delta (B, N, Tq).
// With `out` the pre-pass writes D, else `delta` is read; dk (with dv) and dq
// select the kernels.
extern "C" int vfm_flash_attention_bwd(const void* q, const void* k, const void* v,
                                       const void* out, const void* dout, const float* lse,
                                       float* delta, void* dq, void* dk, void* dv, int B, int Tq,
                                       int Tk, int N, int D, float scale, int fp32,
                                       void* stream) {
  if (Tq <= 0 || Tk <= 0 || (dk != nullptr && dv == nullptr)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fp32) {
    if (D == 64)
      return (int)launch_bwd_f32<64>(q, k, v, out, dout, lse, delta, dq, dk, dv, B, Tq, Tk, N,
                                     scale, s);
    if (D == 128)
      return (int)launch_bwd_f32<128>(q, k, v, out, dout, lse, delta, dq, dk, dv, B, Tq, Tk, N,
                                      scale, s);
  } else {
    if (D == 64)
      return (int)launch_bwd_bf16<64>(q, k, v, nullptr, nullptr, out, dout, lse, delta, nullptr,
                                      dq, dk, dv, nullptr, nullptr, B, Tq, Tk, N, scale, s);
    if (D == 128)
      return (int)launch_bwd_bf16<128>(q, k, v, nullptr, nullptr, out, dout, lse, delta, nullptr,
                                       dq, dk, dv, nullptr, nullptr, B, Tq, Tk, N, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}

// The bf16 backward's launch plan for q (B, Tq, N, D), k (B, Tk, N, D) on a
// card with `sms` SMs. plan[0..6], the dK/dV kernel: consumer warpgroups, keys
// per work tile, queries per streamed tile, ring stages, threads per CTA,
// dynamic shared memory in bytes, CTAs; plan[7..13] the same for the dQ
// kernel (queries per work tile, keys per streamed tile); plan[14] query rows
// per pre-pass CTA (one partial sum of the null token's gradients each).
extern "C" int vfm_flash_bwd_plan(int B, int Tq, int Tk, int N, int D, int sms, int* plan) {
  if ((D != 64 && D != 128) || Tq <= 0 || Tk <= 0) return (int)cudaErrorInvalidValue;
  auto fill = [&](int* p, auto layout, int T) {
    using L = decltype(layout);
    const long long work = (long long)((T + L::kRowsRes - 1) / L::kRowsRes) * N * B;
    const int vals[7] = {L::kRowsRes / 64, L::kRowsRes, L::kKT, L::kStages, L::kThreads,
                         L::kSmem, (int)(work < sms ? work : sms)};
    for (int i = 0; i < 7; ++i) p[i] = vals[i];
  };
  const bool k2 = bwd_wgs(B, Tk, N, sms) == 2, q2 = bwd_wgs(B, Tq, N, sms) == 2;
  if (D == 64) {
    k2 ? fill(plan, DkvLayout<64, 2>{}, Tk) : fill(plan, DkvLayout<64, 1>{}, Tk);
    q2 ? fill(plan + 7, DqLayout<64, 2>{}, Tq) : fill(plan + 7, DqLayout<64, 1>{}, Tq);
  } else {
    k2 ? fill(plan, DkvLayout<128, 2>{}, Tk) : fill(plan, DkvLayout<128, 1>{}, Tk);
    q2 ? fill(plan + 7, DqLayout<128, 2>{}, Tq) : fill(plan + 7, DqLayout<128, 1>{}, Tq);
  }
  plan[14] = kPrepassRows;
  return 0;
}

// The fp32 backward's launch plan for q (B, Tq, N, D), k (B, Tk, N, D) on a
// card with `sms` SMs. plan[0..5], the dK/dV kernel: warps per CTA, keys per
// CTA, queries per streamed tile, stages, dynamic shared memory in bytes,
// CTAs; plan[6..11] the same for the dQ kernel (queries per CTA, keys per
// streamed tile).
extern "C" int vfm_flash_bwd_f32_plan(int B, int Tq, int Tk, int N, int D, int sms, int* plan) {
  if ((D != 64 && D != 128) || Tq <= 0 || Tk <= 0) return (int)cudaErrorInvalidValue;
  auto fill = [&](int* p, auto layout, int T) {
    using L = decltype(layout);
    const int vals[6] = {L::kThreads / 32, L::kRows, L::kWalk, L::kStages, L::kSmem,
                         (T + L::kRows - 1) / L::kRows * N * B};
    for (int i = 0; i < 6; ++i) p[i] = vals[i];
  };
  const bool k4 = f32_warps(B, Tk, N, sms) == 4, q4 = f32_warps(B, Tq, N, sms) == 4;
  if (D == 64) {
    k4 ? fill(plan, F32Layout<64, 4, true>{}, Tk) : fill(plan, F32Layout<64, 2, true>{}, Tk);
    q4 ? fill(plan + 6, F32Layout<64, 4, false>{}, Tq)
       : fill(plan + 6, F32Layout<64, 2, false>{}, Tq);
  } else {
    k4 ? fill(plan, F32Layout<128, 4, true>{}, Tk) : fill(plan, F32Layout<128, 2, true>{}, Tk);
    q4 ? fill(plan + 6, F32Layout<128, 4, false>{}, Tq)
       : fill(plan + 6, F32Layout<128, 2, false>{}, Tq);
  }
  return 0;
}

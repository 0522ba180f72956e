// K3 and K4: flash attention forward for Hopper, with a learned null
// key/value (K3) or without one (K4).
//
// K3 replaces vfm_vae_tpu/ops/pallas/flash_attention.py:91
// flash_attention_nullkv (jax's library Pallas TPU flash kernel behind a
// pad-to-128 + segment-id mask): softmax(q [null_k; k]^T * scale) [null_v; v]
// per (sample, head). K4 replaces vfm_vae_tpu/ops/pallas/flash_attention.py:53
// flash_attention (the same library kernel without the null token,
// full-sequence blocks): softmax(q k^T * scale) v, for the SigLIP tower
// (bf16, d = 64), the adapter's AttnProjections (fp32) and d = 128. Both keep
// the online softmax in fp32.
//
// Bound on the H100: 4 Tq Tk d flops against 2 (Tq + 2 Tk) d bytes per
// (sample, head), i.e. ~T/2 flops per byte at Tq = Tk = T. The card's bf16
// ridge is ~295 flops per byte, so the tower's, the d = 128 shape's and K3's
// T = 1024 sites are bound by the tensor cores, and T <= 576 (K3's EQ
// buckets, the adapter's T = 256) by bytes; there a call's few microseconds
// of work make the launch and the wrapper's host time the real limit. The
// (Tq, Tk) logits never reach device memory. At d = 64 the exponentials (one
// per logit on the special-function unit, 16 a clock per SM) take as long as
// the two products. PERF.md gives the measured times and what removing the
// loads, the exponentials or one product changes.
//
// bf16 design (flash_fwd_kernel<D, NWG>), against the six limits of the
// first port (mma.sync only, synchronous staging, a scalar V transpose,
// scalar fragment loads, 64 x 64 tiles, a heavy launch path):
// - Both products on wgmma. S = Q K^T (m64n128k16) reads Q and K from shared
//   memory; O += P V (m64nDk16) takes P from registers, the softmax output
//   packed to bf16 in the A-fragment layout, and V from shared memory as
//   stored, [key][d], as an MN-major B operand: no transpose pass and no
//   fragment loads. Q is loaded once per work tile.
// - K/V tiles of 128 keys arrive by TMA (4-D tensor maps over the native
//   (B, T, N, D) layout, box (64, 1, rows, 1), 128-byte swizzle, two boxes
//   per tile at d = 128) into a ring of three stages, completed on mbarriers,
//   K and V apart, so a tile's S starts before its V lands. TMA zero-fills
//   rows past T without crossing into the next sample. A producer
//   warpgroup (one lane) issues every load as soon as the consumers release
//   a stage. The kernel enters with 168 registers a thread, the most three
//   warpgroups can hold; at d = 128 the producer gives all but 24 to the
//   consumers (setmaxnreg: 240 each). The compiler honours setmaxnreg only
//   where the roles are a warp-uniform branch and the kernel holds no
//   __trap().
// - CTAs of 128 queries: two consumer warpgroups of 64 rows (one, 64
//   queries, where B * N * ceil(Tq / 128) would leave an SM without a CTA).
//   The two take turns to issue their products (named barriers 1 and 2,
//   immediate ids), so one's softmax runs while the other's products hold
//   the tensor cores. Each also issues tile j's S together with tile j-1's
//   PV and runs tile j's softmax while that PV is in flight. Shared memory:
//   113 KB at d = 64 and 225 KB at d = 128 (three stages, two warpgroups),
//   within 227.
// - Persistent: min(work tiles, SMs x CTAs per SM) CTAs walk the (query
//   block, head, sample) work tiles, the ring running on across them, so a
//   work tile's first loads overlap the previous one's last products.
// - K3's null token: q . null_k is computed once per row from Q in shared
//   memory, and the online softmax starts from it (m = its scaled logit,
//   l = 1, O = null_v), so the walk over k starts at k's key 0 and its tiles
//   align with k's rows. P is rounded to bf16 for the PV product, as every
//   flash kernel does; the null token's weight stays in fp32.
// - The launch encodes three tensor maps and sets the dynamic shared-memory
//   attribute once per template instance and device.
// The layout, the ring and its producer, the products and the launch
// helpers are in flash.cuh, shared with the backward kernels.
//
// fp32 design (K4 at the adapter, which computes in fp32 in both packages):
// fp32 FMA on the CUDA cores, no TF32. One CTA of 256 threads per (64-query
// tile, head, sample); thread (ty, tx) owns query rows 4ty..4ty+3, keys
// tx + 16i of each 64-key tile and output columns 4tx.. (+64); P goes through
// shared memory between the two products.
//
// Training mode: given an `lse` pointer, the kernel (bf16 or fp32) also
// writes each query row's log-sum-exp over the walk (natural-log units,
// fp32, the null token included), the residual that the backward kernels
// (flash_attention_nullkv_bwd.cu) recompute P from.
//
// Layouts: q, out (B, Tq, N, D); k, v (B, Tk, N, D); null_k, null_v
// (B, 1, N, D) or null; bf16 or (K4) fp32; lse (B, N, Tq) fp32 or null.
#include "flash.cuh"

namespace {

using vfm::bf16;

// fp32 kernel tiles.
constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreadsF32 = 256;

// Shared-memory layout of flash_fwd_kernel with NWG consumer warpgroups
// (flash.cuh): Q resident (one box of 64 NWG rows per 64 columns), K/V tiles
// of 128 keys streamed through three stages.
template <int D, int NWG>
struct FwdLayout : vfm::RingLayout<D, NWG, 1, 64 * NWG, 128, 3, 0> {
  // At d = 128 the consumers need about 220 registers (O, S and P of 64
  // rows), so the producer gives up all but 24 and each consumer thread
  // gets 240. At d = 64 the 168 of entry suffice, and moving registers
  // measured slower at the tower's shape (`probes/flash_forward.py`).
  static constexpr bool kMoveRegisters = D == 128;
  static constexpr int kConsumerRegs = 240;
};

using vfm::fence_all;

// Online softmax of one tile in log2 units: keys past Tk (zero-filled) are
// masked, the running max m and sum l updated, sc replaced by
// exp2(sc * scale - m), alpha the factor that rescales the earlier O.
template <int KT>
__device__ __forceinline__ void online_softmax(float (&sc)[KT / 2], float (&m)[2],
                                               float (&l)[2], float (&alpha)[2], int kb, int Tk,
                                               int t, float scale_log2) {
  if (kb + KT > Tk) {
#pragma unroll
    for (int c = 0; c < KT / 8; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (kb + 8 * c + 2 * t + (e & 1) >= Tk) sc[4 * c + e] = -INFINITY;
  }
  // Four independent partial maxima and sums per row (columns 2t and
  // 2t + 1 of even and odd chunks) shorten the dependency chains.
  float mx4[2][4], sum4[2][4];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf)
#pragma unroll
    for (int p = 0; p < 4; ++p) mx4[hf][p] = -INFINITY, sum4[hf][p] = 0.f;
#pragma unroll
  for (int c = 0; c < KT / 8; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      mx4[e >> 1][(c & 1) * 2 + (e & 1)] = fmaxf(mx4[e >> 1][(c & 1) * 2 + (e & 1)], sc[4 * c + e]);
  float mx[2], rowsum[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    mx[hf] = fmaxf(fmaxf(mx4[hf][0], mx4[hf][1]), fmaxf(mx4[hf][2], mx4[hf][3]));
    mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 1));
    mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 2));
    const float mnew = fmaxf(m[hf], mx[hf] * scale_log2);  // finite: key kb is valid
    alpha[hf] = vfm::ex2(m[hf] - mnew);
    m[hf] = mnew;
  }
#pragma unroll
  for (int c = 0; c < KT / 8; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      sc[4 * c + e] = vfm::ex2(fmaf(sc[4 * c + e], scale_log2, -m[e >> 1]));
      sum4[e >> 1][(c & 1) * 2 + (e & 1)] += sc[4 * c + e];
    }
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    rowsum[hf] = (sum4[hf][0] + sum4[hf][1]) + (sum4[hf][2] + sum4[hf][3]);
    rowsum[hf] += __shfl_xor_sync(0xffffffffu, rowsum[hf], 1);
    rowsum[hf] += __shfl_xor_sync(0xffffffffu, rowsum[hf], 2);
    l[hf] = l[hf] * alpha[hf] + rowsum[hf];
  }
}

// O *= alpha (row g, row g + 8), then P into the A-fragment layout of
// m64nNk16, rounded to bf16: keys 16 kk .. 16 kk + 15 in pa[kk].
template <int D, int KT>
__device__ __forceinline__ void rescale_and_pack(float (&o)[D / 2], uint32_t (&pa)[KT / 16][4],
                                                 const float (&sc)[KT / 2],
                                                 const float (&alpha)[2]) {
#pragma unroll
  for (int c = 0; c < D / 8; ++c) {
    o[4 * c] *= alpha[0];
    o[4 * c + 1] *= alpha[0];
    o[4 * c + 2] *= alpha[1];
    o[4 * c + 3] *= alpha[1];
  }
  vfm::pack_a<KT>(pa, sc);
}

// One consumer warpgroup `wg` of flash_fwd_kernel on the CTA's it-th work
// tile: its 64 query rows against every key tile, then the output rows and
// their log-sum-exp. K/V tile j of the work tile is tile it * n_tiles + j of
// the ring walk; Q arrives on phase it of res_full, and res_empty is released
// once the last S = Q K^T has completed, so the next work tile's Q loads
// while this one finishes.
template <int D, int NWG, typename L>
__device__ __forceinline__ void consume(const vfm::Ring<L>& ld, const unsigned char* smem,
                                        const bf16* __restrict__ nk, const bf16* __restrict__ nv,
                                        bf16* __restrict__ out, float* __restrict__ lse, int it,
                                        int wg, int Tq, int Tk, int N, float scale_log2) {
  // Consumer warpgroup wg owns tile rows 64 wg .. 64 wg + 63; in the wgmma
  // accumulator layout this thread holds rows r0 and r0 + 8, columns
  // 8 c + 2 t and 8 c + 2 t + 1 of every 8-column chunk c.
  const int lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  const int r0 = wg * 64 + (threadIdx.x / 32 % 4) * 16 + g;
  const vfm::WorkTile wt = ld.tile(it);
  const int q0 = wt.r0, h = wt.h, b = wt.b, n_tiles = ld.n_tiles, g0 = it * n_tiles;
  const size_t rs = (size_t)N * D;  // stride between tokens
  float m[2], l[2], o[D / 2];
  vfm::mbar_wait(ld.res_full(), it & 1);
  if (nk != nullptr) {
    // Key 0 of the walk, the null token, seeds the online softmax.
    const size_t nhead = ((size_t)b * N + h) * D;
    float dot[2];
    vfm::rows_dot<D>(dot, smem, L::kResBox, nk + nhead, r0, t);
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      m[hf] = dot[hf] * scale_log2;
      l[hf] = 1.f;
    }
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      const float2 v0 =
          vfm::unpack_bf16(*reinterpret_cast<const uint32_t*>(nv + nhead + 8 * c + 2 * t));
      o[4 * c] = o[4 * c + 2] = v0.x;
      o[4 * c + 1] = o[4 * c + 3] = v0.y;
    }
  } else {
    m[0] = m[1] = -INFINITY;
    l[0] = l[1] = 0.f;
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  }

  // With two consumer warpgroups, each issues its products only in its turn
  // (named barrier 1 + wg) and then passes the turn to the other, so one
  // warpgroup's softmax runs while the other's products hold the tensor cores.
  auto take_turn = [&] {
    if constexpr (NWG > 1) wg == 0 ? vfm::named_sync<1, 256>() : vfm::named_sync<2, 256>();
  };
  auto pass_turn = [&] {
    if constexpr (NWG > 1) wg == 0 ? vfm::named_arrive<2, 256>() : vfm::named_arrive<1, 256>();
  };
  auto stage = [](int gi) { return gi % L::kStages; };
  auto parity = [](int gi) { return (uint32_t)(gi / L::kStages) & 1; };
  const uint32_t q_rows = ld.res_s + wg * 64 * 128, ks = ld.a_s, vs = ld.b_s;
  float sc[L::kKT / 2], alpha[2];
  uint32_t pa[L::kKT / 16][4];
  // Software pipeline: tile j's S = Q K^T is issued together with tile
  // j-1's O += P V, and tile j's softmax runs while the PV product is in
  // flight; O is rescaled and P repacked once that product has completed.
  vfm::mbar_wait(ld.a_full(stage(g0)), parity(g0));
  take_turn();
  vfm::wgmma_fence();
  vfm::issue_ss<D, L>(sc, q_rows, ks + stage(g0) * L::kTile);
  vfm::wgmma_commit();
  pass_turn();
  vfm::wgmma_wait<0>();
  fence_all(sc);
  if (n_tiles == 1) vfm::mbar_arrive(ld.res_empty());
  online_softmax<L::kKT>(sc, m, l, alpha, 0, Tk, t, scale_log2);
  rescale_and_pack<D, L::kKT>(o, pa, sc, alpha);
  for (int j = 1; j < n_tiles; ++j) {
    const int s = stage(g0 + j), sp = stage(g0 + j - 1);
    vfm::mbar_wait(ld.a_full(s), parity(g0 + j));
    vfm::mbar_wait(ld.b_full(sp), parity(g0 + j - 1));
    take_turn();
    vfm::wgmma_fence();
    vfm::issue_ss<D, L>(sc, q_rows, ks + s * L::kTile);
    vfm::wgmma_commit();
    vfm::issue_rs<D, L>(o, pa, vs + sp * L::kTile);
    vfm::wgmma_commit();
    pass_turn();
    vfm::wgmma_wait<1>();  // S of tile j
    fence_all(sc);
    if (j == n_tiles - 1) vfm::mbar_arrive(ld.res_empty());
    online_softmax<L::kKT>(sc, m, l, alpha, j * L::kKT, Tk, t, scale_log2);
    vfm::wgmma_wait<0>();  // PV of tile j-1
    fence_all(o);
    fence_all(pa);
    vfm::mbar_arrive(ld.empty(sp));
    rescale_and_pack<D, L::kKT>(o, pa, sc, alpha);
  }
  const int sl = stage(g0 + n_tiles - 1);
  vfm::mbar_wait(ld.b_full(sl), parity(g0 + n_tiles - 1));
  take_turn();
  vfm::wgmma_fence();
  vfm::issue_rs<D, L>(o, pa, vs + sl * L::kTile);
  vfm::wgmma_commit();
  pass_turn();
  vfm::wgmma_wait<0>();
  fence_all(o);
  fence_all(pa);
  vfm::mbar_arrive(ld.empty(sl));

  const size_t qhead = (size_t)b * Tq * rs + (size_t)h * D;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int tok = q0 + r0 + 8 * hf;
    if (tok >= Tq) continue;
    const float inv = 1.f / l[hf];
#pragma unroll
    for (int c = 0; c < D / 8; ++c)
      *reinterpret_cast<uint32_t*>(out + qhead + (size_t)tok * rs + 8 * c + 2 * t) =
          vfm::pack_bf16(o[4 * c + 2 * hf] * inv, o[4 * c + 2 * hf + 1] * inv);
    if (lse != nullptr && t == 0)
      lse[((size_t)b * N + h) * Tq + tok] = (m[hf] + log2f(l[hf])) * 0.6931471805599453f;
  }
}

// Persistent: CTA c walks work tiles c, c + gridDim.x, ... of the (query
// block, head, sample) grid; the K/V ring runs on across work tiles, so the
// next work tile's loads overlap this one's last products and stores.
template <int D, int NWG>
__global__ void __launch_bounds__((NWG + 1) * 128, 1) flash_fwd_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, const bf16* __restrict__ nk,
    const bf16* __restrict__ nv, bf16* __restrict__ out, float* __restrict__ lse, int B, int Tq,
    int Tk, int N, float scale_log2) {
  using L = FwdLayout<D, NWG>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = vfm::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const unsigned char* smem = smem_raw + (base - raw);  // generic pointer to `base`
  const int n_qblocks = (Tq + L::kRowsRes - 1) / L::kRowsRes;
  const vfm::Ring<L> ld{{&tq}, &tk, &tv, base, base + L::kA, base + L::kB, base + L::kBar,
                        (Tk + L::kKT - 1) / L::kKT, n_qblocks, n_qblocks * N * B, N, Tq};
  if (threadIdx.x == 0) ld.init();
  __syncthreads();

  // Warpgroup 0 produces: one lane issues every TMA load (and, at d = 128,
  // the warpgroup hands its registers to the consumers, warpgroups
  // 1..NWG). The role is read through a shuffle so that the compiler sees
  // it is uniform per warp and can give each role its own register budget;
  // the two paths never rejoin.
  const int role = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (role == 0) {
    if constexpr (L::kMoveRegisters) vfm::reg_dealloc<24>();
    if (threadIdx.x == 0) ld.produce();
  } else {
    if constexpr (L::kMoveRegisters) vfm::reg_alloc<L::kConsumerRegs>();
    const int wg = role - 1;
    if (NWG > 1 && wg == 1) vfm::named_arrive<1, 256>();  // warpgroup 0 goes first
    for (int it = 0; ld.work(it) < ld.n_work; ++it)
      consume<D, NWG, L>(ld, smem, nk, nv, out, lse, it, wg, Tq, Tk, N, scale_log2);
    if (NWG > 1 && wg == 0) vfm::named_sync<1, 256>();  // the other warpgroup's last pass
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


using vfm::sm_count;
using vfm::smem_limit_once;
using vfm::tensor_map;

// Consumer warpgroups per CTA of the bf16 forward for (B, Tq, N) on `sms`
// SMs: two (128 queries) unless B * N * ceil(Tq / 128) CTAs would leave an
// SM without one; then one (64 queries).
int fwd_wgs(int B, int Tq, int N, int sms) {
  return (long long)B * N * ((Tq + 127) / 128) >= sms ? 2 : 1;
}

template <int D, int NWG>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, const void* nk,
                        const void* nv, void* out, float* lse, int B, int Tq, int Tk, int N,
                        float scale, cudaStream_t stream) {
  using L = FwdLayout<D, NWG>;
  static std::atomic<unsigned long long> attr_done{0};
  cudaError_t err = smem_limit_once(flash_fwd_kernel<D, NWG>, L::kSmem, attr_done);
  if (err != cudaSuccess) return err;
  // CTAs resident per SM, once per template instance (the card's limits).
  static const int per_sm = [] {
    int n = 1;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, flash_fwd_kernel<D, NWG>, L::kThreads,
                                                  L::kSmem);
    return n > 0 ? n : 1;
  }();
  CUtensorMap tq, tk, tv;
  if ((err = tensor_map(&tq, q, B, Tq, N, D, L::kRowsRes)) != cudaSuccess) return err;
  if ((err = tensor_map(&tk, k, B, Tk, N, D, L::kKT)) != cudaSuccess) return err;
  if ((err = tensor_map(&tv, v, B, Tk, N, D, L::kKT)) != cudaSuccess) return err;
  const long long n_work = (long long)((Tq + L::kRowsRes - 1) / L::kRowsRes) * N * B;
  const int grid = (int)(n_work < (long long)per_sm * sm_count() ? n_work : per_sm * sm_count());
  flash_fwd_kernel<D, NWG><<<grid, L::kThreads, L::kSmem, stream>>>(
      tq, tk, tv, static_cast<const bf16*>(nk), static_cast<const bf16*>(nv),
      static_cast<bf16*>(out), lse, B, Tq, Tk, N, scale * 1.4426950408889634f);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, const void* nk,
                        const void* nv, void* out, float* lse, int B, int Tq, int Tk, int N,
                        float scale, cudaStream_t stream) {
  if (fwd_wgs(B, Tq, N, sm_count()) == 2)
    return launch_bf16<D, 2>(q, k, v, nk, nv, out, lse, B, Tq, Tk, N, scale, stream);
  return launch_bf16<D, 1>(q, k, v, nk, nv, out, lse, B, Tq, Tk, N, scale, stream);
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* out, float* lse, int B,
                       int Tq, int Tk, int N, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_f32<D>();
  static std::atomic<unsigned long long> attr_done{0};
  cudaError_t err = smem_limit_once(flash_fwd_f32_kernel<D>, (int)smem, attr_done);
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
  if (D != 64 || T <= 0 || null_k == nullptr || null_v == nullptr)
    return (int)cudaErrorInvalidValue;
  return (int)launch_bf16<64>(q, k, v, null_k, null_v, out, lse, B, T, T, N, scale,
                              static_cast<cudaStream_t>(stream));
}

// K4: attention without a null token; q (B, Tq, N, D), k, v (B, Tk, N, D),
// D in {64, 128}, bf16 (fp32 == 0) or fp32 (fp32 == 1); lse (B, N, Tq) or null.
extern "C" int vfm_flash_attention(const void* q, const void* k, const void* v, void* out,
                                   float* lse, int B, int Tq, int Tk, int N, int D, float scale,
                                   int fp32, void* stream) {
  if (Tk <= 0 || Tq <= 0) return (int)cudaErrorInvalidValue;
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

// The bf16 forward's launch plan for (B, Tq, N, D) on a card with `sms` SMs:
// plan[0] consumer warpgroups, [1] queries per CTA, [2] keys per tile,
// [3] ring stages, [4] threads per CTA, [5] dynamic shared memory in bytes.
extern "C" int vfm_flash_fwd_plan(int B, int Tq, int N, int D, int sms, int* plan) {
  if (D != 64 && D != 128) return (int)cudaErrorInvalidValue;
  const int wgs = fwd_wgs(B, Tq, N, sms);
  auto fill = [&](auto layout) {
    using L = decltype(layout);
    const int vals[6] = {wgs, L::kRowsRes, L::kKT, L::kStages, L::kThreads, L::kSmem};
    for (int i = 0; i < 6; ++i) plan[i] = vals[i];
  };
  if (D == 64)
    wgs == 2 ? fill(FwdLayout<64, 2>{}) : fill(FwdLayout<64, 1>{});
  else
    wgs == 2 ? fill(FwdLayout<128, 2>{}) : fill(FwdLayout<128, 1>{});
  return 0;
}

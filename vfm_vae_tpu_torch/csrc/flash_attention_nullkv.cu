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
// fp32 design (K4 at the adapter, which computes in fp32 in both packages;
// flash_fwd_f32_kernel<D, NWG>): every product on the tensor cores as 3xTF32
// (tf32x3.cuh: hi = tf32(x), lo = x - hi, a b = a_lo b_hi + a_hi b_lo +
// a_hi b_hi), fp32's accuracy, not TF32's. The card's bound is then the
// tensor cores at a third of the TF32 rate, 165 TFLOP/s of fp32 work, 2.5x
// the CUDA cores' FMA.
// - A CTA holds NWG consumer warpgroups of 64 queries each (two at d = 64
//   when B N ceil(Tq / 128) CTAs give every SM one, else one) and a producer
//   warpgroup. One lane of the producer TMA-loads the CTA's Q block once and
//   64-key (d = 64) or 32-key (d = 128) K and V tiles into a ring of two
//   stages: fp32 boxes of 32 columns in the 128-byte swizzle, zero-filled
//   past Tq and Tk.
// - The producer's other three warps split each landed tile once for the CTA
//   (every consumer reads all of it): Q and K in place into hi planes with
//   lo planes beside them (elementwise: the swizzled layout is kept, the
//   K-major operand layout of tf32 wgmma), V into the hi and lo planes of its
//   transpose (d rows, keys contiguous: tf32 wgmma takes K-major operands
//   only), keys permuted within each block of 8.
// - S = Q K^T: wgmma m64n64k8 (m64n32k8 at d = 128) SS from the Q and K
//   planes, three products per k step of 8, in chains of two k steps (six
//   products) into fresh accumulators, folded into S in order by fp32 adds
//   (two accumulators in flight, so the tensor cores run while a chain is
//   added): the tensor cores' accumulation rounds towards zero, and over a
//   whole tile it measured 3x the twin's error against fp64 in the CPU
//   emulation (tests/test_torch_tf32x3.py).
// - The online softmax runs in registers (rows across the four lanes of a
//   quad, ex2.approx). P stays fp32 (the twin rounds P to the input dtype),
//   is split in registers, and its C fragments serve as the A fragments of
//   O += P V (wgmma m64nDk8 RS) with k permuted within blocks of 8, which the
//   V planes' key order matches. O is rescaled, then each chain of 16 keys is
//   summed into a fresh accumulator and added to O.
// - Masking: keys past Tk (zero-filled) get -inf logits in the last tile;
//   query rows past Tq (zero-filled) are computed and not stored.
// No float atomics: every output is bit-identical from run to run.
// At the adapter's sites it reaches about half of its bound at B=32; the
// split (about 30% of the time) and the products' shared-memory operand
// reads are what remain (PERF.md, probes/flash_forward.py --fp32).
//
// Training mode: given an `lse` pointer, the kernel (bf16 or fp32) also
// writes each query row's log-sum-exp over the walk (natural-log units,
// fp32, the null token included), the residual that the backward kernels
// (flash_attention_nullkv_bwd.cu) recompute P from.
//
// Layouts: q, out (B, Tq, N, D); k, v (B, Tk, N, D); null_k, null_v
// (B, 1, N, D) or null; bf16 or (K4) fp32; lse (B, N, Tq) fp32 or null.
#include "flash.cuh"
#include "tf32x3.cuh"

namespace {

using vfm::bf16;

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

// Shared-memory layout of flash_fwd_f32_kernel<D, NWG>, bytes from a
// 1024-aligned base: Q's hi plane (where its TMA boxes land raw) and lo
// plane, then two stages of [K (raw, split in place into hi), K lo, V raw,
// V^T hi, V^T lo], then the barriers. Every plane is 32-column boxes in the
// 128-byte swizzle: Q (64 NWG rows), K (kKT rows), V^T (D rows, kKT keys).
template <int D, int NWG>
struct F32Layout {
  static constexpr int kKT = 4096 / D;           // keys per tile: 64 at d = 64, 32 at d = 128
  static constexpr int kRows = 64 * NWG;         // queries per CTA
  static constexpr int kQPlane = kRows * D * 4;  // one plane of Q
  static constexpr int kQBox = kRows * 128;      // one 32-column box of a Q plane
  static constexpr int kTile = kKT * D * 4;      // one plane of K, V or V^T
  static constexpr int kKBox = kKT * 128;        // one 32-column box of K or V
  static constexpr int kVtBox = D * 128;         // one 32-key box of V^T
  static constexpr int kStages = 2;
  static constexpr int kStage = 5 * kTile;
  static constexpr int kRing = 2 * kQPlane;
  static constexpr int kBar = kRing + kStages * kStage;  // q_full, q_ready, full, ready, empty
  static constexpr int kSmem = kBar + 8 * (2 + 3 * kStages) + 1024;  // + alignment slack
  static constexpr int kThreads = 128 * (NWG + 1);
  static constexpr int kSplitters = 96;  // warps 1-3 of the producer warpgroup
  // Two consumer warpgroups need ~200 registers a thread, above the 168 of
  // entry: the producer warpgroup keeps 40 and gives the rest away.
  static constexpr bool kMoveRegisters = NWG > 1;
};

// acc += x in fp32 (round to nearest), once the wgmma group that wrote x
// has completed: one chain of products folded into its running sum.
template <int R>
__device__ __forceinline__ void fold(float (&acc)[R], float (&x)[R]) {
  fence_all(x);
  fence_all(acc);
#pragma unroll
  for (int i = 0; i < R; ++i) acc[i] += x[i];
}

// One chain of S = Q K^T, k steps 2c and 2c + 1 of d: six products
// (a_lo b_hi, a_hi b_lo, a_hi b_hi per step) into acc, started fresh, and
// committed as one wgmma group. Q's and K's hi and lo planes at qh, ql (this
// warpgroup's rows), kh, kl.
template <typename L>
__device__ __forceinline__ void s_chain(float (&acc)[L::kKT / 2], int c, uint32_t qh, uint32_t ql,
                                        uint32_t kh, uint32_t kl) {
  vfm::wgmma_fence();
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int kk = 2 * c + hh;
    const uint32_t qo = (kk >> 2) * L::kQBox + (kk & 3) * 32;
    const uint32_t ko = (kk >> 2) * L::kKBox + (kk & 3) * 32;
    const uint64_t dqh = vfm::sw128_desc(qh + qo, 16, 1024);
    const uint64_t dql = vfm::sw128_desc(ql + qo, 16, 1024);
    const uint64_t dkh = vfm::sw128_desc(kh + ko, 16, 1024);
    const uint64_t dkl = vfm::sw128_desc(kl + ko, 16, 1024);
    vfm::wgmma_tf32_ss<L::kKT>(acc, dql, dkh, hh);
    vfm::wgmma_tf32_ss<L::kKT>(acc, dqh, dkl, 1);
    vfm::wgmma_tf32_ss<L::kKT>(acc, dqh, dkh, 1);
  }
  vfm::wgmma_commit();
}

// One chain of O += P V, k steps 2c and 2c + 1 of the tile's keys: six
// products into acc, started fresh, committed as one group. P's hi and lo A
// fragments, V^T's hi and lo planes at vh, vl.
template <int D, typename L>
__device__ __forceinline__ void pv_chain(float (&acc)[D / 2], int c,
                                         const uint32_t (&ph)[L::kKT / 8][4],
                                         const uint32_t (&pl)[L::kKT / 8][4], uint32_t vh,
                                         uint32_t vl) {
  vfm::wgmma_fence();
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int kk = 2 * c + hh;
    const uint32_t vo = (kk >> 2) * L::kVtBox + (kk & 3) * 32;
    const uint64_t dvh = vfm::sw128_desc(vh + vo, 16, 1024);
    const uint64_t dvl = vfm::sw128_desc(vl + vo, 16, 1024);
    vfm::wgmma_tf32_rs<D>(acc, pl[kk], dvh, hh);
    vfm::wgmma_tf32_rs<D>(acc, ph[kk], dvl, 1);
    vfm::wgmma_tf32_rs<D>(acc, ph[kk], dvh, 1);
  }
  vfm::wgmma_commit();
}

// One consumer warpgroup `wg` of flash_fwd_f32_kernel: its 64 query rows
// against every K/V tile, then the output rows and their log-sum-exp. This
// thread holds rows r0 and r0 + 8 of the CTA's block, columns 8 c + 2 t and
// 8 c + 2 t + 1 of every 8-column chunk c (the wgmma accumulator layout).
template <int D, int NWG>
__device__ __forceinline__ void consume_f32(uint32_t base, uint32_t bar, float* __restrict__ out,
                                            float* __restrict__ lse, int wg, int q0, int h, int b,
                                            int Tq, int Tk, int N, float scale_log2) {
  using L = F32Layout<D, NWG>;
  constexpr int KT = L::kKT;
  const int lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  const int r0 = wg * 64 + (threadIdx.x / 32 % 4) * 16 + g;
  const int n_tiles = (Tk + KT - 1) / KT;
  const uint32_t qh = base + wg * 64 * 128, ql = qh + L::kQPlane;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  vfm::mbar_wait(bar + 8u, 0);  // q_ready
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j & 1;
    const uint32_t st = base + L::kRing + s * L::kStage;
    const uint32_t kh = st, kl = st + L::kTile, vh = st + 3 * L::kTile, vl = st + 4 * L::kTile;
    vfm::mbar_wait(bar + 8u * (2 + L::kStages + s), (j >> 1) & 1);  // ready(s)

    // S = Q K^T over d: D / 16 chains of two k steps, chain 0 into S, chain
    // c > 0 into zs[(c - 1) % 2], added to S in order (two in flight).
    constexpr int NC = D / 16;
    float sc[KT / 2], zs[2][KT / 2];
    s_chain<L>(sc, 0, qh, ql, kh, kl);
#pragma unroll
    for (int c = 1; c < NC; ++c) {
      if (c >= 3) {
        vfm::wgmma_wait<1>();
        fold(sc, zs[(c - 1) & 1]);  // chain c - 2
      }
      s_chain<L>(zs[(c - 1) & 1], c, qh, ql, kh, kl);
    }
    vfm::wgmma_wait<1>();
    fold(sc, zs[(NC - 3) & 1]);  // chain NC - 2
    vfm::wgmma_wait<0>();
    fold(sc, zs[(NC - 2) & 1]);  // chain NC - 1

    float alpha[2];
    online_softmax<KT>(sc, m, l, alpha, j * KT, Tk, t, scale_log2);
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      o[4 * c] *= alpha[0];
      o[4 * c + 1] *= alpha[0];
      o[4 * c + 2] *= alpha[1];
      o[4 * c + 3] *= alpha[1];
    }
    // P's C fragments as A fragments: k index t <- column 2t, t + 4 <- 2t + 1.
    uint32_t ph[KT / 8][4], pl[KT / 8][4];
#pragma unroll
    for (int kk = 0; kk < KT / 8; ++kk) {
      vfm::split_tf32(sc[4 * kk], ph[kk][0], pl[kk][0]);
      vfm::split_tf32(sc[4 * kk + 2], ph[kk][1], pl[kk][1]);
      vfm::split_tf32(sc[4 * kk + 1], ph[kk][2], pl[kk][2]);
      vfm::split_tf32(sc[4 * kk + 3], ph[kk][3], pl[kk][3]);
    }

    // O += P V over the tile's keys: KT / 16 chains of two k steps, each into
    // a fresh accumulator added to O in order (one in flight: two measured
    // no faster, and at d = 128 O, P and one chain fill the registers).
    float zo[D / 2];
#pragma unroll
    for (int c = 0; c < KT / 16; ++c) {
      pv_chain<D, L>(zo, c, ph, pl, vh, vl);
      vfm::wgmma_wait<0>();
      fold(o, zo);
    }
    fence_all(ph);
    fence_all(pl);
    vfm::mbar_arrive(bar + 8u * (2 + 2 * L::kStages + s));  // empty(s)
  }

  const size_t rs = (size_t)N * D;
  const size_t qhead = (size_t)b * Tq * rs + (size_t)h * D;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int tok = q0 + r0 + 8 * hf;
    if (tok >= Tq) continue;
    const float inv = 1.f / l[hf];
#pragma unroll
    for (int c = 0; c < D / 8; ++c)
      *reinterpret_cast<float2*>(out + qhead + (size_t)tok * rs + 8 * c + 2 * t) =
          make_float2(o[4 * c + 2 * hf] * inv, o[4 * c + 2 * hf + 1] * inv);
    if (lse != nullptr && t == 0)
      lse[((size_t)b * N + h) * Tq + tok] = (m[hf] + log2f(l[hf])) * 0.6931471805599453f;
  }
}

// One CTA per (block of 64 NWG queries, head, sample); see the fp32 design
// above. Barriers: q_full (Q landed), q_ready (Q split), and per stage full
// (K and V landed), ready (split) and empty (every consumer done with it).
template <int D, int NWG>
__global__ void __launch_bounds__((NWG + 1) * 128, 1) flash_fwd_f32_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, float* __restrict__ out, float* __restrict__ lse,
    int Tq, int Tk, int N, float scale_log2) {
  using L = F32Layout<D, NWG>;
  constexpr int S = L::kStages;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = vfm::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);  // generic pointer to `base`
  const uint32_t bar = base + L::kBar;
  auto full = [&](int s) { return bar + 8u * (2 + s); };
  auto ready = [&](int s) { return bar + 8u * (2 + S + s); };
  auto empty = [&](int s) { return bar + 8u * (2 + 2 * S + s); };
  const int q0 = blockIdx.x * L::kRows, h = blockIdx.y, b = blockIdx.z;
  const int n_tiles = (Tk + L::kKT - 1) / L::kKT;
  if (threadIdx.x == 0) {
    vfm::mbar_init(bar, 1);
    vfm::mbar_init(bar + 8u, L::kSplitters);
    for (int s = 0; s < S; ++s) {
      vfm::mbar_init(full(s), 1);
      vfm::mbar_init(ready(s), L::kSplitters);
      vfm::mbar_init(empty(s), NWG * 128);
    }
    vfm::mbar_fence_init();
  }
  __syncthreads();

  // Warpgroup 0 produces: lane 0 issues every TMA load, warps 1-3 split. The
  // roles are read through shuffles so that the compiler sees them uniform
  // per warp.
  const int role = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (role == 0) {
    if constexpr (L::kMoveRegisters) vfm::reg_dealloc<40>();
    const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0);
    if (warp == 0) {
      if (threadIdx.x == 0) {
        vfm::mbar_expect_tx(bar, L::kQPlane);
        for (int x = 0; x < D / 32; ++x)
          vfm::tma_load_4d(base + x * L::kQBox, &tq, bar, 32 * x, h, q0, b);
        for (int j = 0; j < n_tiles; ++j) {
          const int s = j % S;
          const uint32_t st = base + L::kRing + s * L::kStage;
          if (j >= S) vfm::mbar_wait(empty(s), ((j / S) - 1) & 1);
          vfm::mbar_expect_tx(full(s), 2 * L::kTile);
          for (int x = 0; x < D / 32; ++x)
            vfm::tma_load_4d(st + x * L::kKBox, &tk, full(s), 32 * x, h, j * L::kKT, b);
          for (int x = 0; x < D / 32; ++x)
            vfm::tma_load_4d(st + 2 * L::kTile + x * L::kKBox, &tv, full(s), 32 * x, h,
                             j * L::kKT, b);
        }
      }
    } else {
      const int tid = threadIdx.x - 32;
      vfm::mbar_wait(bar, 0);
      vfm::split_plane(smem, smem + L::kQPlane, L::kQPlane, tid, L::kSplitters);
      vfm::fence_proxy_async();  // the planes are read by wgmma (the async proxy)
      vfm::mbar_arrive(bar + 8u);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % S;
        unsigned char* st = smem + L::kRing + s * L::kStage;
        vfm::mbar_wait(full(s), (j / S) & 1);
        vfm::split_plane(st, st + L::kTile, L::kTile, tid, L::kSplitters);
        vfm::split_transpose<D, L::kKT>(st + 2 * L::kTile, st + 3 * L::kTile, st + 4 * L::kTile,
                                        tid, L::kSplitters);
        vfm::fence_proxy_async();
        vfm::mbar_arrive(ready(s));
      }
    }
  } else {
    if constexpr (L::kMoveRegisters) vfm::reg_alloc<232>();
    consume_f32<D, NWG>(base, bar, out, lse, role - 1, q0, h, b, Tq, Tk, N, scale_log2);
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

// Consumer warpgroups per CTA of the fp32 forward for (B, Tq, N, D) on `sms`
// SMs: two (128 queries) at d = 64 when B N ceil(Tq / 128) CTAs give every
// SM one, else one (64 queries); one at d = 128 (two would not fit in shared
// memory).
int f32_wgs(int B, int Tq, int N, int D, int sms) {
  return D == 64 && (long long)B * N * ((Tq + 127) / 128) >= sms ? 2 : 1;
}

template <int D, int NWG>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* out, float* lse, int B,
                       int Tq, int Tk, int N, float scale, cudaStream_t stream) {
  using L = F32Layout<D, NWG>;
  static std::atomic<unsigned long long> attr_done{0};
  cudaError_t err = smem_limit_once(flash_fwd_f32_kernel<D, NWG>, L::kSmem, attr_done);
  if (err != cudaSuccess) return err;
  CUtensorMap tq, tk, tv;
  if ((err = tensor_map(&tq, q, B, Tq, N, D, L::kRows, 4)) != cudaSuccess) return err;
  if ((err = tensor_map(&tk, k, B, Tk, N, D, L::kKT, 4)) != cudaSuccess) return err;
  if ((err = tensor_map(&tv, v, B, Tk, N, D, L::kKT, 4)) != cudaSuccess) return err;
  dim3 grid((Tq + L::kRows - 1) / L::kRows, N, B);
  flash_fwd_f32_kernel<D, NWG><<<grid, L::kThreads, L::kSmem, stream>>>(
      tq, tk, tv, static_cast<float*>(out), lse, Tq, Tk, N, scale * 1.4426950408889634f);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* out, float* lse, int B,
                       int Tq, int Tk, int N, float scale, cudaStream_t stream) {
  if constexpr (D == 64)
    if (f32_wgs(B, Tq, N, D, sm_count()) == 2)
      return launch_f32<D, 2>(q, k, v, out, lse, B, Tq, Tk, N, scale, stream);
  return launch_f32<D, 1>(q, k, v, out, lse, B, Tq, Tk, N, scale, stream);
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

// The fp32 forward's launch plan for (B, Tq, N, D) on a card with `sms` SMs:
// plan[0] consumer warpgroups, [1] queries per CTA, [2] keys per tile,
// [3] ring stages, [4] threads per CTA, [5] dynamic shared memory in bytes,
// [6] CTAs.
extern "C" int vfm_flash_fwd_f32_plan(int B, int Tq, int N, int D, int sms, int* plan) {
  if ((D != 64 && D != 128) || Tq <= 0) return (int)cudaErrorInvalidValue;
  const int wgs = f32_wgs(B, Tq, N, D, sms);
  auto fill = [&](auto layout) {
    using L = decltype(layout);
    const int vals[7] = {wgs, L::kRows, L::kKT, L::kStages, L::kThreads, L::kSmem,
                         (Tq + L::kRows - 1) / L::kRows * N * B};
    for (int i = 0; i < 7; ++i) plan[i] = vals[i];
  };
  if (D == 64)
    wgs == 2 ? fill(F32Layout<64, 2>{}) : fill(F32Layout<64, 1>{});
  else
    fill(F32Layout<128, 1>{});
  return 0;
}

// K1: fused ConvNeXt MLP for Hopper, and K9, its pipelined issue order.
//
// K1 replaces vfm_vae_tpu/ops/pallas/fused_mlp.py:_fused (Pallas body
// _kernel), K9 :_fused_pipelined (body _kernel_pipelined):
//   out = x_in + gamma * ((GELU(bf16(x * A_b) @ W1^T * d_b + b1_b) -> bf16) @ W2^T + b2)
// with fp32 accumulation and a GELU within 3.4e-6 of exact (the TPU kernel's
// own tanh-form evaluation, refit). Rounding points match the
// plain twin: x*A is rounded to bf16 before GEMM1 and the GELU output is
// rounded to bf16 before GEMM2.
//
// Bound on the H100: two chained GEMMs of 2 T C 4C flops each against one
// read of x and x_in and one write of out, ~2C flops per byte of activations
// once the (T, 4C) hidden stays on chip: the tensor cores bound it, and the
// T 4C GELU evaluations on the CUDA cores come close at C = 128 (15 SASS
// instructions each over 132 x 128 lanes; 33 with erff). Two faults of the
// first design (one CTA per 32 tokens walking the whole hidden with
// mma.sync): small sites ran on 4 to 64 of 132 SMs, and large sites re-read
// W1 and W2 from L2 every 32 tokens with no copy/compute overlap. What
// bounds this design (probes/fused_mlp.py): each tile's serial walk and its
// fixed cost (x's load and scaling, the epilogue: 12-42% of a CTA's time);
// TMA multicast of the weights to pairs of tiles and a persistent grid
// measured no faster and are not kept (PERF.md).
//
// Design:
// - A CTA is a producer warp (warpgroup 0, one lane) and two consumer
//   warpgroups. Token tiles are 64 rows (one wgmma M) of one sample: x is a
//   (B, HW, 1, C) tensor map, so TMA zero-fills past a sample's last token
//   and never reads into the next; the epilogue skips tokens past HW.
//   C <= 256: the two consumer warpgroups take two token tiles of a sample
//   (128 rows a CTA, both reading every weight tile the producer brings).
//   C = 512: both take the same 64 tokens, since a 64 x 512 fp32 output
//   accumulator would need 256 registers a thread; warpgroup w computes
//   hidden columns [32 w, 32 w + 32) of each chunk and output columns
//   [256 w, 256 w + 256).
// - The x tile arrives once by TMA, stays resident for the whole walk and is
//   scaled by A in place (bf16, in the 128-byte swizzle), then fenced for the
//   async proxy; GEMM1 reads it as wgmma's A from shared memory (SS).
// - The 4C hidden is walked in chunks of 64 columns. The weights stream
//   through a ring of 64 x 64 bf16 sub-tiles (8 KB, 128-byte swizzle, as
//   deep as shared memory allows: 18-24 stages): per chunk C/64 sub-tiles of
//   W1 (4C, C) and C/64 of W2 (C, 4C), both K-major as stored. GEMM1 is
//   m64n64k16 (m64n32k16 at C = 512) SS into a fresh accumulator.
// - The hidden never leaves the SM: GEMM1's accumulator gets d, b1 and the
//   GELU in registers and is rounded to bf16. At C <= 256 it feeds GEMM2 as
//   wgmma's register A operand (RS, B K-major: the transpose bit off), at
//   C = 512 it passes through a double-buffered 64 x 64 shared tile (SS) so
//   that both warpgroups read all 64 columns. GEMM2 accumulates 64 x 64
//   blocks (m64n64k16) in registers across the walk.
// - Registers (setmaxnreg: producer 24, consumers 240; 128 x 24 + 256 x 240
//   fits the 384 x 168 of the launch): the output accumulator takes C / 2
//   a thread at C <= 256 (64, 128) and 128 at C = 512, GEMM1's 32 (16 at
//   C = 512), the bf16 hidden 16.
// - Small sites split the hidden across a cluster of s CTAs (s a power of
//   two <= 8, chosen so that tiles x s approaches one wave; 1 when the tiles
//   fill the card). Rank r walks chunks [r n / s, (r + 1) n / s). Every CTA
//   writes its fp32 partial of the output into its own shared memory; after
//   a cluster barrier rank r sums column band r of all s partials in rank
//   order through distributed shared memory, adds b2, gamma and x_in, and
//   stores its band (coalesced). No float atomics: runs are bit-identical.
//   With s = 1 the same epilogue reads the CTA's own partial.
//
// K9 differs from K1 only in issue order (FA3's intra-warpgroup overlap, as
// the flash forward overlaps a tile's softmax with the previous PV): chunk
// j's GEMM1 and chunk j-1's GEMM2 are committed together, wgmma_wait<1>
// retires the GEMM1, chunk j's GELU runs while the GEMM2 is in flight, and
// the producer brings W1 of chunk j before W2 of chunk j-1. (Committing
// chunk j+1's GEMM1 before chunk j's GELU, into a second accumulator, made
// ptxas serialize every wgmma, C7514/C7515, and ran 1.05-1.6x slower than
// K1.) The plan, the split and the wgmma sequence into every accumulator
// are K1's, so K9 is bit-exact with K1. In K1 the two consumer warpgroups
// overlap each other's GELU.
//
// Layouts: x, x_in, out (B, HW, C) bf16; A (B, C), d and b1 (B, 4C) fp32;
// W1 (4C, C) and W2 (C, 4C) bf16 in torch Linear layout (out, in); b2 and
// gamma (C,) fp32. Every pointer 16-byte aligned.
#include "flash.cuh"

namespace {

using vfm::bf16;
using vfm::fence_all;

constexpr int kSub = 64 * 128;     // one 64 x 64 bf16 sub-tile (bytes)
constexpr int kThreads = 384;      // producer warpgroup + two consumer warpgroups
constexpr int kConsumerWarps = 8;
constexpr int kSmemMax = 232448;
constexpr int kSlack = 1024;       // 1024-byte alignment of the swizzled tiles
constexpr int kMaxSplit = 8;       // portable cluster size
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
// GELU form: true = the tanh form of the TPU kernel's GELU
// (vfm_vae_tpu/ops/pallas/fused_mlp.py:_gelu_poly) with refit coefficients,
// within 3.4e-6 of the exact GELU in fp32 (tests/test_torch_mlp_plan.py;
// the TPU's coefficients: 7.0e-6), 15 SASS instructions; false = erff,
// 33 instructions, 8% slower over a decode (probes/fused_mlp.py).
constexpr bool kPolyGelu = true;
// Where the bf16 hidden goes between the products at C <= 256: false = in
// registers as GEMM2's A operand (RS), true = through shared memory (SS), as
// at C = 512 (probes/fused_mlp.py compares the two).
constexpr bool kHiddenInSmem = false;

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// Bytes of the hidden chunk buffers: two 64 x 64 bf16 tiles, shared by the
// two warpgroups at C = 512, one pair a warpgroup where the hidden goes
// through shared memory at C <= 256.
__host__ __device__ constexpr int hidden_bytes(int C) {
  return C == 512 ? 2 * kSub : (kHiddenInSmem ? 4 * kSub : 0);
}

__device__ __forceinline__ float gelu_erf(float v) {
  return 0.5f * v * (1.0f + erff(v * 0.70710678118654752f));
}

// GELU(h) = h (1 + tanh(u)) / 2 = h / (1 + 2^(-2 u log2 e)) with
// u = hc p(hc^2), hc = clip(h, -6, 6), p a degree-4 polynomial fitted to
// atanh(erf(h / sqrt 2)) / h (weighted by GELU's sensitivity to u).
// Coefficients: fused_mlp.GELU_POLY, highest degree first.
__device__ __forceinline__ float gelu_poly(float h) {
  const float hc = fminf(fmaxf(h, -6.f), 6.f), s = hc * hc;
  float p = 1.1126417260746574e-06f;
  p = fmaf(p, s, -3.046736235069902e-05f);
  p = fmaf(p, s, -1.2547544078316894e-04f);
  p = fmaf(p, s, 0.036469929776638176f);
  p = fmaf(p, s, 0.7978275766980556f);
  return __fdividef(h, 1.f + vfm::ex2(hc * p * -2.8853900817779268f));
}

// The elementwise steps K1 and K9 share, written once so that both kernels
// compile them to the same instructions (K9 is bit-exact with K1).
// Hidden activation: GELU(acc * d + b1) with one explicit FMA.
__device__ __forceinline__ float hidden_act(float acc, float d, float b1) {
  const float v = __fmaf_rn(acc, d, b1);
  return kPolyGelu ? gelu_poly(v) : gelu_erf(v);
}

// Output: (acc + b2) * gamma + x_in with one explicit FMA.
__device__ __forceinline__ float out_val(float acc, float b2, float gamma, float xin) {
  return __fmaf_rn(__fadd_rn(acc, b2), gamma, xin);
}

template <int C>
struct Cfg {
  static constexpr int kKB = C / 64;               // sub-tiles a weight a chunk; x boxes a tile
  static constexpr bool kSplitCols = C == 512;     // warpgroups split the output columns
  static constexpr int kRows = kSplitCols ? 64 : 128;  // tokens a CTA
  static constexpr int kX = kRows / 64 * kKB * kSub;   // resident x
  static constexpr bool kHidSmem = kSplitCols || kHiddenInSmem;  // GEMM2 SS, else RS
  static constexpr int kH = hidden_bytes(C);
  static constexpr int kN1 = kSplitCols ? 32 : 64;     // GEMM1 columns a warpgroup a chunk
  static constexpr int kNB2 = kSplitCols ? kKB / 2 : kKB;  // 64-column output blocks a warpgroup
  static constexpr int kPartLd = C + 8;            // floats a row of the fp32 partial
};

// The launch plan (vfm_fused_mlp_plan exports it; ops/kernels/fused_mlp.py
// mirrors it). K1 and K9 share it.
struct Plan {
  int rows, tiles, split, chunks, ctas, stages, smem;
};

Plan make_plan(int B, int HW, int C, int sms) {
  Plan p;
  p.rows = C == 512 ? 64 : 128;
  p.tiles = B * cdiv(HW, p.rows);
  const int nch = C / 16;  // 4C / 64
  p.split = 1;
  while (p.split * 2 <= kMaxSplit && p.split * 2 <= nch && 2LL * p.tiles * p.split <= sms)
    p.split *= 2;
  p.chunks = nch / p.split;
  p.ctas = p.tiles * p.split;
  const int fixed = p.rows / 64 * (C / 64) * kSub + hidden_bytes(C) + kSlack + 8;
  p.stages = (kSmemMax - fixed) / (kSub + 16);
  p.smem = fixed + p.stages * (kSub + 16);
  return p;
}

// bf16(x * A_b) in place over 64 rows x C of the resident x at `xs`
// (generic pointer; C / 64 boxes of 64 rows x 128 bytes, 128-byte swizzle),
// by `nt` threads; nt is a multiple of C / 8, so each thread keeps one
// 16-byte column chunk and its eight A values.
template <int C>
__device__ __forceinline__ void scale_x(unsigned char* xs, const float* __restrict__ A, int b,
                                        int tid, int nt) {
  constexpr int kChunks = C / 8;  // 16-byte chunks a row
  const int c8 = tid % kChunks, box = c8 / 8, cb = c8 % 8;
  const float4 a0 = *reinterpret_cast<const float4*>(A + b * C + 8 * c8);
  const float4 a1 = *reinterpret_cast<const float4*>(A + b * C + 8 * c8 + 4);
  const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
  for (int r = tid / kChunks; r < 64; r += nt / kChunks) {
    uint4* p = reinterpret_cast<uint4*>(xs + box * kSub + r * 128 + ((cb ^ (r & 7)) << 4));
    uint4 v = *p;
    uint32_t* e = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = vfm::unpack_bf16(e[i]);
      e[i] = vfm::pack_bf16(__fmul_rn(f.x, av[2 * i]), __fmul_rn(f.y, av[2 * i + 1]));
    }
    *p = v;
  }
}

// Kernel arguments that are not tensor maps.
struct Args {
  const bf16* xin;
  const float *A, *d, *b1, *b2, *gamma;
  bf16* out;
  int HW, tiles_per_sample, split, chunks, stages;
};

template <int C, bool kPipe>
__global__ void __launch_bounds__(kThreads, 1) fused_mlp_kernel(
    const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw1,
    const __grid_constant__ CUtensorMap tw2, const __grid_constant__ CUtensorMap txin,
    const Args args) {
  using K = Cfg<C>;
  constexpr int KB = K::kKB;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = vfm::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);  // generic pointer to `base`
  const uint32_t xs = base, hs = base + K::kX, ring = hs + K::kH;
  const int stages = args.stages;
  const uint32_t bars = ring + stages * kSub;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (stages + s); };
  const uint32_t xbar = bars + 16u * stages;

  // The cluster is the split's ranks of one tile (the CTA alone when unsplit).
  const int split = args.split, rank = blockIdx.x % split, tile = blockIdx.x / split;
  const int b = tile / args.tiles_per_sample;
  const int tok0 = (tile % args.tiles_per_sample) * K::kRows;
  const int j0 = rank * args.chunks, j1 = j0 + args.chunks;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      vfm::mbar_init(full(s), 1);
      vfm::mbar_init(empty(s), kConsumerWarps);  // one arrival per consumer warp
    }
    vfm::mbar_init(xbar, 1);
    vfm::mbar_fence_init();
  }
  __syncthreads();

  // Warpgroup 0 produces (one lane issues every TMA load), 1 and 2 consume.
  // The role is read through a shuffle so that the compiler sees it is
  // uniform per warp; the two paths never rejoin, and each passes the two
  // cluster barriers of the epilogue itself.
  const int role = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (role == 0) {
    vfm::reg_dealloc<kProducerRegs>();
    if (threadIdx.x == 0) {
      vfm::mbar_expect_tx(xbar, K::kX);
      for (int w = 0; w < K::kRows / 64; ++w)
        for (int kb = 0; kb < KB; ++kb) {
          vfm::tma_load_4d(xs + (w * KB + kb) * kSub, &tx, xbar, 64 * kb, 0, tok0 + 64 * w, b);
          // x_in's rows of the tile into L2 for the epilogue (by rank 0 for
          // every rank's band: the CTAs of a cluster share L2).
          if (rank == 0) vfm::tma_prefetch_4d(&txin, 64 * kb, 0, tok0 + 64 * w, b);
        }
      int gi = 0;
      auto load = [&](const CUtensorMap* map, int c0, int c2) {
        const int s = gi % stages;
        if (gi >= stages) vfm::mbar_wait(empty(s), ((gi / stages) & 1) ^ 1);
        vfm::mbar_expect_tx(full(s), kSub);
        vfm::tma_load_4d(ring + s * kSub, map, full(s), c0, 0, c2, 0);
        ++gi;
      };
      // W1 rows [64 j, 64 j + 64) x columns [64 kb, ...); W2 rows [64 nb, ...)
      // x columns [64 j, 64 j + 64).
      auto w1 = [&](int j) {
        for (int kb = 0; kb < KB; ++kb) load(&tw1, 64 * kb, 64 * j);
      };
      auto w2 = [&](int j) {
        for (int nb = 0; nb < KB; ++nb) load(&tw2, 64 * j, 64 * nb);
      };
      if constexpr (kPipe) {
        w1(j0);
        for (int j = j0; j < j1; ++j) {
          if (j + 1 < j1) w1(j + 1);
          w2(j);
        }
      } else {
        for (int j = j0; j < j1; ++j) {
          w1(j);
          w2(j);
        }
      }
    }
    vfm::cluster_sync();  // the partials are written
    vfm::cluster_sync();  // the cluster has read them
    return;
  }

  vfm::reg_alloc<kConsumerRegs>();
  const int wg = role - 1;
  const int tid = threadIdx.x - 128 * role, ctid = threadIdx.x - 128;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int r0 = 16 * warp + g;  // this thread's accumulator rows r0, r0 + 8 of its 64
  const int H4 = 4 * C;

  // The resident x: this warpgroup's tile (C <= 256) or the shared one.
  vfm::mbar_wait(xbar, 0);
  if constexpr (K::kSplitCols) {
    scale_x<C>(smem, args.A, b, ctid, 256);
    vfm::fence_proxy_async();
    vfm::named_sync<2, 256>();
  } else {
    scale_x<C>(smem + wg * KB * kSub, args.A, b, tid, 128);
    vfm::fence_proxy_async();
    wg == 0 ? vfm::named_sync<2, 128>() : vfm::named_sync<3, 128>();
  }
  const uint32_t xa = xs + (K::kSplitCols ? 0 : wg * KB * kSub);

  int gi = 0;  // sub-tiles of the ring consumed so far (the producer's order)
  auto take = [&]() {
    const int s = gi % stages;
    vfm::mbar_wait(full(s), (gi / stages) & 1);
    ++gi;
    return ring + s * kSub;
  };
  // Once the products that read them have completed: one arrival per warp
  // on each of the KB stages from sub-tile g0 on.
  auto release = [&](int g0) {
    if (lane == 0)
      for (int i = 0; i < KB; ++i) vfm::mbar_arrive(empty((g0 + i) % stages));
  };

  // GEMM1 of one chunk into a fresh accumulator: C / 16 steps of k16.
  auto issue1 = [&](float (&acc)[K::kN1 / 2]) {
    vfm::wgmma_fence();
#pragma unroll
    for (int kb = 0; kb < KB; ++kb) {
      const uint32_t w = take() + (K::kSplitCols ? wg * 32 * 128 : 0);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t da = vfm::sw128_desc(xa + kb * kSub + 32 * kk, 16, 1024);
        const uint64_t db = vfm::sw128_desc(w + 32 * kk, 16, 1024);
        if constexpr (K::kSplitCols)
          vfm::wgmma_ss_m64n32(acc, da, db, kb > 0 || kk > 0);
        else
          vfm::wgmma_ss_m64n64(acc, da, db, kb > 0 || kk > 0);
      }
    }
    vfm::wgmma_commit();
  };

  float acc2[K::kNB2][32];
#pragma unroll
  for (int n = 0; n < K::kNB2; ++n)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc2[n][i] = 0.f;
  uint32_t hid[4][4];  // the bf16 hidden chunk as GEMM2's A fragments (RS)

  // Hidden buffer of chunk j: j % 2 of the pair shared at C = 512, of this
  // warpgroup's pair otherwise.
  auto hbuf = [&](int j) { return (K::kSplitCols ? 0 : 2 * wg) + (j & 1); };

  // GEMM2 of chunk j: every W2 sub-tile of the chunk is taken; at C = 512
  // this warpgroup multiplies only its own output blocks.
  auto issue2 = [&](int j) {
    vfm::wgmma_fence();
#pragma unroll
    for (int nb = 0; nb < KB; ++nb) {
      const uint32_t w = take();
      if constexpr (K::kHidSmem) {
        if (!K::kSplitCols || nb / K::kNB2 == wg) {
          const uint32_t h = hs + hbuf(j) * kSub;
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            vfm::wgmma_ss_m64n64(acc2[nb % K::kNB2], vfm::sw128_desc(h + 32 * kk, 16, 1024),
                                 vfm::sw128_desc(w + 32 * kk, 16, 1024), 1);
        }
      } else {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          vfm::wgmma_rs_m64n64_kmajor(acc2[nb], hid[kk], vfm::sw128_desc(w + 32 * kk, 16, 1024));
      }
    }
    vfm::wgmma_commit();
  };

  // Demodulate, fold b1 and GELU chunk j's GEMM1 accumulator in place
  // (columns 8 jb + 2 t and + 1 of rows r0, r0 + 8 in acc[4 jb .. 4 jb + 3]).
  auto activate = [&](float (&acc)[K::kN1 / 2], int j) {
    const int h0 = 64 * j + (K::kSplitCols ? 32 * wg : 0);
    const float* dp = args.d + (size_t)b * H4 + h0 + 2 * t;
    const float* bp = args.b1 + (size_t)b * H4 + h0 + 2 * t;
#pragma unroll
    for (int jb = 0; jb < K::kN1 / 8; ++jb) {
      const float2 dd = *reinterpret_cast<const float2*>(dp + 8 * jb);
      const float2 bb = *reinterpret_cast<const float2*>(bp + 8 * jb);
      acc[4 * jb] = hidden_act(acc[4 * jb], dd.x, bb.x);
      acc[4 * jb + 1] = hidden_act(acc[4 * jb + 1], dd.y, bb.y);
      acc[4 * jb + 2] = hidden_act(acc[4 * jb + 2], dd.x, bb.x);
      acc[4 * jb + 3] = hidden_act(acc[4 * jb + 3], dd.y, bb.y);
    }
  };
  // Round chunk j's activated hidden to bf16: into the A fragments (RS), or
  // into its buffer in shared memory (SS; at C = 512 this warpgroup's 32
  // columns), fenced for the async proxy and shared by the barrier.
  auto store_hidden = [&](const float (&acc)[K::kN1 / 2], int j) {
    if constexpr (K::kHidSmem) {
      unsigned char* hb = smem + K::kX + hbuf(j) * kSub;
      constexpr int kChunk0 = K::kSplitCols ? 4 : 0;  // 16-byte chunk of column 32 wg
#pragma unroll
      for (int jb = 0; jb < K::kN1 / 8; ++jb)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int r = r0 + 8 * hf;
          *reinterpret_cast<uint32_t*>(hb + r * 128 + (((kChunk0 * wg + jb) ^ (r & 7)) << 4) +
                                       4 * t) =
              vfm::pack_bf16(acc[4 * jb + 2 * hf], acc[4 * jb + 2 * hf + 1]);
        }
      vfm::fence_proxy_async();
      if constexpr (K::kSplitCols)
        vfm::named_sync<1, 256>();
      else
        wg == 0 ? vfm::named_sync<5, 128>() : vfm::named_sync<6, 128>();
    } else {
      vfm::pack_a<64>(hid, acc);
    }
  };

  int g2 = -1;  // first sub-tile of the last GEMM2 issued, released once it completes
  if constexpr (kPipe) {
    // Chunk j's GEMM1 and chunk j-1's GEMM2 go out together; once GEMM1 is
    // done, chunk j's GELU runs in place while GEMM2 is still in flight (the
    // flash kernels' softmax-beside-PV order), then the hidden is stored for
    // the next pair. The ring order: W1(j0), then W1(j), W2(j - 1).
    float acc1[K::kN1 / 2];
    int g1 = gi;
    issue1(acc1);
    vfm::wgmma_wait<0>();
    fence_all(acc1);
    release(g1);
    activate(acc1, j0);
    store_hidden(acc1, j0);
    for (int j = j0 + 1; j < j1; ++j) {
      g1 = gi;
      issue1(acc1);
      g2 = gi;
      issue2(j - 1);
      vfm::wgmma_wait<1>();  // chunk j's GEMM1
      fence_all(acc1);
      release(g1);
      activate(acc1, j);
      vfm::wgmma_wait<0>();  // chunk j-1's GEMM2
      if constexpr (!K::kHidSmem) fence_all(hid);
      release(g2);
      store_hidden(acc1, j);
    }
    g2 = gi;
    issue2(j1 - 1);
  } else {
    float acc1[K::kN1 / 2];
    for (int j = j0; j < j1; ++j) {
      const int g1 = gi;
      issue1(acc1);
      vfm::wgmma_wait<0>();  // chunk j's GEMM1 and chunk j-1's GEMM2
      fence_all(acc1);
      if constexpr (!K::kHidSmem) fence_all(hid);
      if (j > j0) release(g2);
      release(g1);
      activate(acc1, j);
      store_hidden(acc1, j);
      g2 = gi;
      issue2(j);
    }
  }
  vfm::wgmma_wait<0>();
#pragma unroll
  for (int n = 0; n < K::kNB2; ++n) fence_all(acc2[n]);
  release(g2);

  // Epilogue. Both warpgroups are done with x, the hidden buffers and the
  // ring; the fp32 partial (kRows x C, rows kPartLd floats apart) takes
  // their place. Columns 8 jb + 2 t and + 1 of rows r0 and r0 + 8 of
  // block nb are acc2[nb][4 jb + 2 hf] and [4 jb + 2 hf + 1].
  vfm::named_sync<4, 256>();
  float* part = reinterpret_cast<float*>(smem);
  {
    const int row = K::kSplitCols ? r0 : 64 * wg + r0;
    const int col0 = K::kSplitCols ? 256 * wg : 0;
#pragma unroll
    for (int nb = 0; nb < K::kNB2; ++nb)
#pragma unroll
      for (int jb = 0; jb < 8; ++jb)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
          *reinterpret_cast<float2*>(part + (row + 8 * hf) * K::kPartLd + col0 + 64 * nb + 8 * jb +
                                     2 * t) =
              make_float2(acc2[nb][4 * jb + 2 * hf], acc2[nb][4 * jb + 2 * hf + 1]);
  }
  vfm::cluster_sync();

  // Rank r: column band [r C / s, (r + 1) C / s) of the tile, the s partials
  // summed in rank order, then (+ b2) * gamma + x_in, four columns a thread,
  // kBatch items a pass with every load of the pass issued before any store.
  constexpr int kBatch = 8;
  const int band = C / split, quads = band / 4, items = K::kRows * quads;
  for (int i0 = ctid; i0 < items; i0 += 256 * kBatch) {
    float4 y[kBatch];
    uint2 xi[kBatch];
    uint32_t off[kBatch];
    size_t o[kBatch];
    int col[kBatch];
    bool live[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + 256 * u, row = i / quads;
      col[u] = rank * band + 4 * (i % quads);
      live[u] = i < items && tok0 + row < args.HW;
      off[u] = base + (uint32_t)(row * K::kPartLd + col[u]) * 4u;
      o[u] = ((size_t)b * args.HW + tok0 + row) * C + col[u];
      if (live[u]) {
        y[u] = vfm::ld_cluster_f4(vfm::map_rank(off[u], 0));
        xi[u] = __ldg(reinterpret_cast<const uint2*>(args.xin + o[u]));
      }
    }
    for (int q = 1; q < split; ++q) {
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (!live[u]) continue;
        const float4 v = vfm::ld_cluster_f4(vfm::map_rank(off[u], q));
        y[u].x = __fadd_rn(y[u].x, v.x);
        y[u].y = __fadd_rn(y[u].y, v.y);
        y[u].z = __fadd_rn(y[u].z, v.z);
        y[u].w = __fadd_rn(y[u].w, v.w);
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (!live[u]) continue;
      const float4 bv = __ldg(reinterpret_cast<const float4*>(args.b2 + col[u]));
      const float4 gv = __ldg(reinterpret_cast<const float4*>(args.gamma + col[u]));
      const float2 x01 = vfm::unpack_bf16(xi[u].x), x23 = vfm::unpack_bf16(xi[u].y);
      uint2 res;
      res.x = vfm::pack_bf16(out_val(y[u].x, bv.x, gv.x, x01.x), out_val(y[u].y, bv.y, gv.y, x01.y));
      res.y = vfm::pack_bf16(out_val(y[u].z, bv.z, gv.z, x23.x), out_val(y[u].w, bv.w, gv.w, x23.y));
      *reinterpret_cast<uint2*>(args.out + o[u]) = res;
    }
  }
  vfm::cluster_sync();
}

template <int C, bool kPipe>
cudaError_t launch(const Plan& p, const void* x, const void* xin, const float* A, const float* d,
                   const float* b1, const void* w1, const void* w2, const float* b2,
                   const float* gamma, void* out, int B, int HW, cudaStream_t stream) {
  static std::atomic<unsigned long long> attr_done{0};
  auto kernel = fused_mlp_kernel<C, kPipe>;
  cudaError_t err = vfm::smem_limit_once(kernel, kSmemMax, attr_done);
  if (err != cudaSuccess) return err;
  // x as (B, HW, 1, C); W1 (4C, C) and W2 (C, 4C) as (1, rows, 1, columns);
  // boxes of 64 rows x 64 columns.
  CUtensorMap tx, tw1, tw2, txin;
  if ((err = vfm::tensor_map(&tx, x, B, HW, 1, C, 64)) != cudaSuccess) return err;
  if ((err = vfm::tensor_map(&txin, xin, B, HW, 1, C, 64)) != cudaSuccess) return err;
  if ((err = vfm::tensor_map(&tw1, w1, 1, 4 * C, 1, C, 64)) != cudaSuccess) return err;
  if ((err = vfm::tensor_map(&tw2, w2, 1, C, 1, 4 * C, 64)) != cudaSuccess) return err;
  const Args a{static_cast<const bf16*>(xin), A, d, b1, b2, gamma, static_cast<bf16*>(out),
               HW, cdiv(HW, p.rows), p.split, p.chunks, p.stages};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.ctas);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, tx, tw1, tw2, txin, a);
}

template <bool kPipe>
int dispatch(const void* x, const void* xin, const float* A, const float* d, const float* b1,
             const void* w1, const void* w2, const float* b2, const float* gamma, void* out,
             int B, int HW, int C, void* stream) {
  const void* ptrs[10] = {x, xin, A, d, b1, w1, w2, b2, gamma, out};
  for (const void* q : ptrs)
    if (q == nullptr || (reinterpret_cast<uintptr_t>(q) & 15)) return (int)cudaErrorInvalidValue;
  if (B <= 0 || HW <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Plan p = make_plan(B, HW, C, vfm::sm_count());
  switch (C) {
    case 128: return launch<128, kPipe>(p, x, xin, A, d, b1, w1, w2, b2, gamma, out, B, HW, s);
    case 256: return launch<256, kPipe>(p, x, xin, A, d, b1, w1, w2, b2, gamma, out, B, HW, s);
    case 512: return launch<512, kPipe>(p, x, xin, A, d, b1, w1, w2, b2, gamma, out, B, HW, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int vfm_fused_convnext_mlp(const void* x, const void* xin, const float* A,
                                      const float* d, const float* b1, const void* w1,
                                      const void* w2, const float* b2, const float* gamma,
                                      void* out, int B, int HW, int C, void* stream) {
  return dispatch<false>(x, xin, A, d, b1, w1, w2, b2, gamma, out, B, HW, C, stream);
}

// K9: the pipelined issue order, same arguments, plan and bits as K1.
extern "C" int vfm_fused_convnext_mlp_pipelined(const void* x, const void* xin, const float* A,
                                                const float* d, const float* b1, const void* w1,
                                                const void* w2, const float* b2,
                                                const float* gamma, void* out, int B, int HW,
                                                int C, void* stream) {
  return dispatch<true>(x, xin, A, d, b1, w1, w2, b2, gamma, out, B, HW, C, stream);
}

// The launch plan for (B, HW, C) on a card with `sms` SMs (K1 and K9 alike;
// `pipelined` is accepted for the mirror's signature): plan[0] tokens per
// CTA, [1] token tiles, [2] split of the hidden (the cluster size), [3]
// 64-column hidden chunks per CTA, [4] CTAs, [5] ring stages, [6] dynamic
// shared memory in bytes, [7] threads per CTA, [8] consumer warpgroups.
extern "C" int vfm_fused_mlp_plan(int B, int HW, int C, int pipelined, int sms, int* plan) {
  (void)pipelined;
  if (B <= 0 || HW <= 0 || sms <= 0 || (C != 128 && C != 256 && C != 512))
    return (int)cudaErrorInvalidValue;
  const Plan p = make_plan(B, HW, C, sms);
  const int vals[9] = {p.rows, p.tiles, p.split, p.chunks, p.ctas, p.stages, p.smem, kThreads, 2};
  for (int i = 0; i < 9; ++i) plan[i] = vals[i];
  return 0;
}

// Never launched: one hidden activation a thread, and the same kernel with
// only its FMA. The difference of their SASS instruction counts, plus one, is
// the CUDA cores' work per GELU evaluation (fused_mlp.gelu_instructions, the
// GELU term of chip_smoke.py's bound).
extern "C" __global__ void vfm_gelu_count_kernel(const float* __restrict__ v,
                                                 const float* __restrict__ d,
                                                 const float* __restrict__ b1,
                                                 float* __restrict__ y) {
  y[threadIdx.x] = hidden_act(v[threadIdx.x], d[threadIdx.x], b1[threadIdx.x]);
}

extern "C" __global__ void vfm_fma_count_kernel(const float* __restrict__ v,
                                                const float* __restrict__ d,
                                                const float* __restrict__ b1,
                                                float* __restrict__ y) {
  y[threadIdx.x] = __fmaf_rn(v[threadIdx.x], d[threadIdx.x], b1[threadIdx.x]);
}

extern "C" const char* vfm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

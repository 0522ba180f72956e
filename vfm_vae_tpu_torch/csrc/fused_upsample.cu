// K2: fused SeparableUpsampleWithFixedBlur (pre-normalized) for Hopper.
//
// Replaces vfm_vae_tpu/ops/pallas/fused_upsample.py:_fused (Pallas body
// _kernel) together with its plain-XLA vertical leg _vblur, with the same
// rounding points in the same order:
//   GN affine x*a+c -> bf16 -> depthwise 3x3 zero-SAME (fp32, taps in (dy, dx)
//   order) -> bf16 -> pointwise Ci -> 4Co (fp32 accumulation) -> bf16 ->
//   PixelShuffle(2) (output channel c takes subpixel q from column c*4 + q)
//   -> horizontal edge-replicate blur (fp32, taps in order) -> bf16 ->
//   vertical edge-replicate blur (fp32) -> bf16.
//
// Bound on the H100: the pointwise product is 8 H W Ci Co flops against one
// read of x and the write of a 4x larger output: the tensor cores bound the
// 512-channel sites, the output write the 256 -> 128 top site. The first
// design (one CTA per input row, 62-pixel band and 32 output channels on
// mma.sync) recomputed the GN affine and the stencil for every 32 output
// channels (16x at Co = 512), wasted most of its 64 GEMM rows at W <= 32,
// overlapped nothing, and sent the horizontally blurred map through device
// memory to a second kernel for the vertical leg.
//
// Design: one launch, no scratch tensor.
// - A CTA owns one sample and a tile of R x Wb input pixels (the plan picks
//   R and Wb per (H, W, Ci), below) and walks the 4Co GEMM columns of that
//   tile in N tiles of 128 (32 output channels x 4 subpixels). Where the
//   tiles would not fill the SMs, the plan splits the N walk over `split`
//   CTAs of one tile (each computes the tile's stencil; nothing is summed
//   across them).
// - Both blurs need one input pixel of halo (hb <= 2 on the 2x grid), so the
//   stencil and the product run over the tile plus a one-pixel ring:
//   Rs x Ws = (R + 2) x (Wb + 2) GEMM rows, padded to mpad = 128 or 256. x
//   arrives by TMA from a (B, H, W, Ci) map in boxes of 64 (or 32) channels
//   over (Rs + 2) x (Ws + 2) pixels (two pixels of halo: a ring pixel's
//   stencil needs its own neighbours), double-buffered; the box's 9 taps, a
//   and c a channel arrive beside it by bulk copies on the same barrier.
//   TMA zero-fills x outside the image, which the affine would turn into c:
//   the consumers apply the affine in place and zero every position outside
//   the image afterwards (the depthwise's SAME padding), then the 3x3
//   stencil (a thread's 8 channels' 72 taps in registers) writes bf16 into
//   the resident A operand: Ci / 64 boxes of mpad rows x 128 bytes in the
//   128-byte swizzle, wgmma's K-major layout. The stencil is computed once
//   per (pixel, channel) of the tile and its ring. A (mpad Ci bf16) is at
//   most 128 KB: mpad is 64 at Ci > 512 (the separate upsamples of blocks
//   1-3 take 768 and 640 channels), so A holds up to 1024 channels; past
//   that (no model site) it holds 1024 at a time and is recomputed for
//   every N tile.
// - pw (4Co, Ci) streams through a TMA ring of 128 x 64 bf16 stages (16 KB),
//   loaded as four 32-row boxes so that the tile's GEMM columns are ordered
//   q * 32 + c (subpixel-major; a 3-D map of pw as (Co, 4, Ci)). A producer
//   warp feeds the ring (and the x boxes); two consumer warpgroups issue
//   wgmma m64n128k16 SS over their 64 (mpad 128) or 128 (mpad 256) rows, or
//   one over the 64 rows of mpad 64 (both compute the stencil and blurs).
// - Epilogue of an N tile, in parts of 16 channels (8 at mpad 256): the
//   accumulators are rounded to bf16 into a product buffer in shared memory
//   (rows of the tile's pixels, 4 subpixels x the part's channels). The
//   horizontal leg writes Hs, the 2R + 4 output rows that the vertical taps
//   read (clamped at the image's edges, so a tile at an edge replicates the
//   edge pixel and never reads a ring pixel outside the image) x the tile's
//   2 Wb output columns, in bf16; a task takes two output columns, whose
//   taps read 6 values. The vertical leg reads Hs, 4 output rows a task
//   (8 rows of Hs in registers), and stores 16 bytes a row. The blurs run
//   in a 5-tap frame; 3 and 1 taps are zero-padded at both ends (fmaf(0, v,
//   s) leaves s unchanged).
// - No float atomics: two calls on the same input give the same bits.
//
// What bounds it (probes/fused_upsample.py on an NVIDIA H100 80GB HBM3 at
// 700 W; PERF.md): 0.09-0.15 of the bound a site at B=32. The products take
// under 10% of the time, the two blur legs about 43% and the stencil's
// arithmetic 15%, all on the CUDA cores of one CTA an SM (A alone is 128
// KB). A third consumer warpgroup on that scalar work, 128 rows at Ci =
// 256, rows padded against bank conflicts, 32-channel x boxes and other
// blur task shapes measured no faster.
//
// The plan (vfm_fused_upsample_plan exports it; ops/kernels/fused_upsample.py
// mirrors it): the tile minimizes the padded GEMM rows over the image
// (tiles x mpad), then the x pixels loaded; mpad = 256 only where A fits at
// Ci <= 256, 64 at Ci > 512. At the flagship sites that is 4 x 8 at Ci =
// 768 and 640 (60 of 64 rows for 32 pixels), 8 x 8 at Ci = 512 and H = 8
// and 16 (100 of 128 for 64), 5 x 16 at H = 32 and 64 (126 of 128 for 80)
// and 12 x 16 at Ci = 256 (252 of 256 for 192). x boxes hold 64 channels unless
// that would leave the ring under 3 stages. The ring takes what shared
// memory leaves beside A and the epilogue's buffers (the x boxes share their
// space when A is resident): 3-4 stages.
//
// Layouts: x (B, H, W, Ci) bf16; a, c (B, Ci) fp32; dw (Ci, 3, 3) fp32;
// pw (4Co, Ci) bf16 (torch (out, in)); out (B, 2H, 2W, Co) bf16. Ci % 32 ==
// 0, Co % 32 == 0, odd taps <= 5, any H and W; pointers 16-byte aligned.
#include "flash.cuh"

namespace {

using vfm::bf16;

constexpr int kThreads = 384;       // producer warpgroup + two consumer warpgroups
constexpr int kSmemMax = 232448;
constexpr int kSlack = 1024;        // 1024-byte alignment of the swizzled tiles
constexpr int kBarBytes = 512;
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr int kStage = 128 * 128;   // one ring stage: 128 pw rows x 64 input channels
constexpr int kABudget = 131072;    // the resident A operand
constexpr int kParamBytes = 44;     // a box's parameters a channel: 9 taps, a and c (fp32)
constexpr int kRG = 4;              // output rows a vertical-leg task
constexpr int kFrame = 5;           // taps of the blur frame

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ constexpr int align1k(int v) { return (v + 1023) & ~1023; }
// Channels of an epilogue part and bytes of a product-buffer row (4 subpixels
// of them, + 16 bytes against bank conflicts), by the GEMM rows of a tile.
__host__ __device__ constexpr int part_channels(int mpad) { return mpad == 256 ? 8 : 16; }
__host__ __device__ constexpr int prod_ld(int mpad) { return 8 * part_channels(mpad) + 16; }

struct Plan {
  int rows, cols, tiles_h, tiles_w, tiles, split, ctas, mpad, kc, chunks, xc, stages, smem;
  int a_bytes, e_bytes, x_bytes, hs_off;  // A, the epilogue (+ x) region, an x slot, Hs in it
};

Plan make_plan(int B, int H, int W, int Ci, int Co, int sms) {
  Plan p{};
  const int ci64 = cdiv(Ci, 64) * 64;
  const int mmax = ci64 <= 256 ? 256 : ci64 <= 512 ? 128 : 64;
  const int mmin = mmax == 64 ? 64 : 128;
  long long best_rows = -1, best_x = 0;
  for (int r = 1; r <= H && (r + 2) * 3 <= mmax; ++r)
    for (int w = 1; w <= W && (r + 2) * (w + 2) <= mmax; ++w) {
      const long long t = (long long)cdiv(H, r) * cdiv(W, w);
      const long long rows = t * ((r + 2) * (w + 2) <= mmin ? mmin : 256);
      const long long xp = t * (r + 4) * (w + 4);
      if (best_rows < 0 || rows < best_rows || (rows == best_rows && xp < best_x)) {
        best_rows = rows;
        best_x = xp;
        p.rows = r;
        p.cols = w;
      }
    }
  p.mpad = (p.rows + 2) * (p.cols + 2) <= mmin ? mmin : 256;
  p.tiles_h = cdiv(H, p.rows);
  p.tiles_w = cdiv(W, p.cols);
  p.tiles = B * p.tiles_h * p.tiles_w;
  p.kc = p.mpad * ci64 * 2 <= kABudget ? ci64 : kABudget / (p.mpad * 2) / 64 * 64;
  p.chunks = cdiv(ci64, p.kc);
  const int n_tiles = Co / 32;
  p.split = 1;
  while (p.split * 2 <= n_tiles && 2LL * p.tiles * p.split <= sms) p.split *= 2;
  p.ctas = p.tiles * p.split;
  p.a_bytes = p.mpad * p.kc * 2;
  // The epilogue region: the product buffer, then Hs (the horizontal leg of
  // 2 rows + 4 output rows x 2 cols output columns of a part's channels).
  p.hs_off = p.mpad * prod_ld(p.mpad);
  const int epi = align1k(p.hs_off + (2 * p.rows + 4) * 2 * p.cols * part_channels(p.mpad) * 2);
  // x boxes of 64 channels unless they would leave the ring under 3 stages.
  for (p.xc = 64;; p.xc = 32) {
    p.x_bytes = align1k((p.rows + 4) * (p.cols + 4) * p.xc * 2 + p.xc * kParamBytes);
    p.e_bytes = p.chunks == 1 ? (epi > 2 * p.x_bytes ? epi : 2 * p.x_bytes) : epi + 2 * p.x_bytes;
    p.stages = (kSmemMax - kSlack - p.a_bytes - p.e_bytes - kBarBytes) / kStage;
    if (p.stages >= 3 || p.xc == 32) break;
  }
  p.smem = kSlack + p.a_bytes + p.e_bytes + p.stages * kStage + kBarBytes;
  return p;
}

// Kernel arguments that are not tensor maps.
struct Args {
  const float *a, *c, *dw;
  bf16* out;
  int H, W, Ci, Co;
  int R, Wb, tiles_h, tiles_w, split, n_tiles, kc, chunks, xc, stages;
  int a_bytes, e_bytes, x_bytes, hs_off;
  float taps[kFrame];  // the blur taps, centred in the 5-tap frame
};

template <int MPAD, bool kResident>
__global__ void __launch_bounds__(kThreads, 1) upsample_blur_kernel(
    const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tpw,
    const Args args) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = vfm::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);  // generic pointer to `base`
  constexpr int kMpad = MPAD;
  // Warpgroups that issue the products (one at 64 rows), 64-row blocks each.
  constexpr int kNMma = MPAD == 64 ? 1 : 2, MB = MPAD / 64 / kNMma;
  constexpr int kCG = part_channels(kMpad), kParts = 32 / kCG, kCPC = kCG / 8;
  constexpr int kPLd = prod_ld(kMpad);
  const int H = args.H, W = args.W, Ci = args.Ci, xc = args.xc;
  const int Rs = args.R + 2, Ws = args.Wb + 2, Xh = Rs + 2, Xw = Ws + 2;
  const int box_bytes = Xh * Xw * xc * 2;  // an x box; its parameters follow it
  const int stages = args.stages;
  // [A | epilogue: product buffer, Hs (the x slots overlay it when A holds
  // Ci, else follow it) | ring | barriers]
  const uint32_t es = base + args.a_bytes, ring = es + args.e_bytes;
  const uint32_t xs = kResident ? es : es + args.e_bytes - 2 * args.x_bytes;
  const uint32_t bars = ring + stages * kStage;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (stages + s); };
  auto xfull = [&](int i) { return bars + 8u * (2 * stages + i); };
  auto xempty = [&](int i) { return bars + 8u * (2 * stages + 2 + i); };

  const int split = args.split, rank = blockIdx.x % split, tile = blockIdx.x / split;
  const int per_img = args.tiles_h * args.tiles_w;
  const int b = tile / per_img, th = tile % per_img / args.tiles_w, tw = tile % args.tiles_w;
  const int h0 = th * args.R, w0 = tw * args.Wb;
  const int n0 = rank * args.n_tiles / split, n1 = (rank + 1) * args.n_tiles / split;
  const int kbt = cdiv(Ci, 64);  // 64-channel k blocks of the product
  const int kc = args.kc, chunks = args.chunks;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      vfm::mbar_init(full(s), 1);
      vfm::mbar_init(empty(s), 4 * kNMma);  // one arrival per product warp
    }
    for (int i = 0; i < 2; ++i) {
      vfm::mbar_init(xfull(i), 1);
      vfm::mbar_init(xempty(i), 8);
    }
    vfm::mbar_fence_init();
  }
  __syncthreads();

  // Warpgroup 0 produces (one lane issues every TMA load), 1 and 2 consume.
  const int role = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (role == 0) {
    vfm::reg_dealloc<kProducerRegs>();
    if (threadIdx.x == 0) {
      const int total = (n1 - n0) * kbt, pre = total < stages ? total : stages;
      // pw load g of the walk: N tile n0 + g / kbt, k block g % kbt; rows
      // q * 32 + c of the stage hold pw row (32 n + c) * 4 + q.
      auto pw_load = [&](int g) {
        const int s = g % stages;
        if (g >= stages) vfm::mbar_wait(empty(s), ((g / stages) & 1) ^ 1);
        vfm::mbar_expect_tx(full(s), kStage);
        for (int q = 0; q < 4; ++q)
          vfm::tma_load_4d(ring + s * kStage + q * 4096, &tpw, full(s), 64 * (g % kbt), q,
                           32 * (n0 + g / kbt), 0);
      };
      for (int g = 0; g < pre; ++g) pw_load(g);  // the ring is free: fill it first
      int g = 0, xi = 0;
      for (int n = n0; n < n1; ++n)
        for (int k = 0; k < chunks; ++k) {
          const int c0 = k * kc, c1 = min(c0 + kc, Ci);
          if (!kResident || n == n0)
            for (int ch = c0; ch < c1; ch += xc, ++xi) {
              // An x box and its channels' taps, a and c.
              const int i = xi & 1, nc = min(xc, c1 - ch);
              const uint32_t xb = xs + i * args.x_bytes, pb = xb + box_bytes;
              if (xi >= 2) vfm::mbar_wait(xempty(i), ((xi >> 1) & 1) ^ 1);
              vfm::mbar_expect_tx(xfull(i), box_bytes + nc * kParamBytes);
              vfm::tma_load_4d(xb, &tx, xfull(i), ch, w0 - 2, h0 - 2, b);
              vfm::bulk_load(pb, args.dw + (size_t)ch * 9, nc * 36, xfull(i));
              vfm::bulk_load(pb + xc * 36, args.a + (size_t)b * Ci + ch, nc * 4, xfull(i));
              vfm::bulk_load(pb + xc * 40, args.c + (size_t)b * Ci + ch, nc * 4, xfull(i));
            }
          for (int kb = c0 / 64; kb < cdiv(c1, 64); ++kb, ++g)
            if (g >= pre) pw_load(g);
        }
    }
    return;
  }

  vfm::reg_alloc<kConsumerRegs>();
  const int wg = role - 1, ctid = threadIdx.x - 128;
  const bool mma = wg < kNMma;  // warpgroup-uniform
  const int warp = (ctid >> 5) & 3, lane = ctid & 31, g8 = lane >> 2, t4 = lane & 3;
  int gi = 0, xi = 0;

  // The stencil of channels [c0, c1) into A: per x box, the affine in place
  // (zero outside the image), then the 3x3 depthwise over the Rs x Ws tile,
  // 8 channels a thread (its 16-byte chunk of the box's pixels is fixed).
  auto stencil = [&](int c0, int c1) {
    const int cpp = xc >> 3, chunk = ctid % cpp, pstep = 256 / cpp;
    for (int ch = c0; ch < c1; ch += xc, ++xi) {
      const int i = xi & 1, cc = ch + 8 * chunk;
      const bool live = cc < c1;  // the last box may hold 32 channels of 64
      unsigned char* xt = smem + (xs - base) + i * args.x_bytes;
      const float* prm = reinterpret_cast<const float*>(xt + box_bytes);
      vfm::mbar_wait(xfull(i), (xi >> 1) & 1);
      if (live) {
        float av[8], cv[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          av[e] = prm[xc * 9 + 8 * chunk + e];
          cv[e] = prm[xc * 10 + 8 * chunk + e];
        }
        for (int p = ctid / cpp; p < Xh * Xw; p += pstep) {
          const int py = p / Xw, px = p - py * Xw;
          const int hh = h0 - 2 + py, ww = w0 - 2 + px;
          uint4* q = reinterpret_cast<uint4*>(xt + p * (xc * 2) + chunk * 16);
          uint4 v = make_uint4(0u, 0u, 0u, 0u);
          if (hh >= 0 && hh < H && ww >= 0 && ww < W) {
            const uint4 u = *q;
            const uint32_t e[4] = {u.x, u.y, u.z, u.w};
            uint32_t o[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const float2 f = vfm::unpack_bf16(e[j]);
              o[j] = vfm::pack_bf16(__fadd_rn(__fmul_rn(f.x, av[2 * j]), cv[2 * j]),
                                    __fadd_rn(__fmul_rn(f.y, av[2 * j + 1]), cv[2 * j + 1]));
            }
            v = make_uint4(o[0], o[1], o[2], o[3]);
          }
          *q = v;
        }
      }
      float wv[72];  // taps (dy, dx) of channels cc .. cc + 7: wv[e * 9 + dy * 3 + dx]
#pragma unroll
      for (int j = 0; j < 18; ++j) {
        const float4 f = live ? reinterpret_cast<const float4*>(prm + 72 * chunk)[j]
                              : make_float4(0.f, 0.f, 0.f, 0.f);
        wv[4 * j] = f.x;
        wv[4 * j + 1] = f.y;
        wv[4 * j + 2] = f.z;
        wv[4 * j + 3] = f.w;
      }
      vfm::named_sync<1, 256>();
      unsigned char* abox = smem + (ch - c0) / 64 * (kMpad * 128);
      const int j16 = ((ch & 63) >> 3) + chunk;  // 16-byte chunk of the A row
      for (int p = ctid / cpp; p < Rs * Ws; p += pstep) {
        const int sy = p / Ws, sx = p - sy * Ws;
        float s[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) s[e] = 0.f;
        if (live) {
#pragma unroll
          for (int dy = 0; dy < 3; ++dy)
#pragma unroll
            for (int dx = 0; dx < 3; ++dx) {
              const uint4 u = *reinterpret_cast<const uint4*>(
                  xt + ((sy + dy) * Xw + sx + dx) * (xc * 2) + chunk * 16);
              const uint32_t e32[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                const float2 f = vfm::unpack_bf16(e32[j]);
                s[2 * j] = fmaf(f.x, wv[(2 * j) * 9 + dy * 3 + dx], s[2 * j]);
                s[2 * j + 1] = fmaf(f.y, wv[(2 * j + 1) * 9 + dy * 3 + dx], s[2 * j + 1]);
              }
            }
        }
        *reinterpret_cast<uint4*>(abox + p * 128 + ((j16 ^ (p & 7)) << 4)) =
            make_uint4(vfm::pack_bf16(s[0], s[1]), vfm::pack_bf16(s[2], s[3]),
                       vfm::pack_bf16(s[4], s[5]), vfm::pack_bf16(s[6], s[7]));
      }
      vfm::fence_proxy_async();  // A for wgmma; the x slot for its next TMA write
      __syncwarp();
      if (lane == 0) vfm::mbar_arrive(xempty(i));
    }
    if ((c1 & 63) && xc == 32) {  // the last box's upper 32 channels are past Ci: zeros
      unsigned char* abox = smem + (c1 - c0) / 64 * (kMpad * 128);
      for (int idx = ctid; idx < kMpad * 4; idx += 256) {
        const int p = idx >> 2, j = 4 + (idx & 3);
        *reinterpret_cast<uint4*>(abox + p * 128 + ((j ^ (p & 7)) << 4)) =
            make_uint4(0u, 0u, 0u, 0u);
      }
    }
    vfm::fence_proxy_async();
    vfm::named_sync<1, 256>();
  };

  // The product buffer (rows of the tile's pixels; per row 4 subpixels x kCG
  // channels) of part e: this thread's accumulator columns (q * 32 + kCG e +
  // 8 jh + 2 t4, + 1) of rows r, r + 8 of each m block, rounded to bf16.
  unsigned char* prod = smem + (es - base);
  unsigned char* hs = prod + args.hs_off;
  auto store_part = [&](const float (&acc)[MB][64], int e) {
#pragma unroll
    for (int m = 0; m < MB; ++m)
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int jh = 0; jh < kCPC; ++jh) {
          const int jb = q * 4 + kCPC * e + jh;
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int r = (wg * MB + m) * 64 + 16 * warp + g8 + 8 * hf;
            *reinterpret_cast<uint32_t*>(prod + r * kPLd + q * (2 * kCG) + (jh * 8 + 2 * t4) * 2) =
                vfm::pack_bf16(acc[m][4 * jb + 2 * hf], acc[m][4 * jb + 2 * hf + 1])  ;
          }
        }
  };

  // The horizontal leg into Hs: row k of Hs is output row clamp(2 h0 - 2 + k)
  // (k < 2R + 4, every row the vertical leg reads), column X of the tile's
  // 2 Wb; a task is one input column w (output columns 2w and 2w + 1, whose
  // taps read 6 values of one output row), 8 channels.
  const int H2 = 2 * H, W2 = 2 * W, R2 = 2 * args.R, Wb2 = 2 * args.Wb;
  const int htasks = (R2 + 4) * args.Wb * kCPC;
  auto hleg = [&]() {
    for (int task = ctid; task < htasks; task += 256) {
      const int chunk = task % kCPC, w = task / kCPC % args.Wb, k = task / (kCPC * args.Wb);
      const int wa = w0 + w;
      if (wa >= W) continue;
      const int yc = min(max(2 * h0 - 2 + k, 0), H2 - 1);
      const unsigned char* row =
          prod + ((yc >> 1) - (h0 - 1)) * Ws * kPLd + (yc & 1) * (4 * kCG) + chunk * 16;
      float s0[8], s1[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) s0[i] = s1[i] = 0.f;
#pragma unroll
      for (int j = 0; j < kFrame + 1; ++j) {
        const int xc2 = min(max(2 * wa - 2 + j, 0), W2 - 1);
        const uint4 u = *reinterpret_cast<const uint4*>(row + ((xc2 >> 1) - (w0 - 1)) * kPLd +
                                                        (xc2 & 1) * (2 * kCG));
        const uint32_t e32[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 f = vfm::unpack_bf16(e32[i]);
          if (j < kFrame) {  // output column 2w: taps 0..4 read values 0..4
            s0[2 * i] = fmaf(args.taps[j], f.x, s0[2 * i]);
            s0[2 * i + 1] = fmaf(args.taps[j], f.y, s0[2 * i + 1]);
          }
          if (j > 0) {  // output column 2w + 1: taps 0..4 read values 1..5
            s1[2 * i] = fmaf(args.taps[j - 1], f.x, s1[2 * i]);
            s1[2 * i + 1] = fmaf(args.taps[j - 1], f.y, s1[2 * i + 1]);
          }
        }
      }
      unsigned char* dst = hs + ((k * Wb2 + 2 * w) * kCG + 8 * chunk) * 2;
      *reinterpret_cast<uint4*>(dst) =
          make_uint4(vfm::pack_bf16(s0[0], s0[1]), vfm::pack_bf16(s0[2], s0[3]),
                     vfm::pack_bf16(s0[4], s0[5]), vfm::pack_bf16(s0[6], s0[7]));
      *reinterpret_cast<uint4*>(dst + kCG * 2) =
          make_uint4(vfm::pack_bf16(s1[0], s1[1]), vfm::pack_bf16(s1[2], s1[3]),
                     vfm::pack_bf16(s1[4], s1[5]), vfm::pack_bf16(s1[6], s1[7]));
    }
  };

  // The vertical leg from Hs, stored: a task is one output column X, 8
  // channels and kRG output rows (kRG + 4 rows of Hs in registers).
  const int vtasks = Wb2 * kCPC * cdiv(R2, kRG);
  auto vleg = [&](int n, int e) {
    for (int task = ctid; task < vtasks; task += 256) {
      const int chunk = task % kCPC, X = task / kCPC % Wb2, grp = task / (kCPC * Wb2);
      const int Xa = 2 * w0 + X, Y0 = kRG * grp;
      if (Xa >= W2) continue;
      uint32_t win[kRG + kFrame - 1][4];
#pragma unroll
      for (int k = 0; k < kRG + kFrame - 1; ++k) {  // rows past 2R + 3 feed no stored row
        const int kr = min(Y0 + k, R2 + 3);
        const uint4 u = *reinterpret_cast<const uint4*>(hs + ((kr * Wb2 + X) * kCG + 8 * chunk) * 2);
        win[k][0] = u.x;
        win[k][1] = u.y;
        win[k][2] = u.z;
        win[k][3] = u.w;
      }
#pragma unroll
      for (int y = 0; y < kRG; ++y) {
        const int Ya = 2 * h0 + Y0 + y;
        if (Y0 + y >= R2 || Ya >= H2) break;
        float s[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) s[i] = 0.f;
#pragma unroll
        for (int j = 0; j < kFrame; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float2 f = vfm::unpack_bf16(win[y + j][i]);
            s[2 * i] = fmaf(args.taps[j], f.x, s[2 * i]);
            s[2 * i + 1] = fmaf(args.taps[j], f.y, s[2 * i + 1]);
          }
        *reinterpret_cast<uint4*>(args.out + (((size_t)b * H2 + Ya) * W2 + Xa) * args.Co +
                                  32 * n + kCG * e + 8 * chunk) =
            make_uint4(vfm::pack_bf16(s[0], s[1]), vfm::pack_bf16(s[2], s[3]),
                       vfm::pack_bf16(s[4], s[5]), vfm::pack_bf16(s[6], s[7]));
      }
    }
  };

  if constexpr (kResident) stencil(0, Ci);
  for (int n = n0; n < n1; ++n) {
    float acc[MB][64];
    if (mma) {
      int pending = -1;  // the ring stage of the last committed product group
      for (int k = 0; k < chunks; ++k) {
        const int c0 = k * kc, c1 = min(c0 + kc, Ci);
        if constexpr (!kResident) {
          if (pending >= 0) {
            vfm::wgmma_wait<0>();
#pragma unroll
            for (int m = 0; m < MB; ++m) vfm::fence_all(acc[m]);
            if (lane == 0) vfm::mbar_arrive(empty(pending));
            pending = -1;
          }
          vfm::named_sync<1, 256>();  // every warpgroup is done reading A
          stencil(c0, c1);
        }
        for (int kb = c0 / 64; kb < cdiv(c1, 64); ++kb) {
          const int s = gi % stages;
          vfm::mbar_wait(full(s), (gi / stages) & 1);
          ++gi;
          const uint32_t bs = ring + s * kStage, ab = base + (kb - c0 / 64) * (kMpad * 128);
          vfm::wgmma_fence();
#pragma unroll
          for (int m = 0; m < MB; ++m)
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
              vfm::wgmma_ss_m64n128(
                  acc[m], vfm::sw128_desc(ab + (wg * MB + m) * 8192 + 32 * kk, 16, 1024),
                  vfm::sw128_desc(bs + 32 * kk, 16, 1024), kb > 0 || kk > 0);
          vfm::wgmma_commit();
          vfm::wgmma_wait<1>();
          if (pending >= 0 && lane == 0) vfm::mbar_arrive(empty(pending));
          pending = s;
        }
      }
      vfm::wgmma_wait<0>();
#pragma unroll
      for (int m = 0; m < MB; ++m) vfm::fence_all(acc[m]);
      if (lane == 0) vfm::mbar_arrive(empty(pending));
    } else if constexpr (!kResident) {
      for (int k = 0; k < chunks; ++k) {  // the stencil's share, its barriers included
        vfm::named_sync<1, 256>();
        stencil(k * kc, min(k * kc + kc, Ci));
      }
    }
    // Per part: the product buffer is free once every thread has passed the
    // previous part's first barrier (its horizontal leg read it), Hs once
    // every thread has passed this part's first (the previous vertical leg).
#pragma unroll  // constant e: the accumulators stay in registers
    for (int e = 0; e < kParts; ++e) {
      if (mma) store_part(acc, e);
      vfm::named_sync<1, 256>();
      hleg();
      vfm::named_sync<1, 256>();
      vleg(n, e);
    }
  }
}

// x (B, H, W, Ci) as a 4-D map (innermost first: Ci, W, H, B) with boxes of
// bc channels x bw x bh pixels, no swizzle; positions outside read as 0.
cudaError_t x_map(CUtensorMap* map, const void* ptr, int B, int H, int W, int Ci, int bc,
                  int bh, int bw) {
  const vfm::EncodeTiled fn = vfm::encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)Ci, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)Ci * 2, (cuuint64_t)W * Ci * 2,
                                 (cuuint64_t)H * W * Ci * 2};
  const cuuint32_t box[4] = {(cuuint32_t)bc, (cuuint32_t)bw, (cuuint32_t)bh, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                        strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int MPAD, bool kResident>
cudaError_t launch(const Plan& p, const CUtensorMap& tx, const CUtensorMap& tpw, const Args& a,
                   cudaStream_t stream) {
  static std::atomic<unsigned long long> attr_done{0};
  auto kernel = upsample_blur_kernel<MPAD, kResident>;
  const cudaError_t err = vfm::smem_limit_once(kernel, kSmemMax, attr_done);
  if (err != cudaSuccess) return err;
  kernel<<<p.ctas, kThreads, p.smem, stream>>>(tx, tpw, a);
  return cudaGetLastError();
}

bool valid(int B, int H, int W, int Ci, int Co, int kb) {
  return B > 0 && H > 0 && W > 0 && Ci > 0 && Co > 0 && Ci % 32 == 0 && Co % 32 == 0 &&
         kb >= 1 && kb <= kFrame && kb % 2 == 1;
}

}  // namespace

extern "C" int vfm_fused_upsample_blur(const void* x, const float* a, const float* c,
                                       const float* dw, const void* pw, const float* taps_host,
                                       int kb, void* out, int B, int H, int W, int Ci, int Co,
                                       void* stream) {
  if (!valid(B, H, W, Ci, Co, kb)) return (int)cudaErrorInvalidValue;
  const void* ptrs[6] = {x, a, c, dw, pw, out};
  for (const void* q : ptrs)
    if (q == nullptr || (reinterpret_cast<uintptr_t>(q) & 15)) return (int)cudaErrorInvalidValue;
  const Plan p = make_plan(B, H, W, Ci, Co, vfm::sm_count());
  if (p.stages < 2) return (int)cudaErrorInvalidValue;
  Args args{a, c, dw, static_cast<bf16*>(out), H, W, Ci, Co, p.rows, p.cols, p.tiles_h,
            p.tiles_w, p.split, Co / 32, p.kc, p.chunks, p.xc, p.stages, p.a_bytes, p.e_bytes,
            p.x_bytes, p.hs_off, {0.f, 0.f, 0.f, 0.f, 0.f}};
  for (int j = 0; j < kb; ++j) args.taps[kFrame / 2 - kb / 2 + j] = taps_host[j];
  CUtensorMap tx, tpw;
  cudaError_t err = x_map(&tx, x, B, H, W, Ci, p.xc, p.rows + 4, p.cols + 4);
  if (err != cudaSuccess) return (int)err;
  // pw (4Co, Ci) as (1, Co, 4, Ci): boxes of 64 channels x 1 subpixel x 32 rows.
  if ((err = vfm::tensor_map(&tpw, pw, 1, Co, 4, Ci, 32)) != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p.mpad == 256) return (int)launch<256, true>(p, tx, tpw, args, s);
  if (p.mpad == 128) return (int)launch<128, true>(p, tx, tpw, args, s);
  if (p.chunks == 1) return (int)launch<64, true>(p, tx, tpw, args, s);
  return (int)launch<64, false>(p, tx, tpw, args, s);
}

// The launch plan for (B, H, W, Ci, Co, kb) on a card with `sms` SMs:
// plan[0] input rows and [1] input columns a tile writes (R, Wb), [2] and [3]
// tiles down and across an image, [4] tiles, [5] split of the N walk, [6]
// CTAs, [7] GEMM rows a tile (mpad), [8] input channels resident in A at a
// time, [9] their chunks, [10] input channels an x box, [11] ring stages,
// [12] dynamic shared memory in bytes, [13] threads per CTA, [14] kernel
// launches a call.
extern "C" int vfm_fused_upsample_plan(int B, int H, int W, int Ci, int Co, int kb, int sms,
                                       int* plan) {
  if (!valid(B, H, W, Ci, Co, kb) || sms <= 0) return (int)cudaErrorInvalidValue;
  const Plan p = make_plan(B, H, W, Ci, Co, sms);
  const int vals[15] = {p.rows, p.cols, p.tiles_h, p.tiles_w, p.tiles,  p.split, p.ctas, p.mpad,
                        p.kc,   p.chunks, p.xc,    p.stages,  p.smem,  kThreads, 1};
  for (int i = 0; i < 15; ++i) plan[i] = vals[i];
  return 0;
}

// K7 and K8: depthwise k x k stride-1 SAME convolution for Hopper, with
// bias + legacy noise + fp32 moment sums (K7) or bias alone (K8).
//
// K7 replaces vfm_vae_tpu/ops/pallas/dwconv_stats.py:_fused (Pallas body
// _kernel): t = round(conv(x, round(w))) + round(b) (+ round(noise)), each
// add rounded to bf16, and s1 = sum over (H, W) of t, s2 = sum of t^2, per
// (sample, channel) in fp32, of the rounded t. K8 replaces
// vfm_vae_tpu/ops/pallas/dwconv.py:_dwconv_same (Pallas body _dw_kernel):
// t = round(conv(x, w) + b), the fp32 bias added before the one rounding.
// The two rounding orders are those of the TPU kernels and the twins.
//
// Bound on the H100: 2 k^2 fp32 flops on the CUDA cores per output element
// against 4 bytes (bf16 in and out), ~25 flops per byte at k = 7, just above
// the fp32 ridge (67 TFLOP/s over 3.35 TB/s, 20): the target is FFMA issue
// without stalls. Design, one launch either way:
// - Persistent CTAs (one per SM) walk contiguous runs of tiles (sample,
//   channel block, tile row, tile column; columns fastest, so a CTA's next
//   tile shares its weights and half its halo in L2). A tile is CB channels
//   x TH x TW output pixels: 64 x 16 x 16, or 256 x 8 x 8 on maps of at most
//   8 x 8 (plan).
// - A ring of 2-3 stages holds the next tiles' inputs while 16 warps
//   compute this one: warp 0, at the top of each tile, TMA-loads the tile
//   two ahead with its k/2 halo (4-D map over x, boxes of 64 channels; the
//   box origin at (w0 - k/2, h0 - k/2): out-of-bounds elements arrive as
//   zeros, which is the SAME padding) and, for K7, its fp32 noise by
//   cp.async, both completing on the stage's mbarrier. (A separate
//   producer warp made 17 warps, which caps a thread at 96 registers, and
//   the k = 7 instances spilled; 16 warps allow 128.)
// - A compute thread owns one channel and an 8 x 4 block of output pixels:
//   its k^2 weights sit in registers (reloaded when the channel block
//   changes), and each input row of its (8 + k - 1) x (4 + k - 1) window is
//   read from shared memory once and serves up to k output rows: 8.75
//   shared loads and conversions per 49 FFMA at k = 7.
// - K7's statistics fold in the same launch (K5's pattern, by segments):
//   the tiles of one (sample, channel block) that follow each other in a
//   CTA's run form a segment. Each thread sums its valid outputs of a tile
//   in row order in fp32 and adds the tile sums in fp64 into its slot of the
//   segment's buffer; after the segment's last tile, one CTA-wide barrier,
//   and threads (moment, channel) add the pixel blocks' slots in order into
//   the segment's fp32 partial, then count the segment's tiles in at the
//   block's counter after a fence. The CTA that completes the count adds the
//   block's partials in tile order in fp64 and resets the counter; a
//   segment that is the whole block writes its sums at once. The segments
//   follow from the shape and the CTA count alone, so two calls on one card
//   give the same bits (no float atomics). Zero halo outputs are masked,
//   not summed. The epilogue rounds, adds the bias and the noise two
//   columns at a time (bf16x2).
//
// Layouts: x, out (B, H, W, C) bf16, C a multiple of 64; w (k, k, C) fp32;
// b (C,) fp32 (K7: required; K8: or null); noise (H, W) fp32 or null; part
// (2, B, C / CB, tiles_h * tiles_w, CB) fp32 and counters (B, C / CB) int32
// (zero between calls) workspace; s (2, B, C) fp32: s1 then s2.
#include <atomic>

#include "flash.cuh"

namespace {

using vfm::bf16;

constexpr int kR = 8;                     // output rows a compute thread
constexpr int kWT = 4;                    // output columns a compute thread
constexpr int kThreads = 512;             // 16 warps, 4 an SM sub-partition, all computing
constexpr int kWarps = kThreads / 32;
constexpr int kMaxStages = 3;
constexpr int kSmemMax = 232448;
constexpr int kAlign = 128;               // dynamic shared memory aligned by hand
constexpr int kRedBytes = 2 * 2 * kThreads * 8;  // [segment parity][moment][pixel block][channel]
constexpr int kBarBytes = 64;             // mbarriers full[3], empty[3] and the last-block flag

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

struct Plan {
  int cb, th, tw, tiles_h, tiles_w, n_cb, tiles, ctas, stages, stage_bytes, x_bytes, smem;
  int part_floats, counters;
};

// 256 channels x 8 x 8 pixels where the map fits one tile and C allows
// (the k = 5 sites at H = 8), else 64 x 16 x 16. The ring takes up to three
// stages of what shared memory holds beside the statistics' buffer.
Plan make_plan(int B, int H, int W, int C, int k, bool stats, int sms) {
  Plan p{};
  const bool small = H <= 8 && W <= 8 && C % 256 == 0;
  p.cb = small ? 256 : 64;
  p.th = p.tw = small ? 8 : 16;
  p.x_bytes = (p.cb / 64) * (p.th + k - 1) * (p.tw + k - 1) * 64 * 2;
  const int noise_bytes = stats ? cdiv(p.th * p.tw * 4, kAlign) * kAlign : 0;
  p.stage_bytes = p.x_bytes + noise_bytes;
  const int fixed = kAlign + (stats ? kRedBytes : 0) + kBarBytes;
  p.stages = (kSmemMax - fixed) / p.stage_bytes;
  if (p.stages > kMaxStages) p.stages = kMaxStages;
  p.smem = fixed + p.stages * p.stage_bytes;
  p.tiles_h = cdiv(H, p.th);
  p.tiles_w = cdiv(W, p.tw);
  p.n_cb = C / p.cb;
  p.tiles = B * p.n_cb * p.tiles_h * p.tiles_w;
  p.ctas = p.tiles < sms ? p.tiles : sms;
  p.part_floats = stats ? 2 * B * C * p.tiles_h * p.tiles_w : 0;
  p.counters = stats ? B * p.n_cb : 0;
  return p;
}

struct Args {
  const float* w;
  const float* bias;
  const float* noise;
  bf16* out;
  float* part;
  int* counters;
  float* s;
  int B, H, W, C, tiles_h, tiles_w, n_cb, tiles, stages, stage_bytes, x_bytes;
};

struct Tile {
  int b, cb, th, tw;
};

__device__ __forceinline__ Tile tile_of(int t, const Args& a) {
  Tile r;
  r.tw = t % a.tiles_w;
  t /= a.tiles_w;
  r.th = t % a.tiles_h;
  t /= a.tiles_h;
  r.cb = t % a.n_cb;
  r.b = t / a.n_cb;
  return r;
}

// bf16 bits <-> fp32.
__device__ __forceinline__ unsigned short bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}
__device__ __forceinline__ float bits_float(unsigned short v) {
  return __uint_as_float(static_cast<uint32_t>(v) << 16);
}

// A 4-byte cp.async of `src` (zero-filled when !valid) to shared `dst`, and
// an arrival on `bar` once this thread's earlier cp.asyncs have landed (the
// arrival is counted in the barrier's initial count).
__device__ __forceinline__ void cp_async4(uint32_t dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

// Two bf16 values (packed, the first in the low half) added lane by lane,
// each sum rounded once: the exact fp32 sum of two bf16 values rounded to
// bf16, as the twin adds in bf16.
__device__ __forceinline__ uint32_t badd2(uint32_t a, uint32_t b) {
  uint32_t r;
  asm("add.rn.bf16x2 %0, %1, %2;\n" : "=r"(r) : "r"(a), "r"(b));
  return r;
}

// The CTA runs and the segments of a block. CTA k walks tiles [r(k), r(k+1))
// with r(k) = floor(k tiles / ctas); the tiles of one (sample, channel
// block) are the contiguous range [T0, T0 + nsp), so the CTAs whose runs
// meet it cut it into segments that start at T0 and at every run start
// inside it: those of the CTAs k in [seg_lo(T0), seg_hi(T0 + nsp)].
__host__ __device__ inline int run_start(long long k, int tiles, int ctas) {
  return static_cast<int>(k * tiles / ctas);
}
__host__ __device__ inline int seg_lo(int t0, int tiles, int ctas) {  // first run starting after t0
  return static_cast<int>(((long long)(t0 + 1) * ctas + tiles - 1) / tiles);
}
__host__ __device__ inline int seg_hi(int t1, int tiles, int ctas) {  // last run starting before t1
  return static_cast<int>(((long long)t1 * ctas + tiles - 1) / tiles) - 1;
}

// kStats: K7 (rounded weights, bias and noise added in bf16, moment sums);
// else K8.
template <int K, bool kStats, int CB, int TH, int TW>
__global__ void __launch_bounds__(kThreads, 1) dwconv_kernel(const __grid_constant__ CUtensorMap tx,
                                                             const Args a) {
  constexpr int P = K / 2, IH = TH + K - 1, IW = TW + K - 1;
  constexpr int NQ = CB / 32;          // warps across the channel block
  constexpr int NPB = kWarps / NQ;     // pixel blocks of a tile
  constexpr int BW = TW / kWT;         // pixel blocks across a tile
  constexpr int PLANE = IH * IW * 64;  // bf16 elements of one 64-channel box
  static_assert(NPB * NQ == kWarps && NPB == (TH / kR) * BW, "16 warps cover a tile");
  static_assert(kWT % 2 == 0, "K7's epilogue pairs columns");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  // Aligned by an offset from smem_raw, so that the compiler still sees
  // shared-memory pointers (through an integer the accesses turn generic).
  unsigned char* base = smem_raw + ((kAlign - (vfm::smem_u32(smem_raw) & (kAlign - 1))) &
                                    (kAlign - 1));
  double* red = reinterpret_cast<double*>(base + a.stages * a.stage_bytes);
  uint64_t* bars = reinterpret_cast<uint64_t*>(reinterpret_cast<unsigned char*>(red) +
                                               (kStats ? kRedBytes : 0));
  int* flag = reinterpret_cast<int*>(bars + 2 * kMaxStages);
  const uint32_t full0 = vfm::smem_u32(bars), empty0 = vfm::smem_u32(bars + kMaxStages);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int first = static_cast<int>(static_cast<long long>(blockIdx.x) * a.tiles / gridDim.x);
  const int count =
      static_cast<int>(static_cast<long long>(blockIdx.x + 1) * a.tiles / gridDim.x) - first;
  const bool has_noise = kStats && a.noise != nullptr;
  const int nsp = a.tiles_h * a.tiles_w;
  const size_t moment = (size_t)a.B * a.n_cb * nsp * CB;  // floats between the two moments

  if (tid == 0) {
    for (int s = 0; s < a.stages; ++s) {
      vfm::mbar_init(full0 + 8 * s, has_noise ? 33 : 1);  // the TMA's arrival (+ 32 noise lanes)
      vfm::mbar_init(empty0 + 8 * s, kWarps);
    }
    vfm::mbar_fence_init();
  }
  __syncthreads();

  // Warp 0 fills the ring: tile j of the run into stage j % stages, once the
  // 16 warps have released the stage's previous tile (j - stages); lane 0
  // issues the TMA boxes, every lane a share of K7's noise.
  const CUtensorMap* txp = &tx;
  auto fill = [&](int j) {
    const int s = j % a.stages;
    if (j >= a.stages) vfm::mbar_wait(empty0 + 8 * s, ((j / a.stages) - 1) & 1);
    const Tile t = tile_of(first + j, a);
    const int h0 = t.th * TH, w0 = t.tw * TW;
    unsigned char* st = base + s * a.stage_bytes;
    if (lane == 0) {
      vfm::mbar_expect_tx(full0 + 8 * s, a.x_bytes);
#pragma unroll
      for (int b = 0; b < CB / 64; ++b)
        vfm::tma_load_4d(vfm::smem_u32(st + b * PLANE * 2), txp, full0 + 8 * s,
                         t.cb * CB + 64 * b, w0 - P, h0 - P, t.b);
    }
    if (has_noise) {
      const uint32_t ns = vfm::smem_u32(st + a.x_bytes);
      for (int e = lane; e < TH * TW; e += 32) {
        const int hh = h0 + e / TW, ww = w0 + e % TW;
        const bool in = hh < a.H && ww < a.W;
        cp_async4(ns + 4 * e, in ? a.noise + (size_t)hh * a.W + ww : a.noise, in);
      }
      cp_async_arrive(full0 + 8 * s);
    }
  };
  if (warp == 0)
    for (int j = 0; j < a.stages - 1 && j < count; ++j) fill(j);

  // Compute thread: channel q * 32 + lane of the block, pixel block pb.
  const int q = warp % NQ, pb = warp / NQ;
  const int pr = pb / BW, pc = pb % BW;
  const int cl = q * 32 + lane;
  const int rd = (q >> 1) * PLANE + (pr * kR * IW + pc * kWT) * 64 + (q & 1) * 32 + lane;
  float wr[K * K];
  float bias_f = 0.f;
  uint32_t bias2 = 0;
  int cur_cb = -1;
  for (int i = 0; i < count; ++i) {
    if (warp == 0 && i + a.stages - 1 < count) fill(i + a.stages - 1);
    const int s = i % a.stages;
    const Tile t = tile_of(first + i, a);
    const int c = t.cb * CB + cl;
    if (t.cb != cur_cb) {  // the weights of this thread's channel, once a run of tiles
#pragma unroll
      for (int j = 0; j < K * K; ++j) {
        const float v = __ldg(a.w + (size_t)j * a.C + c);
        wr[j] = kStats ? vfm::round_bf16(v) : v;
      }
      if (a.bias != nullptr) {
        bias_f = __ldg(a.bias + c);
        bias2 = vfm::pack_bf16(bias_f, bias_f);
      }
      cur_cb = t.cb;
    }
    vfm::mbar_wait(full0 + 8 * s, (i / a.stages) & 1);
    const unsigned short* xs =
        reinterpret_cast<const unsigned short*>(base + s * a.stage_bytes) + rd;

    float acc[kR][kWT];
#pragma unroll
    for (int o = 0; o < kR; ++o)
#pragma unroll
      for (int j = 0; j < kWT; ++j) acc[o][j] = 0.f;
    // Input row ri of the window feeds output rows o = ri - dy.
#pragma unroll
    for (int ri = 0; ri < kR + K - 1; ++ri) {
      float in[kWT + K - 1];
#pragma unroll
      for (int j = 0; j < kWT + K - 1; ++j) in[j] = bits_float(xs[(ri * IW + j) * 64]);
#pragma unroll
      for (int o = 0; o < kR; ++o) {
        const int dy = ri - o;
        if (dy < 0 || dy >= K) continue;
#pragma unroll
        for (int dx = 0; dx < K; ++dx)
#pragma unroll
          for (int j = 0; j < kWT; ++j) acc[o][j] = fmaf(in[j + dx], wr[dy * K + dx], acc[o][j]);
      }
    }

    // Epilogue: round, add, store the valid outputs; K7 sums them in order.
    const int hb = t.th * TH + pr * kR, wb = t.tw * TW + pc * kWT;
    const float* ns = reinterpret_cast<const float*>(base + s * a.stage_bytes + a.x_bytes) +
                      pr * kR * TW + pc * kWT;
    unsigned short* op = reinterpret_cast<unsigned short*>(a.out) +
                         (((size_t)t.b * a.H + hb) * a.W + wb) * a.C + c;
    const size_t row = (size_t)a.W * a.C;
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int o = 0; o < kR; ++o, op += row) {
      if (hb + o >= a.H) break;
      if constexpr (kStats) {
        // Two columns at a time: round both, add the bias pair, the noise pair.
#pragma unroll
        for (int j = 0; j < kWT; j += 2) {
          uint32_t v = badd2(vfm::pack_bf16(acc[o][j], acc[o][j + 1]), bias2);
          if (has_noise) {
            const float2 n = *reinterpret_cast<const float2*>(ns + o * TW + j);
            v = badd2(v, vfm::pack_bf16(n.x, n.y));
          }
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            if (wb + j + h < a.W) {
              const uint32_t bits = h ? v >> 16 : v & 0xffffu;
              const float tf = __uint_as_float(bits << 16);
              s1 += tf;
              s2 = fmaf(tf, tf, s2);
              op[(j + h) * a.C] = static_cast<unsigned short>(bits);
            }
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < kWT; ++j)
          if (wb + j < a.W)
            op[j * a.C] = bf16_bits(a.bias != nullptr ? acc[o][j] + bias_f : acc[o][j]);
      }
    }
    __syncwarp();
    if (lane == 0) vfm::mbar_arrive(empty0 + 8 * s);  // this warp is done with the stage

    if constexpr (kStats) {
      // Tiles i of one block that follow each other in this CTA's run form a
      // segment. Each thread adds its tile sums in fp64 into its slot of the
      // segment's buffer (two buffers, by segment parity); after the
      // segment's last tile, one CTA-wide barrier, and threads (moment,
      // channel) add the pixel blocks' slots in order into the segment's
      // fp32 partial (or, for a segment that is the whole block, its sums).
      const int tile = first + i;
      const int blk_id = t.b * a.n_cb + t.cb;
      const bool seg_first = i == 0 || (t.th == 0 && t.tw == 0);
      const bool seg_last = i == count - 1 || (t.th == a.tiles_h - 1 && t.tw == a.tiles_w - 1);
      double* rp = red + (blk_id & 1) * (2 * kThreads);  // consecutive segments alternate
      const double d1 = s1, d2 = s2;
      rp[pb * CB + cl] = seg_first ? d1 : rp[pb * CB + cl] + d1;
      rp[kThreads + pb * CB + cl] = seg_first ? d2 : rp[kThreads + pb * CB + cl] + d2;
      if (seg_last) {
        __syncthreads();
        if (tid < 2 * CB) {  // thread (moment m, channel cc) of the segment
          const int m = tid / CB, cc = tid % CB;
          double d = 0.0;
#pragma unroll
          for (int p2 = 0; p2 < NPB; ++p2) d += rp[m * kThreads + p2 * CB + cc];
          const int t0 = blk_id * nsp, start = max(first, t0), len = tile + 1 - start;
          float* sp = a.s + ((size_t)m * a.B + t.b) * a.C + t.cb * CB + cc;
          if (len == nsp) {
            *sp = (float)d;  // the block is this segment: no counter, no fold
          } else {
            float* blk = a.part + m * moment + (size_t)t0 * CB + cc;  // tile t0's partial
            blk[(size_t)(start - t0) * CB] = (float)d;
            __threadfence();  // the partial, before the count
            vfm::named_sync<2, 2 * CB>();
            if (tid == 0) {
              int* ctr = a.counters + blk_id;
              const int done = atomicAdd(ctr, len) + len == nsp;
              if (done) *ctr = 0;  // the block's tiles are all in: ready for the next call
              *flag = done;
            }
            vfm::named_sync<2, 2 * CB>();
            if (*flag) {  // the last segment in: add the block's partials in tile order
              __threadfence();
              double tot = (double)__ldcg(blk);
              const int k1 = seg_hi(t0 + nsp, a.tiles, gridDim.x);
              for (int k = seg_lo(t0, a.tiles, gridDim.x); k <= k1; k += 8) {
                float v[8];
#pragma unroll
                for (int u = 0; u < 8; ++u)
                  v[u] = k + u <= k1
                             ? __ldcg(blk + (size_t)(run_start(k + u, a.tiles, gridDim.x) - t0) * CB)
                             : 0.f;
#pragma unroll
                for (int u = 0; u < 8; ++u)
                  if (k + u <= k1) tot += (double)v[u];
              }
              *sp = (float)tot;
            }
          }
        }
      }
    }
  }
}

// x (B, H, W, C) as a 4-D map (innermost first: C, W, H, B) with boxes of 64
// channels x iw x ih pixels, no swizzle; positions outside read as 0.
cudaError_t x_map(CUtensorMap* map, const void* ptr, int B, int H, int W, int C, int ih, int iw) {
  const vfm::EncodeTiled fn = vfm::encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)C * 2, (cuuint64_t)W * C * 2,
                                 (cuuint64_t)H * W * C * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)iw, (cuuint32_t)ih, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                        strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int K, bool kStats, int CB, int TH, int TW>
cudaError_t launch_geometry(const Plan& p, const void* x, const Args& a, cudaStream_t stream) {
  static std::atomic<unsigned long long> attr_done{0};
  auto kernel = dwconv_kernel<K, kStats, CB, TH, TW>;
  cudaError_t err = vfm::smem_limit_once(kernel, kSmemMax, attr_done);
  if (err != cudaSuccess) return err;
  CUtensorMap tx;
  if ((err = x_map(&tx, x, a.B, a.H, a.W, a.C, TH + K - 1, TW + K - 1)) != cudaSuccess) return err;
  kernel<<<p.ctas, kThreads, p.smem, stream>>>(tx, a);
  return cudaGetLastError();
}

template <int K, bool kStats>
cudaError_t launch(const Plan& p, const void* x, const Args& a, cudaStream_t stream) {
  if (p.cb == 256) return launch_geometry<K, kStats, 256, 8, 8>(p, x, a, stream);
  return launch_geometry<K, kStats, 64, 16, 16>(p, x, a, stream);
}

bool valid(int B, int H, int W, int C, int k, bool stats) {
  return B > 0 && H > 0 && W > 0 && C > 0 && C % 64 == 0 &&
         (k == 5 || k == 7 || (!stats && k == 3));
}

bool aligned16(const void* p) { return p != nullptr && (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

Args make_args(const Plan& p, const float* w, const float* b, const float* noise, void* out,
               float* part, int* counters, float* s, int B, int H, int W, int C) {
  return Args{w, b, noise, static_cast<bf16*>(out), part, counters, s, B, H, W, C,
              p.tiles_h, p.tiles_w, p.n_cb, p.tiles, p.stages, p.stage_bytes, p.x_bytes};
}

}  // namespace

// K7: t, and s (2, B, C) = s1, s2 of t; k in {5, 7}; b, `part` (the plan's
// part_floats) and `counters` (its counters, 0 before the call and after it)
// required, noise optional.
extern "C" int vfm_dwconv_noise_stats(const void* x, const float* w, const float* b,
                                      const float* noise, void* out, float* part, int* counters,
                                      float* s, int B, int H, int W, int C, int k, void* stream) {
  if (!valid(B, H, W, C, k, true) || !aligned16(x) || !aligned16(out) || w == nullptr ||
      b == nullptr || part == nullptr || counters == nullptr || s == nullptr)
    return (int)cudaErrorInvalidValue;
  const Plan p = make_plan(B, H, W, C, k, true, vfm::sm_count());
  const Args a = make_args(p, w, b, noise, out, part, counters, s, B, H, W, C);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (k == 5) return (int)launch<5, true>(p, x, a, st);
  return (int)launch<7, true>(p, x, a, st);
}

// K8: t of x; k in {3, 5, 7}; b optional.
extern "C" int vfm_depthwise_conv2d_same(const void* x, const float* w, const float* b,
                                         void* out, int B, int H, int W, int C, int k,
                                         void* stream) {
  if (!valid(B, H, W, C, k, false) || !aligned16(x) || !aligned16(out) || w == nullptr)
    return (int)cudaErrorInvalidValue;
  const Plan p = make_plan(B, H, W, C, k, false, vfm::sm_count());
  const Args a = make_args(p, w, b, nullptr, out, nullptr, nullptr, nullptr, B, H, W, C);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (k == 3) return (int)launch<3, false>(p, x, a, st);
  if (k == 5) return (int)launch<5, false>(p, x, a, st);
  return (int)launch<7, false>(p, x, a, st);
}

// The launch plan of K7 (stats 1) or K8 (stats 0) for x (B, H, W, C) and a
// k x k kernel on a card with `sms` SMs: plan[0] channels a tile (CB), [1]
// and [2] its output rows and columns, [3] and [4] tiles down and across a
// map, [5] channel blocks, [6] tiles, [7] CTAs, [8] ring stages, [9] bytes a
// stage, [10] dynamic shared memory in bytes, [11] threads per CTA, [12]
// workspace floats, [13] counters, [14] kernel launches a call.
extern "C" int vfm_dwconv_plan(int B, int H, int W, int C, int k, int stats, int sms, int* plan) {
  if (!valid(B, H, W, C, k, stats != 0) || sms <= 0 || plan == nullptr)
    return (int)cudaErrorInvalidValue;
  const Plan p = make_plan(B, H, W, C, k, stats != 0, sms);
  const int vals[15] = {p.cb,    p.th,     p.tw,          p.tiles_h, p.tiles_w,     p.n_cb,
                        p.tiles, p.ctas,   p.stages,      p.stage_bytes, p.smem,    kThreads,
                        p.part_floats, p.counters, 1};
  for (int i = 0; i < 15; ++i) plan[i] = vals[i];
  return 0;
}

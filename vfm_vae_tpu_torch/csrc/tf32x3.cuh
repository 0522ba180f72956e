// 3xTF32: fp32 products on the tensor cores at fp32's accuracy, shared by
// K4's fp32 backward (flash_attention_nullkv_bwd.cu: dkv_f32_kernel,
// dq_f32_kernel, on mma.sync m16n8k8) and K4's fp32 forward
// (flash_attention_nullkv.cu: flash_fwd_f32_kernel, on wgmma m64nNk8).
//
// Each fp32 operand x is split into hi = tf32(x) (round to nearest) and
// lo = x - hi (exact); a b = a_lo b_hi + a_hi b_lo + a_hi b_hi (small terms
// first; a_lo b_lo, near 2^-21 of the product, is dropped). The tensor cores
// read an fp32 register or shared-memory word as its top 19 bits (TF32), and
// their fp32 accumulation rounds towards zero: chained over a whole
// reduction that puts results several times as far from fp64 as plain fp32
// sums, so every reduction here runs in chains of two k blocks of 8 (six
// products) into a fresh accumulator that one fp32 add (round to nearest)
// folds into the running sum. tests/test_torch_tf32x3.py emulates both
// kernels' arithmetic on the CPU.
//
// mma.sync part: the split as fragments load, ldmatrix fragment loads
// (32-bit words as b16 pairs are the TF32 fragment layout) from rows of
// D + 4 floats, C fragments reused as A fragments with k permuted within each
// block of 8. wgmma part: tiles of fp32 in 32-column boxes in the 128-byte
// swizzle (what a TMA load with CU_TENSOR_MAP_SWIZZLE_128B and a box of 32
// floats writes, and what a K-major tf32 wgmma operand reads), their split
// into hi and lo planes in shared memory, and the tf32 wgmma shapes.
#pragma once

#include "hopper.cuh"

namespace vfm {

// ------------------------------------------------------------------ mma.sync

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

// ---------------------------------------------------------------------- wgmma

// Byte offset of element (r, c) of an fp32 tile of `rows` rows stored as
// 32-column boxes (rows x 128 bytes each) in the 128-byte swizzle: 16-byte
// chunk k of row r at chunk k ^ (r % 8).
__device__ __forceinline__ uint32_t sw32_offset(int r, int c, int rows) {
  return (uint32_t)((c >> 5) * rows * 128 + r * 128 + ((((c >> 2) & 7) ^ (r & 7)) << 4) +
                    (c & 3) * 4);
}

// A landed tile of `bytes` bytes split in place: the raw fp32 at `hi`
// becomes its TF32 high parts, the remainders go to `lo` at the same
// offsets (any layout: the split is elementwise).
__device__ __forceinline__ void split_plane(unsigned char* hi, unsigned char* lo, int bytes,
                                            int tid, int nthreads) {
  for (int i = tid; i < bytes / 16; i += nthreads) {
    const float4 x = *reinterpret_cast<const float4*>(hi + 16 * i);
    uint4 h, l;
    split_tf32(x.x, h.x, l.x);
    split_tf32(x.y, h.y, l.y);
    split_tf32(x.z, h.z, l.z);
    split_tf32(x.w, h.w, l.w);
    *reinterpret_cast<uint4*>(hi + 16 * i) = h;
    *reinterpret_cast<uint4*>(lo + 16 * i) = l;
  }
}

// A landed (KT keys, D) tile `v` (32-column boxes, swizzled) split into the
// hi and lo planes of its transpose (D rows, KT keys; 32-key boxes,
// swizzled), a K-major B operand of O += P V. Keys are permuted within each
// block of 8: positions 0-3 hold keys 0, 2, 4, 6 and positions 4-7 keys 1, 3,
// 5, 7, the order in which P's C fragments serve as A fragments (k index t is
// key 2t, t + 4 is 2t + 1). Item (d, quad q) reads keys 8 (q / 2) + 2i + q % 2
// of column d and stores one 16-byte chunk per plane: 32 lanes on 32 columns
// read one 128-byte row and store to 8 distinct chunks a quarter warp.
template <int D, int KT>
__device__ __forceinline__ void split_transpose(const unsigned char* v, unsigned char* hi,
                                                unsigned char* lo, int tid, int nthreads) {
  for (int i = tid; i < D * KT / 4; i += nthreads) {
    const int d = i % D, q = i / D, key0 = 8 * (q >> 1) + (q & 1);
    uint32_t h[4], l[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      split_tf32(*reinterpret_cast<const float*>(v + sw32_offset(key0 + 2 * e, d, KT)), h[e],
                 l[e]);
    const uint32_t at = sw32_offset(d, 4 * q, D);
    *reinterpret_cast<uint4*>(hi + at) = make_uint4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<uint4*>(lo + at) = make_uint4(l[0], l[1], l[2], l[3]);
  }
}

#define VFM_D4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define VFM_D16(i) VFM_D4(i), VFM_D4(i + 4), VFM_D4(i + 8), VFM_D4(i + 12)

// D (64 x N fp32) = A B (scale_d 0) or D += A B (scale_d 1), tf32, k = 8: A
// (64 x 8) and B (N x 8) in shared memory, both K-major (descriptors of
// 32-column boxes in the 128-byte swizzle); N = 32 or 64.
template <int N>
__device__ __forceinline__ void wgmma_tf32_ss(float (&d)[N / 2], uint64_t da, uint64_t db,
                                              int scale_d) {
  static_assert(N == 32 || N == 64, "m64n32k8 or m64n64k8");
  if constexpr (N == 32) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p, 1, 1;\n}\n"
        : VFM_D16(0)
        : "l"(da), "l"(db), "r"(scale_d));
  } else {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1;\n}\n"
        : VFM_D16(0), VFM_D16(16)
        : "l"(da), "l"(db), "r"(scale_d));
  }
}

// D (64 x N fp32) = A B (scale_d 0) or D += A B (scale_d 1), tf32, k = 8: A
// (64 x 8) in registers (per warp the m16n8k8 TF32 layout: a[0] row g, k t;
// a[1] row g + 8; a[2], a[3] the same rows at k t + 4), B (N x 8) in shared
// memory, K-major; N = 64 or 128.
template <int N>
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                              uint64_t db, int scale_d) {
  static_assert(N == 64 || N == 128, "m64n64k8 or m64n128k8");
  if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : VFM_D16(0), VFM_D16(16)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  } else {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
        : VFM_D16(0), VFM_D16(16), VFM_D16(32), VFM_D16(48)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  }
}

#undef VFM_D16
#undef VFM_D4

}  // namespace vfm

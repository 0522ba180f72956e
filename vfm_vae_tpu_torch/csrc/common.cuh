// Shared device helpers for the hand-written Hopper kernels (sm_90a).
//
// K2 (fused_upsample.cu) uses warp-level bf16 tensor-core products through
// mma.sync.m16n8k16 (fp32 accumulation) with operands staged in shared
// memory (the wgmma kernels' helpers are in hopper.cuh). Fragment layouts
// follow the PTX ISA for .row.col bf16:
//   g = lane / 4, t = lane % 4
//   A (16x16, row-major): a0 = A[g][2t..2t+1],   a1 = A[g+8][2t..2t+1],
//                         a2 = A[g][2t+8..2t+9], a3 = A[g+8][2t+8..2t+9]
//   B (16x8, stored [n][k]): b0 = B[g][2t..2t+1], b1 = B[g][2t+8..2t+9]
//   C (16x8 fp32): c0,c1 = row g, cols 2t,2t+1; c2,c3 = row g+8.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace vfm {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ void mma_16816(float c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A fragment of a row-major tile whose top-left element is `base` (ld in elements).
__device__ __forceinline__ void load_a(uint32_t a[4], const bf16* base, int ld, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const bf16* p0 = base + g * ld + 2 * t;
  const bf16* p1 = p0 + 8 * ld;
  a[0] = *reinterpret_cast<const uint32_t*>(p0);
  a[1] = *reinterpret_cast<const uint32_t*>(p1);
  a[2] = *reinterpret_cast<const uint32_t*>(p0 + 8);
  a[3] = *reinterpret_cast<const uint32_t*>(p1 + 8);
}

// B fragment of a tile stored [n][k] (k contiguous), top-left at `base`.
__device__ __forceinline__ void load_b(uint32_t b[2], const bf16* base, int ld, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const bf16* p = base + g * ld + 2 * t;
  b[0] = *reinterpret_cast<const uint32_t*>(p);
  b[1] = *reinterpret_cast<const uint32_t*>(p + 8);
}

// Two fp32 values rounded to bf16 and packed; `lo` lands at the lower address.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  __nv_bfloat162 h = *reinterpret_cast<__nv_bfloat162*>(&v);
  return __bfloat1622float2(h);
}

// fp32 value rounded to the nearest bf16 (ties to even), back in fp32.
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// 16-byte asynchronous global -> shared copy (sm_80+), bypassing L1.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

}  // namespace vfm

// The second pass of K7's fixed-order two-stage reduction (dwconv_stats.cu).
#pragma once

#include <cuda_runtime.h>

namespace {

// Second pass of the fixed-order two-stage reduction (K7): one thread
// per (sample, channel) adds its `nchunk` fp32 partials (B, nchunk, C) in
// chunk order in fp64 and writes the fp32 sum. No atomics: the result does
// not depend on the order in which the first pass's CTAs ran.
__global__ void __launch_bounds__(256) sum_partials_kernel(const float* __restrict__ part1,
                                                           const float* __restrict__ part2,
                                                           float* __restrict__ s1,
                                                           float* __restrict__ s2, int B,
                                                           int nchunk, int C) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * C) return;
  const int b = i / C, c = i % C;
  const size_t base = (size_t)b * nchunk * C + c;
  double a1 = 0.0, a2 = 0.0;
  for (int j = 0; j < nchunk; ++j) {
    a1 += (double)part1[base + (size_t)j * C];
    a2 += (double)part2[base + (size_t)j * C];
  }
  s1[i] = (float)a1;
  s2[i] = (float)a2;
}

}  // namespace

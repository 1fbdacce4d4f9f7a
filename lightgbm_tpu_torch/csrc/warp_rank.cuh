// Ranks among a warp's lanes, for the kernel that combines the lanes
// holding one bin in a fixed tree over their rank (histogram.cu's
// hist_wide_kernel).
#pragma once

#include <cuda_runtime.h>

namespace {

// the lane of rank j (0-based) among the set bits of m: a binary search
// on popcounts, 5 steps
__device__ __forceinline__ int nth_set_lane(unsigned m, int j) {
  int pos = 0;
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    const unsigned low = m & ((1u << s) - 1u);
    const int c = __popc(low);
    if (j >= c) {
      j -= c;
      m >>= s;
      pos += s;
    } else {
      m = low;
    }
  }
  return pos;
}

}  // namespace

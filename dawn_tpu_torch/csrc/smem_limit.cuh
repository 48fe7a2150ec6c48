// The largest window whose launch fits the device's shared memory, for each
// source's dawn_local_attn_max_window: the kernels' wrappers ask for it
// before launching and name the limit in a ValueError, so a window past it
// never reaches cudaFuncSetAttribute. Each source computes its launches'
// shared memory with one function, used by both.

#pragma once

#include <climits>
#include <cuda_runtime.h>

namespace dawn_limits {

// The largest w in [0, 2^20] with smem(w) <= the current device's opt-in
// shared memory a block (smem non-decreasing in w); INT_MAX when w = 2^20
// fits, so that no window is refused; -1 when none fits or the device
// cannot be asked.
template <typename F>
int max_window(F smem) {
  int dev = 0, limit = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
          cudaSuccess)
    return -1;
  if (smem(0) > (size_t)limit) return -1;
  int lo = 0, hi = 1 << 20;
  if (smem(hi) <= (size_t)limit) return INT_MAX;
  while (hi - lo > 1) {   // smem(lo) fits, smem(hi) does not
    const int mid = lo + (hi - lo) / 2;
    (smem(mid) <= (size_t)limit ? lo : hi) = mid;
  }
  return lo;
}

}  // namespace dawn_limits

// The number of SMs of a device, asked of the CUDA runtime once per
// device. The kernels size their grids by it (K1's rows per thread, K7's
// persistent grid), so both read it the same way.
#pragma once

#include <cuda_runtime.h>

namespace hg {

constexpr int kMaxDevices = 64;

// SMs of device `dev`, or 0 when the runtime cannot say.
inline int sm_count(int dev) {
  static int cached[kMaxDevices] = {0};
  if (dev < 0 || dev >= kMaxDevices) return 0;
  if (cached[dev] == 0) {
    int n = 0;
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return 0;
    cached[dev] = n;
  }
  return cached[dev];
}

}  // namespace hg

// Launch shape shared by the kernels: one thread per lane, grid-stride.
//
// The wrappers (ops/field_kernels.py, ops/point_kernels.py) hand every
// operand over contiguous and already broadcast to the launch's batch, so
// lane i of an operand starts at i * (words per element) and the ragged
// edge is the loop bound: no padding lanes.
#pragma once

#include <stdint.h>

namespace dkg {

constexpr int kThreads = 128;

// Blocks for n lanes: enough to cover them, capped so the grid-stride
// loop takes over on very wide batches (8 blocks per SM on 132 SMs).
inline unsigned blocks_for(int64_t n) {
  int64_t b = (n + kThreads - 1) / kThreads;
  const int64_t cap = 132 * 8;
  return (unsigned)(b < cap ? b : cap);
}

}  // namespace dkg

#define DKG_LANES(lane, n)                                                      \
  for (int64_t lane = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; lane < n; \
       lane += (int64_t)gridDim.x * blockDim.x)

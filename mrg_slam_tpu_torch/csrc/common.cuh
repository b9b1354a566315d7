// Shared skeleton of the brute-force neighbour kernels (nn.cu,
// radius_stats.cu).
//
// One thread owns one source point and keeps its running result in
// registers; the block sweeps the target cloud in tiles staged in shared
// memory as structure-of-arrays f32, every thread reading the same target
// at the same time (a broadcast, no bank conflicts). Each thread writes its
// output once: no atomics and no cross-block reduction, so a launch is
// deterministic. gridDim.y runs over a batch of independent (source,
// target) pairs of equal sizes.
#pragma once

#include <cuda_runtime.h>

#include <cstddef>

namespace mrg {

constexpr int kThreads = 256;  // source points per block
constexpr int kTile = 2048;    // targets per shared-memory tile (24 KB)

// Squared distance from exact coordinate differences, rounded step by step
// as ((dx*dx + dy*dy) + dz*dz). The _rn intrinsics keep nvcc from
// contracting into FMAs, so the plain PyTorch version (three multiplies,
// two adds, in this order) produces the same bits.
__device__ __forceinline__ float sqdist(float sx, float sy, float sz,
                                        float tx, float ty, float tz) {
  const float dx = __fsub_rn(sx, tx);
  const float dy = __fsub_rn(sy, ty);
  const float dz = __fsub_rn(sz, tz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// Stage targets [base, base + len) of an (M, 3) AoS cloud into the tile.
__device__ __forceinline__ void load_tile(const float* __restrict__ tgt,
                                          int base, int len, float* tx,
                                          float* ty, float* tz) {
  for (int k = threadIdx.x; k < len; k += kThreads) {
    const float* p = tgt + 3 * static_cast<size_t>(base + k);
    tx[k] = p[0];
    ty[k] = p[1];
    tz[k] = p[2];
  }
}

inline dim3 grid_for(int batch, int n) {
  return dim3((n + kThreads - 1) / kThreads, batch);
}

}  // namespace mrg

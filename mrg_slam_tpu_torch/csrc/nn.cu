// Exact brute-force 1-nearest neighbour: for every source point, the least
// squared distance to the target cloud and the lowest target index that
// reaches it.
//
// Replaces mrg_slam_tpu/ops/pallas_nn.py:_nn_kernel (called through
// _nn_call / nearest_neighbor_pallas). The Pallas kernel swept target
// chunks along a sequential grid axis and kept the running (min, argmin)
// in a revisited output block; here the sweep is a loop inside the block
// and the running pair lives in registers (common.cuh).
//
// What bounds it on an H100: FP32 instructions. 8192 points of 12 B are
// ~100 KB in and 64 KB out, nothing for HBM; the work is ~9 FP32 operations
// per pair (3 sub, 3 mul, 2 add, 1 compare) over N*M pairs, 67 M pairs per
// odometry iteration. The design keeps every operand in registers or
// shared memory, so the loop issues only those operations plus one
// broadcast shared load per coordinate. One thread per source point gives
// 32 blocks at N = 8192, which leaves most SMs idle; splitting the target
// sweep across blocks is later work.
//
// Semantics (pallas_nn.py:57-72, 105-131): ties go to the lowest index,
// since targets are scanned in ascending order and the update is a strict
// `<`. Masked targets arrive already moved to PAD_VALUE (1e6) by the
// wrapper; a least distance above 1e11 can only come from such a pad and is
// written as +inf.
#include <cmath>

#include "common.cuh"

namespace {

__global__ void __launch_bounds__(mrg::kThreads)
    nn_kernel(const float* __restrict__ src, const float* __restrict__ tgt,
              int n, int m, float* __restrict__ d2_out,
              int* __restrict__ idx_out) {
  __shared__ float tx[mrg::kTile];
  __shared__ float ty[mrg::kTile];
  __shared__ float tz[mrg::kTile];
  const size_t b = blockIdx.y;
  src += b * n * 3;
  tgt += b * m * 3;
  const int i = blockIdx.x * mrg::kThreads + threadIdx.x;
  const bool active = i < n;
  float sx = 0.f, sy = 0.f, sz = 0.f;
  if (active) {
    sx = src[3 * i];
    sy = src[3 * i + 1];
    sz = src[3 * i + 2];
  }
  float best = INFINITY;
  int best_j = 0;
  for (int base = 0; base < m; base += mrg::kTile) {
    const int len = min(mrg::kTile, m - base);
    __syncthreads();  // the previous tile is fully read
    mrg::load_tile(tgt, base, len, tx, ty, tz);
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < len; ++k) {
      const float d = mrg::sqdist(sx, sy, sz, tx[k], ty[k], tz[k]);
      if (d < best) {
        best = d;
        best_j = base + k;
      }
    }
  }
  if (active) {
    d2_out[b * n + i] = best > 1e11f ? INFINITY : best;
    idx_out[b * n + i] = best_j;
  }
}

}  // namespace

// src (B, N, 3) and tgt (B, M, 3) contiguous f32 on the device, M >= 1;
// writes d2 (B, N) f32 and idx (B, N) int32. Returns cudaGetLastError().
extern "C" int mrg_nn(const float* src, const float* tgt, int batch, int n,
                      int m, float* d2, int* idx, void* stream) {
  if (batch > 0 && n > 0) {
    nn_kernel<<<mrg::grid_for(batch, n), mrg::kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(src, tgt, n, m, d2, idx);
  }
  return static_cast<int>(cudaGetLastError());
}

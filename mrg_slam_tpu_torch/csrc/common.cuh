// Shared pieces of the brute-force neighbour kernels (nn.cu,
// radius_stats.cu).
//
// count_kernel keeps the first design (kThreads, kTile, load_tile,
// grid_for): one thread owns one source point and keeps its running result
// in registers; the block sweeps the target cloud in tiles staged in
// shared memory as structure-of-arrays f32, every thread reading the same
// target at the same time (a broadcast, no bank conflicts).
//
// nn_kernel and moments_kernel take part only the lanes that are set in
// the row's mask (lane_valid). A block compacts its valid sources
// (stage_sources) and, a window at a time, the valid targets it sweeps
// (stage_valid) into shared memory as float4 (x, y, z, lane), so masked
// lanes cost neither a thread nor a pair, and one 16-byte broadcast load
// serves every source a thread owns.
//
// Every kernel writes each output once, without atomics, so a launch is
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

// Whether lane i of a row of n lanes takes part: i < n and marked valid
// in the mask row (a null mask marks every lane).
__device__ __forceinline__ bool lane_valid(const unsigned char* mask, int i,
                                           int n) {
  return i < n && (mask == nullptr || mask[i] != 0);
}

// Exclusive prefix sum of v over the block (blockDim.x a multiple of 32,
// at most 32 warps); `tmp` holds one int per warp. Every thread must
// call it. Returns the sum of v over the threads before this one and sets
// `total` to the block's sum.
__device__ __forceinline__ int block_exclusive_scan(int v, int* tmp,
                                                    int& total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) tmp[warp] = x;
  __syncthreads();
  int before = 0;
  total = 0;
  for (int k = 0; k < static_cast<int>(blockDim.x >> 5); ++k) {
    const int t = tmp[k];
    if (k < warp) before += t;
    total += t;
  }
  __syncthreads();  // tmp is free again
  return before + x - v;
}

// Stage the valid targets among lanes [base, base + len) of an (M, 3) AoS
// cloud into t[0, count) as (x, y, z, lane bits), in ascending lane order,
// and return count. Warps take 32-lane chunks (coalesced loads); a first
// pass counts each chunk's valid lanes with a ballot, one warp turns the
// counts into offsets, and a second pass writes each valid lane at its
// chunk's offset plus its rank in the ballot. `tmp` holds at least
// ceil(len / 32) + 1 ints. Every thread must call it.
__device__ __forceinline__ int stage_valid(const float* __restrict__ tgt,
                                           const unsigned char* mask, int m,
                                           int base, int len, float4* t,
                                           int* tmp) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int chunks = (len + 31) >> 5;
  const int end = base + len;
#pragma unroll 4
  for (int c = warp; c < chunks; c += warps) {
    const int i = base + 32 * c + lane;
    const unsigned v = __ballot_sync(0xffffffffu,
                                     i < end && lane_valid(mask, i, m));
    if (lane == 0) tmp[c] = __popc(v);
  }
  __syncthreads();
  if (warp == 0) {  // exclusive offsets of the chunks, 32 at a time
    int carry = 0;
    for (int c0 = 0; c0 < chunks; c0 += 32) {
      const int c = c0 + lane;
      const int x = c < chunks ? tmp[c] : 0;
      int sum = x;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, sum, o);
        if (lane >= o) sum += y;
      }
      if (c < chunks) tmp[c] = carry + sum - x;
      carry += __shfl_sync(0xffffffffu, sum, 31);
    }
    if (lane == 0) tmp[chunks] = carry;
  }
  __syncthreads();
#pragma unroll 4
  for (int c = warp; c < chunks; c += warps) {
    const int i = base + 32 * c + lane;
    const bool in = i < end;
    const bool ok = in && lane_valid(mask, i, m);
    const unsigned v = __ballot_sync(0xffffffffu, ok);
    float x = 0.f, y = 0.f, z = 0.f;
    if (in) {  // loaded whether valid or not, so loads can overlap
      const float* p = tgt + 3 * static_cast<size_t>(i);
      x = p[0];
      y = p[1];
      z = p[2];
    }
    if (ok) {
      t[tmp[c] + __popc(v & ((1u << lane) - 1u))] =
          make_float4(x, y, z, __int_as_float(i));
    }
  }
  const int count = tmp[chunks];
  __syncthreads();  // the tile is complete and tmp is free again
  return count;
}

// Stage the valid sources among the kPer * blockDim.x lanes from `first`
// of an (N, 3) AoS cloud into s[0, count) as (x, y, z, lane bits) and
// return count; thread k offers lanes first + kPer * k + u, u < kPer.
template <int kPer>
__device__ __forceinline__ int stage_sources(const float* __restrict__ src,
                                             const unsigned char* mask, int n,
                                             int first, float4* s, int* tmp) {
  const int lane0 = first + kPer * static_cast<int>(threadIdx.x);
  int mine = 0;
#pragma unroll
  for (int u = 0; u < kPer; ++u) mine += lane_valid(mask, lane0 + u, n);
  int count;
  int at = block_exclusive_scan(mine, tmp, count);
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int i = lane0 + u;
    if (lane_valid(mask, i, n)) {
      const float* p = src + 3 * static_cast<size_t>(i);
      s[at++] = make_float4(p[0], p[1], p[2], __int_as_float(i));
    }
  }
  __syncthreads();
  return count;
}

}  // namespace mrg

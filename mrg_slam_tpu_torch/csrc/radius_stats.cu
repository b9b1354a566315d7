// Radius-gated neighbourhood statistics: neighbour counts (RADIUS outlier
// removal) and raw neighbourhood moments (GICP covariances).
//
// Replaces mrg_slam_tpu/ops/pallas_stats.py:_count_kernel (through
// _count_call / radius_count_pallas) and :_moments_kernel (through
// _moments_call / radius_moments_pallas). The Pallas kernels accumulated
// into an output block revisited along a sequential target-chunk grid
// axis; here the accumulators are registers of the thread that owns the
// source point, and the block loops over shared-memory target tiles
// (common.cuh).
//
// What bounds them on an H100: FP32 instructions, as for nn.cu. The
// distance test costs ~9 FP32 operations per pair; count adds ~2
// (second compare, increment) and moments adds ~16 more per pair that lies
// inside the radius (count, 3 sums, 6 products, 6 sums). The inputs
// (8192 x 12 B) and outputs (8192 x 4 B or x 40 B) are negligible against
// HBM. The design keeps all accumulators in registers and branches on the
// radius test, so pairs outside the radius, the vast majority at r ~ 0.5 m,
// cost only the distance test.
//
// Semantics (pallas_stats.py:41, 100, 161-170):
//  - count: a target counts when 0 < d2 <= r2, which excludes the point
//    itself AND exact duplicates of it;
//  - moments: every target with d2 <= r2 counts, the point itself
//    included; the sums are RAW (not centred), and the wrapper forms
//    cov = M2/n - mean mean^T exactly as the reference does.
// Masked targets arrive at PAD_VALUE (1e6) and lie outside any radius of a
// real point.
#include "common.cuh"

namespace {

__global__ void __launch_bounds__(mrg::kThreads)
    count_kernel(const float* __restrict__ src, const float* __restrict__ tgt,
                 int n, int m, float r2, int* __restrict__ out) {
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
  int count = 0;
  for (int base = 0; base < m; base += mrg::kTile) {
    const int len = min(mrg::kTile, m - base);
    __syncthreads();
    mrg::load_tile(tgt, base, len, tx, ty, tz);
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < len; ++k) {
      const float d = mrg::sqdist(sx, sy, sz, tx[k], ty[k], tz[k]);
      count += (d <= r2) & (d > 0.f);
    }
  }
  if (active) out[b * n + i] = count;
}

// out lanes: [count, sx, sy, sz, xx, xy, xz, yy, yz, zz]
constexpr int kMomentLanes = 10;

__global__ void __launch_bounds__(mrg::kThreads)
    moments_kernel(const float* __restrict__ src,
                   const float* __restrict__ tgt, int n, int m, float r2,
                   float* __restrict__ out) {
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
  float c = 0.f, ax = 0.f, ay = 0.f, az = 0.f;
  float axx = 0.f, axy = 0.f, axz = 0.f, ayy = 0.f, ayz = 0.f, azz = 0.f;
  for (int base = 0; base < m; base += mrg::kTile) {
    const int len = min(mrg::kTile, m - base);
    __syncthreads();
    mrg::load_tile(tgt, base, len, tx, ty, tz);
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < len; ++k) {
      const float x = tx[k], y = ty[k], z = tz[k];
      if (mrg::sqdist(sx, sy, sz, x, y, z) <= r2) {
        c += 1.f;
        ax += x;
        ay += y;
        az += z;
        axx += x * x;
        axy += x * y;
        axz += x * z;
        ayy += y * y;
        ayz += y * z;
        azz += z * z;
      }
    }
  }
  if (active) {
    float* o = out + (b * n + i) * kMomentLanes;
    o[0] = c;
    o[1] = ax;
    o[2] = ay;
    o[3] = az;
    o[4] = axx;
    o[5] = axy;
    o[6] = axz;
    o[7] = ayy;
    o[8] = ayz;
    o[9] = azz;
  }
}

}  // namespace

// points (B, N, 3) sources and (B, M, 3) targets, contiguous f32 on the
// device; r2 = radius^2 rounded to f32. Each returns cudaGetLastError().
extern "C" int mrg_radius_count(const float* src, const float* tgt, int batch,
                                int n, int m, float r2, int* out,
                                void* stream) {
  if (batch > 0 && n > 0) {
    count_kernel<<<mrg::grid_for(batch, n), mrg::kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(src, tgt, n, m, r2,
                                                         out);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mrg_radius_moments(const float* src, const float* tgt,
                                  int batch, int n, int m, float r2,
                                  float* out, void* stream) {
  if (batch > 0 && n > 0) {
    moments_kernel<<<mrg::grid_for(batch, n), mrg::kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(src, tgt, n, m, r2,
                                                          out);
  }
  return static_cast<int>(cudaGetLastError());
}

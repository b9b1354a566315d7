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
// HBM. Both keep all accumulators in registers and branch on the radius
// test, so pairs outside the radius, the vast majority at r ~ 0.5 m, cost
// only the distance test.
//
// count_kernel keeps the first design: one thread per source, every lane
// swept, SoA tiles (common.cuh). moments_kernel takes part only the valid
// lanes (set in the row's mask; a null mask: every lane): a block compacts
// its valid sources and, a window at a time, the valid targets into shared
// memory as float4 (common.cuh), and lanes that do not take part get
// zeros. About half of a frame's 8192 lanes are real,
// spread over the row, so this drops ~3/4 of the pairs, and with them the
// pad-by-pad pairs (d2 = 0) that took the accumulate branch. A thread
// holds 1-2 sources, and one broadcast LDS.128 serves both. At B = 32 the
// grid already fills the card (512 blocks of 8 warps), so no split; on an
// H100 256-thread blocks beat 128 (fewer blocks stage the same targets)
// and 4 source slots per thread. Each source still sweeps its targets in
// ascending order in one thread, so the moments of a valid lane are the
// first design's, bit for bit. ptxas (sm_90a): moments_kernel 48
// registers, 41220 bytes of shared memory; count_kernel 32 registers,
// 24576 bytes; no spills.
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
constexpr int kMoThreads = 256;                       // threads per block
constexpr int kMoPerThread = 2;                       // source slots per thread
constexpr int kMoTileSrc = kMoThreads * kMoPerThread;  // source lanes per block
constexpr int kMoTile = 2048;  // target lanes staged at once (32 KB)

// Accumulate the staged targets within the radius of the thread's first
// kU source slots, in ascending target order.
template <int kU>
__device__ __forceinline__ void accumulate(const float4* tile, int len,
                                           const float4* s, float r2,
                                           float (*acc)[kMomentLanes]) {
#pragma unroll 4
  for (int k = 0; k < len; ++k) {
    const float4 t = tile[k];
    const float x = t.x, y = t.y, z = t.z;
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      if (mrg::sqdist(s[u].x, s[u].y, s[u].z, x, y, z) <= r2) {
        // the first design wrote `xx += x * x`, which nvcc contracted
        // into an FMA; spelling the FMA out keeps those bits now that a
        // product may serve two sources
        float* a = acc[u];
        a[0] += 1.f;
        a[1] += x;
        a[2] += y;
        a[3] += z;
        a[4] = __fmaf_rn(x, x, a[4]);
        a[5] = __fmaf_rn(x, y, a[5]);
        a[6] = __fmaf_rn(x, z, a[6]);
        a[7] = __fmaf_rn(y, y, a[7]);
        a[8] = __fmaf_rn(y, z, a[8]);
        a[9] = __fmaf_rn(z, z, a[9]);
      }
    }
  }
}

// accumulate<most>, most = the most source slots any thread of the warp
// holds (warp-uniform, so the warp runs one loop)
template <int kU>
__device__ __forceinline__ void accumulate_upto(int most, const float4* tile,
                                                int len, const float4* s,
                                                float r2,
                                                float (*acc)[kMomentLanes]) {
  if (most == kU) {
    accumulate<kU>(tile, len, s, r2, acc);
  } else if constexpr (kU > 1) {
    accumulate_upto<kU - 1>(most, tile, len, s, r2, acc);
  }
}

__global__ void __launch_bounds__(kMoThreads)
    moments_kernel(const float* __restrict__ src,
                   const float* __restrict__ tgt, int n, int m, float r2,
                   const unsigned char* __restrict__ src_mask,
                   const unsigned char* __restrict__ tgt_mask,
                   float* __restrict__ out) {
  __shared__ float4 tile[kMoTile];
  __shared__ float4 srcs[kMoTileSrc];
  __shared__ int scan_tmp[kMoTile / 32 + 1];  // the staging scans
  const size_t b = blockIdx.y;
  const int first = blockIdx.x * kMoTileSrc;
  src += b * n * 3;
  tgt += b * m * 3;
  if (src_mask != nullptr) src_mask += b * n;
  if (tgt_mask != nullptr) tgt_mask += b * m;
  out += b * n * kMomentLanes;
  // zeros for the block's lanes that do not take part
#pragma unroll
  for (int u = 0; u < kMoPerThread; ++u) {
    const int i = first + threadIdx.x + u * kMoThreads;
    if (i < n && !mrg::lane_valid(src_mask, i, n)) {
#pragma unroll
      for (int l = 0; l < kMomentLanes; ++l) {
        out[static_cast<size_t>(i) * kMomentLanes + l] = 0.f;
      }
    }
  }
  const int n_src = mrg::stage_sources<kMoPerThread>(src, src_mask, n,
                                                     first, srcs, scan_tmp);
  if (n_src == 0) return;
  float4 s[kMoPerThread];
  float acc[kMoPerThread][kMomentLanes] = {};
#pragma unroll
  for (int u = 0; u < kMoPerThread; ++u) {
    s[u] = srcs[threadIdx.x + u * kMoThreads];  // slots past n_src: unused
  }
  // slots threadIdx.x, + kMoThreads, ... below n_src
  const int ahead = n_src - static_cast<int>(threadIdx.x);
  const int held = min(kMoPerThread, (ahead + kMoThreads - 1) / kMoThreads);
  const int most = __reduce_max_sync(0xffffffffu, held);
  for (int base = 0; base < m; base += kMoTile) {
    const int len = min(kMoTile, m - base);
    __syncthreads();  // the previous stage is fully read
    const int k_tgt =
        mrg::stage_valid(tgt, tgt_mask, m, base, len, tile, scan_tmp);
    accumulate_upto<kMoPerThread>(most, tile, k_tgt, s, r2, acc);
  }
#pragma unroll
  for (int u = 0; u < kMoPerThread; ++u) {
    const int slot = threadIdx.x + u * kMoThreads;
    if (slot < n_src) {
      float* o = out + static_cast<size_t>(__float_as_int(srcs[slot].w)) *
                           kMomentLanes;
#pragma unroll
      for (int l = 0; l < kMomentLanes; ++l) o[l] = acc[u][l];
    }
  }
}

}  // namespace

// points (B, N, 3) sources and (B, M, 3) targets, contiguous f32 on the
// device; r2 = radius^2 rounded to f32; for moments, src_mask (B, N) and
// tgt_mask (B, M) bool on the device, each null for every lane. Each
// returns cudaGetLastError().
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
                                  const unsigned char* src_mask,
                                  const unsigned char* tgt_mask, float* out,
                                  void* stream) {
  if (batch > 0 && n > 0) {
    const dim3 grid((n + kMoTileSrc - 1) / kMoTileSrc, batch);
    moments_kernel<<<grid, kMoThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        src, tgt, n, m, r2, src_mask, tgt_mask, out);
  }
  return static_cast<int>(cudaGetLastError());
}

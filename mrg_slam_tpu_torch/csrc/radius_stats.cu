// Radius-gated neighbourhood statistics: neighbour counts (RADIUS outlier
// removal) and raw neighbourhood moments (GICP covariances).
//
// Replaces mrg_slam_tpu/ops/pallas_stats.py:_count_kernel (through
// _count_call / radius_count_pallas) and :_moments_kernel (through
// _moments_call / radius_moments_pallas). The Pallas kernels swept every
// (source, target) pair, accumulating into an output block revisited
// along a sequential target-chunk grid axis.
//
// Semantics (pallas_stats.py:41, 100, 161-170):
//  - count: a point counts the other valid points of its row with
//    0 < d2 <= r2, which excludes the point itself AND exact duplicates of
//    it; a masked lane takes no part and gets 0;
//  - moments: every target with d2 <= r2 counts, the point itself
//    included; the sums are RAW (not centred), and the wrapper forms
//    cov = M2/n - mean mean^T exactly as the reference does.
//
// count_kernel: an exact cell-binned search. On the front end's path it
// runs on the voxel grid's output, (32, 8192) with every lane valid and
// ~1.5 neighbours within 0.5 m per point, so a sweep of all pairs tests
// ~99.98 % pairs that cannot count. Each block bins its row's valid
// points into cubic cells of side c >= r in shared memory (global memory
// for rows too long for it; see Where the bins live) (a hashed counting
// sort: a histogram of H buckets with shared atomics, a block
// scan, a scatter of float4 (x, y, z, lane)), then answers the points of
// its 1/S of the buckets, in bucket order so that the threads of a warp
// look at the same cells. A point tests only the points of the 27 cells
// around its own with mrg::sqdist and 0 < d2 <= r2, exactly the test of
// the sweep. The grid is (S, B): every block bins the whole row and
// S x B blocks fill the card once (one 197 KB block per SM; S = 4 at
// B = 32). Bytes (~1.3 us at B = 32) and FP32 operations (~0.1 us) bound
// it far below the ~31 us a launch takes on an H100 SXM; timed once by S
// (PERF.md), the binning, two passes over the row with global loads and
// shared atomics, takes ~3/4 of that.
// ptxas (sm_90a): count_kernel<false> and <true> 32 registers, 144 bytes
// of static shared memory, no spills.
//
// Cells. Python (stats_kernel.count_cell) gives c = max(sqrt(r2), 2^-60)
// (1 + 2^-10) and inv_c = 1/c, both rounded to float64; a coordinate v
// lies in cell floor(v (x) inv_c), the float64 product of the exact
// float64 value of v, converted with saturation to int32.
// Claim: if points a, b (finite float32) have d2 <= r2, as mrg::sqdist
// rounds it, their cells differ by at most one on every axis, whatever
// their coordinates. Proof, on one axis with x = a_i, y = b_i,
// u = 2^-24, e = 2^-53:
//  1. Every term of d2 is >= 0, so each of its five roundings shrinks it
//     by at most a factor (1 - u): (x - y)^2 (1 - u)^5 <= d2 <= r2, and
//     |x - y| <= sqrt(r2) (1 + 3u). (If dx^2 underflows, |x - y| < 2^-62,
//     below c as well.) c went through two float64 roundings, so
//     |x - y| <= c (1 + 3u)(1 + 2e) / (1 + 2^-10) < c.
//  2. If x == y the cells are equal. Else let |y| <= |x|. If y is 0 or
//     its sign differs, or |y| <= |x| / 2, then |x - y| >= |x| / 2. Else x
//     and y share their sign and x is a multiple of ulp(y) > 2^-25 |x|, so
//     |x - y| >= ulp(y). Either way |x|, |y| < 2^25 |x - y| < 2^25 c.
//  3. inv_c = (1 + e0) / c and t_v = v (x) inv_c = v inv_c (1 + e_v),
//     |e0|, |e_v| <= e. So |t_x - t_y| <= |x - y| (1 + e) / c +
//     (|x| + |y|) (1 + e) e / c < (1 + 3u)(1 + 4e) / (1 + 2^-10) + 2^-26
//     < 1 - 2^-11 + 2^-26 < 1, and floor(t_x), floor(t_y) differ by at
//     most one. |t| < 2^26 here, so the int32 conversion saturates
//     neither value.
// So a point's neighbours lie in the 27 cells around its own, for every
// finite coordinate (no limit: PAD_VALUE's 1e6 included). NaN and
// infinite coordinates land in some cell and never pass the d2 test, as
// in the sweep. With float32 products instead, step 3 would hold only for
// |coordinates| below ~2^13 c (~4 km at r = 0.5 m).
//
// Buckets. A cell (i, j, k) goes to bucket (i + j P2 + k P3) mod H, in
// wrapping 32-bit arithmetic, H a power of two >= 64. The hash is linear,
// so the 27 cells around a point are 9 runs of 3 consecutive buckets,
// (h0 + dj P2 + dk P3 - 1 ... + 1) mod H, and their 27 buckets differ:
// P2 = 3 and P3 = 9 (mod 64), so the offsets dx + 3 dy + 9 dz are
// -13..13 mod 64 (static_assert below), distinct mod 64 and hence mod
// every H >= 64. A point lies in one bucket, so it is tested at most once
// per source; a bucket may also hold points of other cells (collisions),
// which the exact d2 test counts only if they are neighbours, and every
// neighbour is in a bucket visited. Hence every count equals the sweep's,
// with no check of a candidate's own cell. Within a bucket the order
// of points follows the atomics and changes from run to run; the counts
// are integers and do not. H >= 2 N (`stats_kernel.count_hash_bits`).
//
// Where the bins live. A row's bins take bins_bytes = 16 N + 4 (H + 1)
// bytes, rounded up to 16 (N = 8192: H = 16384, 196624 B). Where that
// fits in a block's dynamic shared memory (the device's opt-in limit less
// the kernel's static shared memory, queried once per device), the bins
// are there (count_kernel<false>): rows of up to 8192 lanes on an H100.
// A longer row (the port's default capacity is 32768) bins into the
// block's own slice of a global scratch buffer that the wrapper
// allocates (count_kernel<true>, the same code on another address space),
// so every row length runs on the card; the atomics and scattered loads
// then go through L2. Degenerate rows are right and slow: N points in one
// cell cost N^2 tests.
//
// moments_kernel: FP32 instructions bound it, as for nn.cu. The distance
// test costs ~9 FP32 operations per pair and moments adds ~16 more per
// pair that lies inside the radius (count, 3 sums, 6 products, 6 sums).
// It takes part only the valid lanes (set in the row's mask; a null mask:
// every lane): a block compacts its valid sources and, a window at a
// time, the valid targets into shared memory as float4 (common.cuh), and
// lanes that do not take part get zeros. About half of a frame's 8192
// lanes are real, spread over the row, so this drops ~3/4 of the pairs,
// and with them the pad-by-pad pairs (d2 = 0) that took the accumulate
// branch. A thread holds 1-2 sources, and one broadcast LDS.128 serves
// both. At B = 32 the grid already fills the card (512 blocks of 8
// warps), so no split; on an H100 256-thread blocks beat 128 (fewer
// blocks stage the same targets) and 4 source slots per thread. Each
// source sweeps its targets in ascending order in one thread, so the
// moments of a valid lane are bit for bit those of the first design.
// ptxas (sm_90a): moments_kernel 48 registers, 41232 bytes of shared
// memory; no spills.
#include "common.cuh"

namespace {

constexpr int kCoThreads = 1024;  // threads per count block
constexpr int kMinHashBits = 6;   // H >= 64: the stencil's buckets differ
constexpr int kMaxHashBits = 24;  // rows of at most 2^23 lanes
constexpr unsigned kP2 = 0x9E3779C3u;  // bucket strides of cells along y
constexpr unsigned kP3 = 0x85EBCA49u;  // and z; along x the stride is 1

__host__ __device__ constexpr unsigned stencil_offset(int dx, int dy,
                                                      int dz) {
  return static_cast<unsigned>(dx) + static_cast<unsigned>(dy) * kP2 +
         static_cast<unsigned>(dz) * kP3;
}

constexpr bool stencil_buckets_differ() {
  unsigned v[27] = {};
  int k = 0;
  for (int dz = -1; dz <= 1; ++dz)
    for (int dy = -1; dy <= 1; ++dy)
      for (int dx = -1; dx <= 1; ++dx)
        v[k++] = stencil_offset(dx, dy, dz) & ((1u << kMinHashBits) - 1u);
  for (int i = 0; i < 27; ++i)
    for (int j = i + 1; j < 27; ++j)
      if (v[i] == v[j]) return false;
  return true;
}
static_assert(stencil_buckets_differ(),
              "the 27 cells around a point must go to 27 buckets");

// The unmasked bucket of the cell of (x, y, z) (see Cells, Buckets).
__device__ __forceinline__ unsigned cell_hash(float x, float y, float z,
                                              double inv_c) {
  const int i = __double2int_rd(__dmul_rn(static_cast<double>(x), inv_c));
  const int j = __double2int_rd(__dmul_rn(static_cast<double>(y), inv_c));
  const int k = __double2int_rd(__dmul_rn(static_cast<double>(z), inv_c));
  return static_cast<unsigned>(i) + static_cast<unsigned>(j) * kP2 +
         static_cast<unsigned>(k) * kP3;
}

// #points of pts[a, e) with 0 < d2 <= r2 from s
__device__ __forceinline__ int count_run(const float4* pts, int a, int e,
                                         const float4& s, float r2) {
  int c = 0;
  for (int k = a; k < e; ++k) {
    const float4 t = pts[k];
    const float d = mrg::sqdist(s.x, s.y, s.z, t.x, t.y, t.z);
    c += (d <= r2) & (d > 0.f);
  }
  return c;
}

// The bins of a row (see Where the bins live): binned[n] float4, then
// ints: end[-1] = 0, end[0, H) (bucket h holds binned[end[h - 1], end[h])).
__host__ __device__ constexpr size_t bins_bytes(int n, int hash_bits) {
  return (16 * static_cast<size_t>(n) +
          4 * ((static_cast<size_t>(1) << hash_bits) + 1) + 15) /
         16 * 16;
}

// kGlobalBins: the bins lie in `scratch`, bins_bytes per block, blocks in
// (blockIdx.y, blockIdx.x) order; else in dynamic shared memory.
template <bool kGlobalBins>
__global__ void __launch_bounds__(kCoThreads)
    count_kernel(const float* __restrict__ pts,
                 const unsigned char* __restrict__ mask, int n,
                 int hash_bits, double inv_c, float r2,
                 float4* __restrict__ scratch, int* __restrict__ out) {
  extern __shared__ float4 shared_bins[];
  __shared__ int scan_tmp[kCoThreads / 32 + 1];
  float4* binned = shared_bins;
  if constexpr (kGlobalBins) {
    binned = scratch + (static_cast<size_t>(blockIdx.y) * gridDim.x +
                        blockIdx.x) *
                           (bins_bytes(n, hash_bits) / 16);
  }
  int* end = reinterpret_cast<int*>(binned + n) + 1;
  const int nb = 1 << hash_bits;
  const unsigned hmask = static_cast<unsigned>(nb) - 1u;
  const size_t b = blockIdx.y;
  pts += b * n * 3;
  if (mask != nullptr) mask += b * n;
  out += b * n;
  const int split = gridDim.x, part = blockIdx.x;

  for (int h = threadIdx.x; h < nb; h += blockDim.x) end[h] = 0;
  if (threadIdx.x == 0) end[-1] = 0;
  // zeros for the masked lanes of this block's share of the row
  for (int i = n * part / split + threadIdx.x; i < n * (part + 1) / split;
       i += blockDim.x) {
    if (!mrg::lane_valid(mask, i, n)) out[i] = 0;
  }
  __syncthreads();
  // 1. the histogram of buckets
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    if (mrg::lane_valid(mask, i, n)) {
      const float* p = pts + 3 * static_cast<size_t>(i);
      atomicAdd(&end[cell_hash(p[0], p[1], p[2], inv_c) & hmask], 1);
    }
  }
  __syncthreads();
  // 2. bucket starts
  mrg::block_scan_inplace(end, nb, scan_tmp);
  // 3. the scatter: each bucket's cursor runs from its start to its end
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    if (mrg::lane_valid(mask, i, n)) {
      const float* p = pts + 3 * static_cast<size_t>(i);
      const float x = p[0], y = p[1], z = p[2];
      const int at = atomicAdd(&end[cell_hash(x, y, z, inv_c) & hmask], 1);
      binned[at] = make_float4(x, y, z, __int_as_float(i));
    }
  }
  __syncthreads();
  // 4. the points of the block's share of the buckets, in bucket order
  // (every block orders a bucket's points its own way, so the shares are
  // cut between buckets)
  for (int q = end[nb * part / split - 1] + threadIdx.x;
       q < end[nb * (part + 1) / split - 1]; q += blockDim.x) {
    const float4 s = binned[q];
    const unsigned h0 = cell_hash(s.x, s.y, s.z, inv_c);
    int count = 0;
#pragma unroll
    for (int dz = -1; dz <= 1; ++dz) {
#pragma unroll
      for (int dy = -1; dy <= 1; ++dy) {
        // buckets lo, lo + 1, lo + 2 (mod H): cells dx = -1, 0, 1
        const int lo =
            static_cast<int>((h0 + stencil_offset(-1, dy, dz)) & hmask);
        if (lo + 3 <= nb) {
          count += count_run(binned, end[lo - 1], end[lo + 2], s, r2);
        } else {  // the run wraps past bucket H - 1
          for (int k = 0; k < 3; ++k) {
            const int h = (lo + k) & static_cast<int>(hmask);
            count += count_run(binned, end[h - 1], end[h], s, r2);
          }
        }
      }
    }
    out[__float_as_int(s.w)] = count;
  }
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

// The most dynamic shared memory count_kernel<false> can take on the
// current device: the opt-in limit less its static shared memory. The
// kernel's attribute is raised to it at the first call on each device.
cudaError_t count_shared_limit(size_t* most) {
  static size_t most_on[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (most_on[dev] == 0) {
    int optin = 0;
    e = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e != cudaSuccess) return e;
    cudaFuncAttributes attr;
    e = cudaFuncGetAttributes(&attr, count_kernel<false>);
    if (e != cudaSuccess) return e;
    const int dyn = optin - static_cast<int>(attr.sharedSizeBytes);
    e = cudaFuncSetAttribute(count_kernel<false>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             dyn);
    if (e != cudaSuccess) return e;
    most_on[dev] = static_cast<size_t>(dyn);
  }
  *most = most_on[dev];
  return cudaSuccess;
}

bool count_args_ok(int hash_bits, int split) {
  return hash_bits >= kMinHashBits && hash_bits <= kMaxHashBits &&
         split >= 1;
}

}  // namespace

// count: points (B, N, 3), contiguous f32 on the device; mask (B, N)
// bool on the device, null for every lane; H = 2^hash_bits buckets
// (kMinHashBits <= hash_bits <= kMaxHashBits); inv_c = 1/c (see Cells);
// r2 = radius^2 rounded to f32; split = S blocks per row; scratch: null,
// or the global buffer of mrg_radius_count_scratch's size; out (B, N)
// int32.
// count_scratch: sets *bytes to the size of the scratch buffer count
// needs for these arguments on the current device: 0 where a row's bins
// fit in a block's shared memory, else B S bins_bytes.
// moments: points (B, N, 3) sources and (B, M, 3) targets, contiguous f32
// on the device; r2 as above; src_mask (B, N) and tgt_mask (B, M) bool on
// the device, each null for every lane; out (B, N, 10) f32.
// Each returns a cudaError_t: cudaGetLastError() after a launch, or
// cudaErrorInvalidValue for arguments the kernel does not take.
extern "C" int mrg_radius_count_scratch(int batch, int n, int hash_bits,
                                        int split, size_t* bytes) {
  *bytes = 0;
  if (batch <= 0 || n <= 0) return static_cast<int>(cudaSuccess);
  if (!count_args_ok(hash_bits, split)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  size_t most = 0;
  const cudaError_t e = count_shared_limit(&most);
  if (e != cudaSuccess) return static_cast<int>(e);
  const size_t bins = bins_bytes(n, hash_bits);
  if (bins > most) {
    *bytes = static_cast<size_t>(batch) * static_cast<size_t>(split) * bins;
  }
  return static_cast<int>(cudaSuccess);
}

extern "C" int mrg_radius_count(const float* pts, const unsigned char* mask,
                                int batch, int n, int hash_bits, double inv_c,
                                float r2, int split, void* scratch, int* out,
                                void* stream) {
  if (batch <= 0 || n <= 0) return static_cast<int>(cudaGetLastError());
  if (!count_args_ok(hash_bits, split)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(split, batch);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (scratch != nullptr) {
    count_kernel<true><<<grid, kCoThreads, 0, st>>>(
        pts, mask, n, hash_bits, inv_c, r2, static_cast<float4*>(scratch),
        out);
  } else {
    size_t most = 0;
    const cudaError_t e = count_shared_limit(&most);
    if (e != cudaSuccess) return static_cast<int>(e);
    const size_t bins = bins_bytes(n, hash_bits);
    if (bins > most) return static_cast<int>(cudaErrorInvalidValue);
    count_kernel<false><<<grid, kCoThreads, bins, st>>>(
        pts, mask, n, hash_bits, inv_c, r2, nullptr, out);
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

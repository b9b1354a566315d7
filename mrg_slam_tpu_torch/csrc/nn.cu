// Exact brute-force 1-nearest neighbour: for every source point, the least
// squared distance to the target cloud and the lowest target index that
// reaches it.
//
// Replaces mrg_slam_tpu/ops/pallas_nn.py:_nn_kernel (called through
// _nn_call / nearest_neighbor_pallas). The Pallas kernel swept target
// chunks along a sequential grid axis and kept the running (min, argmin)
// in a revisited output block. Here a thread-block cluster splits the
// sweep: its kSplit blocks share one tile of source lanes, each sweeps its
// own contiguous share of the target lanes, and the cluster combines the
// partial results through distributed shared memory.
//
// What bounds it on an H100: FP32 instructions. 8192 points of 12 B are
// ~100 KB in and 96 KB out, nothing for HBM; the work is ~9 FP32
// operations per pair (3 sub, 3 mul, 2 add, 1 compare). The odometry calls
// it once per Gauss-Newton iteration with B = 1 and N = M = 8192 lanes, of
// which ~3800-4000 are real, spread over the whole row: the voxel grid
// fills every lane and the RADIUS filter masks about half of them in
// place. So the design is about filling 132 SMs with little work and
// spending it only on real pairs:
//  - valid lanes only: a lane takes part when its mask byte is set
//    (src_mask, tgt_mask; null: every lane). A block compacts its valid
//    sources and the valid targets of its share into shared memory
//    (common.cuh), so masked lanes cost neither a thread nor a pair, and a
//    cluster whose source lanes are all masked leaves at once;
//  - occupancy: a cluster owns 256 source lanes and splits the targets 8
//    ways, so 8192 lanes give 256 blocks of 4 warps, ~2 per SM. On an H100
//    this beat 128-lane clusters (512 blocks of 2 warps), 4-way splits and
//    4 source slots per thread;
//  - reuse: each thread keeps its 1-2 sources in registers and each
//    target is staged once per block as a float4 (x, y, z, lane), so one
//    broadcast LDS.128 serves every source of the thread (the first
//    design paid 3 scalar loads for each pair).
// On an H100 at the odometry's shape the sweep of ~15 M real pairs takes
// most of the kernel's time, the staging and the cluster the rest, and
// splitting each source's running minimum into interleaved chains did not
// speed the sweep up.
// ptxas (sm_90a): 56 registers, 22660 bytes of shared memory, no spills.
// No tensor cores: the function is exact f32 coordinate differences; the
// |s|^2 + |t|^2 - 2 s.t form that a matrix unit computes is inexact, and
// TF32 is off in the port. A cp.async or TMA stage of the targets was not
// tried: a block stages at most ~16 KB, once.
//
// Semantics (pallas_nn.py:57-72, 105-131): ties go to the lowest index.
// Within a block the valid targets are staged and scanned in ascending
// lane order with a strict `<`; the blocks' shares are contiguous and
// ascending in cluster rank, and the combine reads them in rank order with
// a strict `<`, so the result is the same (d2, idx) as one ascending
// sweep, bit for bit. A target that does not take part changes nothing
// (the Pallas kernel sees it at PAD_VALUE, 1e6, where it never wins); a
// least distance above 1e11 is written as +inf. A source lane that does
// not take part gets (inf, 0), as does every lane of a row with no valid
// target.
#include <cooperative_groups.h>

#include <cmath>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;                    // threads per block
constexpr int kPerThread = 2;                    // source slots per thread
constexpr int kTileSrc = kThreads * kPerThread;  // source lanes per cluster
constexpr int kSplit = 8;                        // blocks per cluster
constexpr int kCombine = kTileSrc / kSplit;      // slots each rank combines
constexpr int kTile = 1024;  // target lanes staged at once (16 KB)
static_assert(kTileSrc % kSplit == 0 && kCombine <= kThreads, "combine");

// Sweep the staged targets for the thread's first kU source slots.
template <int kU>
__device__ __forceinline__ void sweep(const float4* tile, int len,
                                      const float4* s, float* best,
                                      int* best_j) {
#pragma unroll 8
  for (int k = 0; k < len; ++k) {
    const float4 t = tile[k];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const float d = mrg::sqdist(s[u].x, s[u].y, s[u].z, t.x, t.y, t.z);
      if (d < best[u]) {
        best[u] = d;
        best_j[u] = __float_as_int(t.w);
      }
    }
  }
}

// sweep<most>, most = the most source slots any thread of the warp holds
// (warp-uniform, so the warp runs one loop)
template <int kU>
__device__ __forceinline__ void sweep_upto(int most, const float4* tile,
                                           int len, const float4* s,
                                           float* best, int* best_j) {
  if (most == kU) {
    sweep<kU>(tile, len, s, best, best_j);
  } else if constexpr (kU > 1) {
    sweep_upto<kU - 1>(most, tile, len, s, best, best_j);
  }
}

__global__ void __cluster_dims__(kSplit, 1, 1) __launch_bounds__(kThreads)
    nn_kernel(const float* __restrict__ src, const float* __restrict__ tgt,
              int n, int m, const unsigned char* __restrict__ src_mask,
              const unsigned char* __restrict__ tgt_mask,
              float* __restrict__ d2_out, long long* __restrict__ idx_out) {
  __shared__ float4 tile[kTile];
  __shared__ float4 srcs[kTileSrc];
  __shared__ float part_d[kTileSrc];
  __shared__ int part_j[kTileSrc];
  __shared__ int scan_tmp[kTile / 32 + 1];  // the staging scans
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const size_t b = blockIdx.y;
  const int first = (blockIdx.x / kSplit) * kTileSrc;
  src += b * n * 3;
  tgt += b * m * 3;
  if (src_mask != nullptr) src_mask += b * n;
  if (tgt_mask != nullptr) tgt_mask += b * m;
  d2_out += b * n;
  idx_out += b * n;
  // rank r writes the fixed result of the lanes [r * kCombine, (r + 1) *
  // kCombine) of the tile that do not take part
  const int own = first + rank * kCombine + threadIdx.x;
  const bool own_fixed = threadIdx.x < kCombine && own < n &&
                         !mrg::lane_valid(src_mask, own, n);
  auto write_fixed = [&]() {
    if (own_fixed) {
      d2_out[own] = INFINITY;
      idx_out[own] = 0;
    }
  };
  // every block of the cluster compacts the same valid sources in the
  // same order, so a slot names the same source in all of them
  const int n_src = mrg::stage_sources<kPerThread>(src, src_mask, n, first,
                                                   srcs, scan_tmp);
  if (n_src == 0) {
    // the same in every block of the cluster: no block reads another's
    // shared memory, so each writes its share and leaves
    write_fixed();
    return;
  }
  float4 s[kPerThread];
  float best[kPerThread];
  int best_j[kPerThread];
#pragma unroll
  for (int u = 0; u < kPerThread; ++u) {
    s[u] = srcs[threadIdx.x + u * kThreads];  // slots past n_src: unused
    best[u] = INFINITY;
    best_j[u] = 0;
  }
  // slots threadIdx.x, + kThreads, ... below n_src
  const int ahead = n_src - static_cast<int>(threadIdx.x);
  const int held = min(kPerThread, (ahead + kThreads - 1) / kThreads);
  const int most = __reduce_max_sync(0xffffffffu, held);
  // this block's share of the target lanes [0, m): contiguous, ascending
  // in rank
  const int share = (m + kSplit - 1) / kSplit;
  const int lo = min(rank * share, m);
  const int hi = min(lo + share, m);
  for (int base = lo; base < hi; base += kTile) {
    const int len = min(kTile, hi - base);
    __syncthreads();  // the previous stage is fully read
    const int k_tgt =
        mrg::stage_valid(tgt, tgt_mask, m, base, len, tile, scan_tmp);
    sweep_upto<kPerThread>(most, tile, k_tgt, s, best, best_j);
  }
#pragma unroll
  for (int u = 0; u < kPerThread; ++u) {
    part_d[threadIdx.x + u * kThreads] = best[u];
    part_j[threadIdx.x + u * kThreads] = best_j[u];
  }
  cluster.sync();  // every block's partials are written and visible
  write_fixed();
  const int slot = rank * kCombine + threadIdx.x;
  if (threadIdx.x < kCombine && slot < n_src) {
    // rank r combines slots [r * kCombine, (r + 1) * kCombine) over all
    // ranks, in ascending rank order
    float d = INFINITY;
    int j = 0;
    for (int r = 0; r < kSplit; ++r) {
      const float dr = cluster.map_shared_rank(part_d, r)[slot];
      if (dr < d) {
        d = dr;
        j = cluster.map_shared_rank(part_j, r)[slot];
      }
    }
    const int i = __float_as_int(srcs[slot].w);
    d2_out[i] = d > 1e11f ? INFINITY : d;
    idx_out[i] = j;
  }
  cluster.sync();  // no block leaves while another still reads its partials
}

}  // namespace

// src (B, N, 3) and tgt (B, M, 3) contiguous f32 on the device, M >= 1;
// src_mask (B, N) and tgt_mask (B, M) bool on the device, each null for
// every lane;
// writes d2 (B, N) f32 and idx (B, N) int64. Returns cudaGetLastError().
extern "C" int mrg_nn(const float* src, const float* tgt, int batch, int n,
                      int m, const unsigned char* src_mask,
                      const unsigned char* tgt_mask, float* d2,
                      long long* idx, void* stream) {
  if (batch > 0 && n > 0) {
    const dim3 grid(kSplit * ((n + kTileSrc - 1) / kTileSrc), batch);
    nn_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        src, tgt, n, m, src_mask, tgt_mask, d2, idx);
  }
  return static_cast<int>(cudaGetLastError());
}

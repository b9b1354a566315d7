// One dense Levenberg-Marquardt iteration of an SE(3) pose graph, in three
// kernels around the library's Cholesky: linearize, assemble, trial.
//
// Replaces no TPU kernel: the JAX package runs this loop as one XLA
// program, and the port's op path (graph/solve.py: linearize ->
// assemble_dense -> dense_delta -> _retract_all -> _lm_schedule) issued
// ~1100 small PyTorch ops an iteration, each a launch of ~2 us of card
// time behind ~25 us of host dispatch. The benchmark's tick layer was
// bound by those launches, not by the card (PERF.md). These kernels do
// the same mathematics in three launches; the D x D Cholesky and its
// solves stay library calls between the second and the third, as XLA's
// are in the JAX package.
//
// What bounds it: latency. At the main path's shapes (N = 128-256 nodes,
// E = 512-1024 edges, D = 6N) the three kernels of an iteration move
// ~1 MB (the per-edge terms, the nonzero 6x6 blocks of H, the edge tables
// twice) and do a few MFLOP, a microsecond of the card's bandwidth and
// rate; a launch and its few dependent steps cost more. So each kernel is
// laid out for few dependent steps, not for throughput:
//  - lm_linearize_kernel: one thread an edge row. It forms the residual
//    log(meas^-1 T_i^-1 T_j) in float32, the Jacobians J_to = Jr^-1(e)
//    and J_from = -Jr^-1(e) Ad(T_j^-1 T_i) in float64, rounded to
//    float32 once (graph/edges.py), the row's own robust kernel by a
//    switch (graph/robust.py's formulas), W = info w mask, and writes the
//    row's three 6x6 products Jf^T W Jf, Jt^T W Jt, Jf^T W Jt, its two
//    gradients Jf^T W r, Jt^T W r and its chi2 term. The fourth product,
//    Jt^T W Jf, is the transpose of the third and is read as such. The
//    buffer is structure-of-arrays, (120, E) floats a graph, so a warp's
//    writes are coalesced. A graph whose last step was rejected keeps its
//    terms: its poses did not move (the `relin` flag).
//  - lm_assemble_kernel: one block a nonzero 6x6 block of H: each node's
//    diagonal block and each linked node pair's off-diagonal block (both
//    triangles, written as exact transposes). A block sums its entries'
//    contributions in the order of an index built once a solve on the
//    host (graph/lm_dense.py: build_index), then writes the damped
//    (lam diag + 1e-6 on free dofs), Jacobi-equilibrated, free-masked
//    Hs and, from the diagonal blocks, bs, diag, s, b and the gradient.
//    An off-diagonal block recomputes its two nodes' diagonal entries by
//    the same code in the same order, so its scales are the diagonal
//    blocks' bits. The all-zero blocks of Hs are zeroed once a solve.
//    Hs covers the live nodes only, a prefix of the store: a padding
//    node's rows are identity rows with a zero right-hand side, which
//    decouple and solve to zero, so the factorization leaves them out.
//  - lm_trial_kernel: one block a graph: x = (y + dy) s, the predicted
//    reduction, the retraction of the free nodes, the trial's robust chi2
//    (residual and rho only), the gain ratio and Nielsen's schedule
//    (_lm_schedule's arithmetic), the accept and take of the poses and the
//    sticky `done` flag the iteration's one host read copies out. A
//    Cholesky that failed (info != 0) is a rejected step, as the NaN step
//    of the op path is.
//
// No float atomics anywhere: every sum (an H entry over its index list, a
// node's gradient, chi2 and the predicted reduction over a fixed tree) is
// taken in one fixed order, so the same graph gives the same bits on every
// run, as runtime.py's deterministic mode promises. Elementwise steps that
// the op path rounds one by one (the damping, pred's terms) use the _rn
// intrinsics, so nvcc does not contract them into FMAs.
//
// On an H100 at 256 nodes and 1024 edge rows (192 and 216 live) the three
// take 8.0, 3.9 and 8.9 us of device time a launch; the library's factor
// and four triangular solves take most of the iteration's ~0.7 ms.
// ptxas (sm_90a): linearize 184 registers, assemble 40, trial 48, no
// spills.
#include <cuda_runtime.h>

#include <cmath>

namespace {

// rows of an edge's contribution buffer (structure-of-arrays over edges)
constexpr int kHff = 0;    // Jf^T W Jf (6 x 6, row-major)
constexpr int kHtt = 36;   // Jt^T W Jt
constexpr int kHft = 72;   // Jf^T W Jt
constexpr int kGf = 108;   // Jf^T W r (6)
constexpr int kGt = 114;   // Jt^T W r
constexpr int kRows = 120;

constexpr int kLinThreads = 64;
constexpr int kAsmThreads = 64;
constexpr int kTrialThreads = 256;

// robust kernel ids (graph/types.py)
enum Kernel {
  kNone = 0,
  kHuber = 1,
  kCauchy = 2,
  kDcs = 3,
  kFair = 4,
  kGemanMcClure = 5,
  kPseudoHuber = 6,
  kSaturated = 7,
  kTukey = 8,
  kWelsch = 9,
};

// -- SE(3) on 7-vector poses [t, q = (w, x, y, z)] (utils/se3.py) ---------

// float and double overloads of the libm calls the templates make
__device__ __forceinline__ float sqrt_t(float x) { return sqrtf(x); }
__device__ __forceinline__ double sqrt_t(double x) { return sqrt(x); }
__device__ __forceinline__ float sin_t(float x) { return sinf(x); }
__device__ __forceinline__ double sin_t(double x) { return sin(x); }
__device__ __forceinline__ float cos_t(float x) { return cosf(x); }
__device__ __forceinline__ double cos_t(double x) { return cos(x); }

template <typename T>
struct Pose {
  T t[3];
  T q[4];
};

template <typename T>
__device__ __forceinline__ void cross(const T* a, const T* b, T* o) {
  o[0] = a[1] * b[2] - a[2] * b[1];
  o[1] = a[2] * b[0] - a[0] * b[2];
  o[2] = a[0] * b[1] - a[1] * b[0];
}

template <typename T>
__device__ __forceinline__ void quat_rotate(const T* q, const T* v, T* o) {
  const T* u = q + 1;
  T uv[3], uuv[3];
  cross(u, v, uv);
  cross(u, uv, uuv);
#pragma unroll
  for (int k = 0; k < 3; ++k) o[k] = v[k] + T(2) * (q[0] * uv[k] + uuv[k]);
}

template <typename T>
__device__ __forceinline__ void quat_mul(const T* a, const T* b, T* o) {
  o[0] = a[0] * b[0] - a[1] * b[1] - a[2] * b[2] - a[3] * b[3];
  o[1] = a[0] * b[1] + a[1] * b[0] + a[2] * b[3] - a[3] * b[2];
  o[2] = a[0] * b[2] - a[1] * b[3] + a[2] * b[0] + a[3] * b[1];
  o[3] = a[0] * b[3] + a[1] * b[2] - a[2] * b[1] + a[3] * b[0];
}

template <typename T>
__device__ __forceinline__ void quat_normalize(T* q) {
  const T n = sqrt_t(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]);
#pragma unroll
  for (int k = 0; k < 4; ++k) q[k] = q[k] / n;
}

template <typename T>
__device__ __forceinline__ Pose<T> load_pose(const float* p) {
  Pose<T> o;
#pragma unroll
  for (int k = 0; k < 3; ++k) o.t[k] = T(p[k]);
#pragma unroll
  for (int k = 0; k < 4; ++k) o.q[k] = T(p[3 + k]);
  return o;
}

template <typename T>
__device__ __forceinline__ Pose<T> pose_inverse(const Pose<T>& p) {
  Pose<T> o;
  o.q[0] = p.q[0];
  o.q[1] = -p.q[1];
  o.q[2] = -p.q[2];
  o.q[3] = -p.q[3];
  T t[3];
  quat_rotate(o.q, p.t, t);
#pragma unroll
  for (int k = 0; k < 3; ++k) o.t[k] = -t[k];
  return o;
}

// a o b: b first, then a
template <typename T>
__device__ __forceinline__ Pose<T> pose_compose(const Pose<T>& a,
                                                const Pose<T>& b) {
  Pose<T> o;
  T t[3];
  quat_rotate(a.q, b.t, t);
#pragma unroll
  for (int k = 0; k < 3; ++k) o.t[k] = a.t[k] + t[k];
  quat_mul(a.q, b.q, o.q);
  quat_normalize(o.q);
  return o;
}

template <typename T>
__device__ __forceinline__ void skew(const T* v, T* m) {
  m[0] = T(0);
  m[1] = -v[2];
  m[2] = v[1];
  m[3] = v[2];
  m[4] = T(0);
  m[5] = -v[0];
  m[6] = -v[1];
  m[7] = v[0];
  m[8] = T(0);
}

// 3x3 row-major product o = a b
template <typename T>
__device__ __forceinline__ void mm3(const T* a, const T* b, T* o) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      o[i * 3 + j] = a[i * 3] * b[j] + a[i * 3 + 1] * b[3 + j] +
                     a[i * 3 + 2] * b[6 + j];
    }
  }
}

template <typename T>
__device__ __forceinline__ void quat_to_mat(const T* q, T* m) {
  const T w = q[0], x = q[1], y = q[2], z = q[3];
  const T xx = x * x, yy = y * y, zz = z * z;
  const T wx = w * x, wy = w * y, wz = w * z;
  const T xy = x * y, xz = x * z, yz = y * z;
  m[0] = T(1) - T(2) * (yy + zz);
  m[1] = T(2) * (xy - wz);
  m[2] = T(2) * (xz + wy);
  m[3] = T(2) * (xy + wz);
  m[4] = T(1) - T(2) * (xx + zz);
  m[5] = T(2) * (yz - wx);
  m[6] = T(2) * (xz - wy);
  m[7] = T(2) * (yz + wx);
  m[8] = T(1) - T(2) * (xx + yy);
}

// branch-free Shepperd in se3.mat_to_quat: the candidate of the largest
// pivot (the first on ties), w >= 0, normalized (float32 only)
__device__ __forceinline__ void mat_to_quat(const float* m, float* q) {
  const float tr = m[0] + m[4] + m[8];
  const float p2[4] = {fmaxf(1.f + tr, 0.f), fmaxf(1.f + m[0] - m[4] - m[8], 0.f),
                       fmaxf(1.f - m[0] + m[4] - m[8], 0.f),
                       fmaxf(1.f - m[0] - m[4] + m[8], 0.f)};
  int k = 0;
#pragma unroll
  for (int c = 1; c < 4; ++c) {
    if (p2[c] > p2[k]) k = c;
  }
  const float s = sqrtf(p2[k] + 1e-24f) * 2.f;
  const float diag = p2[k] / 2.f * (2.f / s);
  if (k == 0) {
    q[0] = diag;
    q[1] = (m[7] - m[5]) / s;
    q[2] = (m[2] - m[6]) / s;
    q[3] = (m[3] - m[1]) / s;
  } else if (k == 1) {
    q[0] = (m[7] - m[5]) / s;
    q[1] = diag;
    q[2] = (m[1] + m[3]) / s;
    q[3] = (m[2] + m[6]) / s;
  } else if (k == 2) {
    q[0] = (m[2] - m[6]) / s;
    q[1] = (m[1] + m[3]) / s;
    q[2] = diag;
    q[3] = (m[5] + m[7]) / s;
  } else {
    q[0] = (m[3] - m[1]) / s;
    q[1] = (m[2] + m[6]) / s;
    q[2] = (m[5] + m[7]) / s;
    q[3] = diag;
  }
  if (q[0] < 0.f) {
#pragma unroll
    for (int c = 0; c < 4; ++c) q[c] = -q[c];
  }
  quat_normalize(q);
}

// rotation vector of a unit quaternion, with se3.quat_log's Taylor form
__device__ __forceinline__ void quat_log(const float* q_in, float* w) {
  float q[4];
  const float sg = q_in[0] < 0.f ? -1.f : 1.f;
#pragma unroll
  for (int c = 0; c < 4; ++c) q[c] = sg * q_in[c];
  const float qw = fminf(fmaxf(q[0], -1.f), 1.f);
  const float v2 = q[1] * q[1] + q[2] * q[2] + q[3] * q[3];
  float scale;
  if (v2 < 1e-4f) {
    const float ws = fmaxf(qw, 0.5f);
    scale = 2.f / ws * (1.f - v2 / (3.f * ws * ws));
  } else {
    const float vn = sqrtf(v2);
    scale = 2.f * atan2f(vn, qw) / vn;
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) w[c] = q[1 + c] * scale;
}

// J_l(w)^-1 = I - W/2 + k W^2 (se3.so3_left_jacobian_inv)
template <typename T>
__device__ __forceinline__ void so3_left_jacobian_inv(const T* w, T* J) {
  const T th2 = w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
  T k;
  if (th2 < T(1e-4)) {
    k = T(1) / T(12) + th2 / T(720);
  } else {
    const T th = sqrt_t(th2);
    k = (T(1) - (th * sin_t(th)) / (T(2) * (T(1) - cos_t(th)))) / th2;
  }
  T W[9], W2[9];
  skew(w, W);
  mm3(W, W, W2);
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    J[i] = ((i % 4 == 0) ? T(1) : T(0)) - T(0.5) * W[i] + k * W2[i];
  }
}

// se3.so3_exp and se3.so3_left_jacobian of one rotation vector (float32)
__device__ __forceinline__ void so3_exp_and_jl(const float* w, float* R,
                                               float* J) {
  const float th2 = w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
  float a, b, c;
  if (th2 < 1e-4f) {
    a = 1.f - th2 / 6.f;
    b = 0.5f - th2 / 24.f;
    c = 1.f / 6.f - th2 / 120.f;
  } else {
    const float th = sqrtf(th2);
    const float s = sinf(th), co = cosf(th);
    a = s / th;
    b = (1.f - co) / th2;
    c = (th - s) / (th2 * th);
  }
  float W[9], W2[9];
  skew(w, W);
  mm3(W, W, W2);
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    const float eye = (i % 4 == 0) ? 1.f : 0.f;
    R[i] = eye + a * W[i] + b * W2[i];
    J[i] = eye + b * W[i] + c * W2[i];
  }
}

// log of a pose as a twist [rho, theta]; the rotation goes through
// mat_to_quat(quat_to_mat(q)) as se3.pose_log does
__device__ __forceinline__ void pose_log(const Pose<float>& p, float* xi) {
  float R[9], q[4], J[9];
  quat_to_mat(p.q, R);
  mat_to_quat(R, q);
  quat_log(q, xi + 3);
  so3_left_jacobian_inv(xi + 3, J);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    xi[i] = J[i * 3] * p.t[0] + J[i * 3 + 1] * p.t[1] + J[i * 3 + 2] * p.t[2];
  }
}

// EdgeSE3 residual log(meas^-1 a^-1 b) (se3.pose_error)
__device__ __forceinline__ void pose_error(const Pose<float>& meas,
                                           const Pose<float>& a,
                                           const Pose<float>& b, float* r) {
  const Pose<float> ab = pose_compose(pose_inverse(a), b);
  pose_log(pose_compose(pose_inverse(meas), ab), r);
}

// p o exp(xi) (se3.pose_retract)
__device__ __forceinline__ Pose<float> pose_retract(const Pose<float>& p,
                                                    const float* xi) {
  float R[9], J[9];
  so3_exp_and_jl(xi + 3, R, J);
  Pose<float> d;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    d.t[i] = J[i * 3] * xi[0] + J[i * 3 + 1] * xi[1] + J[i * 3 + 2] * xi[2];
  }
  mat_to_quat(R, d.q);
  return pose_compose(p, d);
}

// -- robust kernels (graph/robust.py) -------------------------------------

// (rho(e), w = rho'(e)) of a squared error e under kernel `id`; an unknown
// id gives (0, 0)
__device__ __forceinline__ void robust(float e, int id, float delta,
                                       float& rho, float& w) {
  e = fmaxf(e, 0.f);
  const float d2 = delta * delta;
  const bool inside = e <= d2;
  switch (id) {
    case kNone:
      rho = e;
      w = 1.f;
      break;
    case kHuber: {
      const float se = sqrtf(e + 1e-20f);
      rho = inside ? e : 2.f * delta * se - d2;
      w = inside ? 1.f : delta / se;
      break;
    }
    case kCauchy:
      rho = d2 * log1pf(e / d2);
      w = 1.f / (1.f + e / d2);
      break;
    case kDcs: {
      const float s = fminf(2.f * delta / (delta + e), 1.f);
      rho = s * e;
      w = s * s;
      break;
    }
    case kFair: {
      const float u = sqrtf(e + 1e-20f) / delta;
      rho = 2.f * d2 * (u - log1pf(u));
      w = 1.f / (1.f + u);
      break;
    }
    case kGemanMcClure: {
      const float g = d2 / (d2 + e);
      rho = d2 * e / (d2 + e);
      w = g * g;
      break;
    }
    case kPseudoHuber: {
      const float s = sqrtf(1.f + e / d2);
      rho = 2.f * d2 * (s - 1.f);
      w = 1.f / s;
      break;
    }
    case kSaturated:
      rho = fminf(e, d2);
      w = inside ? 1.f : 0.f;
      break;
    case kTukey: {
      const float tk = 1.f - e / d2;
      rho = inside ? d2 / 3.f * (1.f - tk * tk * tk) : d2 / 3.f;
      w = inside ? tk * tk : 0.f;
      break;
    }
    case kWelsch: {
      const float x = expf(-e / d2);
      rho = d2 * (1.f - x);
      w = x;
      break;
    }
    default:
      rho = 0.f;
      w = 0.f;
  }
}

// r^T info r
__device__ __forceinline__ float quad(const float* r, const float* info) {
  float e = 0.f;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float row = 0.f;
#pragma unroll
    for (int j = 0; j < 6; ++j) row += info[i * 6 + j] * r[j];
    e += r[i] * row;
  }
  return e;
}

// an edge row's tables (one graph's), read by both edge kernels
struct Edges {
  const int* from;
  const int* to;
  const float* meas;   // (E, 7)
  const float* info;   // (E, 6, 6)
  const int* kernel;
  const float* delta;
  const unsigned char* mask;
};

__device__ __forceinline__ Edges edges_of(const int* from, const int* to,
                                          const float* meas,
                                          const float* info,
                                          const int* kernel,
                                          const float* delta,
                                          const unsigned char* mask,
                                          size_t r, int e_cap) {
  const size_t o = r * e_cap;
  return Edges{from + o,   to + o,     meas + o * 7, info + o * 36,
               kernel + o, delta + o, mask + o};
}

// Sum over the threads of a block of kThreads (a power of two), in a fixed
// tree: the same inputs give the same bits. Every thread must call it.
template <int kThreads>
__device__ __forceinline__ float block_sum(float v, float* sh) {
  sh[threadIdx.x] = v;
  __syncthreads();
#pragma unroll
  for (int w = kThreads / 2; w > 0; w >>= 1) {
    if (static_cast<int>(threadIdx.x) < w) sh[threadIdx.x] += sh[threadIdx.x + w];
    __syncthreads();
  }
  const float out = sh[0];
  __syncthreads();  // sh is free again
  return out;
}

// -- 1. linearize -----------------------------------------------------------

__global__ void __launch_bounds__(kLinThreads)
    lm_linearize_kernel(const float* __restrict__ poses,
                        const int* __restrict__ from,
                        const int* __restrict__ to,
                        const float* __restrict__ meas,
                        const float* __restrict__ info,
                        const int* __restrict__ kernel,
                        const float* __restrict__ delta,
                        const unsigned char* __restrict__ mask,
                        const unsigned char* __restrict__ relin, int n,
                        int e_cap, float* __restrict__ contrib,
                        float* __restrict__ chi2_terms) {
  const size_t r = blockIdx.y;
  const int e = blockIdx.x * kLinThreads + threadIdx.x;
  if (!relin[r] || e >= e_cap) return;
  const Edges g = edges_of(from, to, meas, info, kernel, delta, mask, r,
                           e_cap);
  if (!g.mask[e]) {
    // a padding row: the index lists none of its terms; its chi2 term is 0
    chi2_terms[r * e_cap + e] = 0.f;
    return;
  }
  const float* pr = poses + r * n * 7;
  const float* pi_ = pr + static_cast<size_t>(g.from[e]) * 7;
  const float* pj_ = pr + static_cast<size_t>(g.to[e]) * 7;
  const Pose<float> pi = load_pose<float>(pi_), pj = load_pose<float>(pj_);
  float res[6];
  pose_error(load_pose<float>(g.meas + static_cast<size_t>(e) * 7), pi, pj,
             res);

  // Jacobians in float64 from the float32 residual and poses, rounded once:
  // J_to = Jr^-1(e) = [[Ji, off], [0, Ji]] with Ji = J_l^-1(-theta) and
  // off = -Ji Q(-rho, -theta) Ji; J_from = -J_to Ad(T_j^-1 T_i), Ad =
  // [[R, [t]x R], [0, R]] (edges.py: _jr_inv, _q_block, _adjoint)
  float Jf[36], Jt[36];
  {
    double rho[3], th[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      rho[k] = -static_cast<double>(res[k]);
      th[k] = -static_cast<double>(res[3 + k]);
    }
    double Ji[9];
    so3_left_jacobian_inv(th, Ji);
    double Q[9];
    {
      const double t2 = th[0] * th[0] + th[1] * th[1] + th[2] * th[2];
      double c1, c2, c3;
      if (t2 < 1e-4) {
        c1 = 1.0 / 6.0 - t2 / 120.0;
        c2 = 1.0 / 24.0 - t2 / 720.0;
        c3 = 1.0 / 120.0 - t2 / 2520.0;
      } else {
        const double t = sqrt(t2);
        const double s = sin(t), c = cos(t);
        c1 = (t - s) / (t2 * t);
        c2 = (t2 + 2.0 * c - 2.0) / (2.0 * t2 * t2);
        c3 = (2.0 * t - 3.0 * s + t * c) / (2.0 * t2 * t2 * t);
      }
      double P[9], W[9], WP[9], PW[9], WPW[9], A[9], B[9], C[9], D[9];
      skew(rho, P);
      skew(th, W);
      mm3(W, P, WP);
      mm3(P, W, PW);
      mm3(WP, W, WPW);
      mm3(W, WP, A);   // W WP
      mm3(PW, W, B);   // PW W
      mm3(WPW, W, C);  // WPW W
      mm3(W, WPW, D);  // W WPW
#pragma unroll
      for (int k = 0; k < 9; ++k) {
        Q[k] = 0.5 * P[k] + c1 * (WP[k] + PW[k] + WPW[k]) +
               c2 * (A[k] + B[k] - 3.0 * WPW[k]) + c3 * (C[k] + D[k]);
      }
    }
    double off[9];
    {
      double JQ[9];
      mm3(Ji, Q, JQ);
      mm3(JQ, Ji, off);
#pragma unroll
      for (int k = 0; k < 9; ++k) off[k] = -off[k];
    }
    // T_j^-1 T_i in float64
    const Pose<double> rel =
        pose_compose(pose_inverse(load_pose<double>(pj_)),
                     load_pose<double>(pi_));
    double R[9], tR[9], JiR[9], top[9];
    quat_to_mat(rel.q, R);
    {
      double S[9];
      skew(rel.t, S);
      mm3(S, R, tR);
    }
    mm3(Ji, R, JiR);
    {
      double a[9], b[9];
      mm3(Ji, tR, a);
      mm3(off, R, b);
#pragma unroll
      for (int k = 0; k < 9; ++k) top[k] = a[k] + b[k];
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const int k = i * 3 + j;
        Jt[i * 6 + j] = static_cast<float>(Ji[k]);
        Jt[i * 6 + 3 + j] = static_cast<float>(off[k]);
        Jt[(3 + i) * 6 + j] = 0.f;
        Jt[(3 + i) * 6 + 3 + j] = static_cast<float>(Ji[k]);
        Jf[i * 6 + j] = static_cast<float>(-JiR[k]);
        Jf[i * 6 + 3 + j] = static_cast<float>(-top[k]);
        Jf[(3 + i) * 6 + j] = 0.f;
        Jf[(3 + i) * 6 + 3 + j] = static_cast<float>(-JiR[k]);
      }
    }
  }

  // IRLS weight of the row's kernel: W = info (w mask), chi2 term rho
  const float* inf = g.info + static_cast<size_t>(e) * 36;
  float rho, w;
  robust(quad(res, inf), g.kernel[e], g.delta[e], rho, w);
  chi2_terms[r * e_cap + e] = rho;
  float W[36];
#pragma unroll
  for (int k = 0; k < 36; ++k) W[k] = inf[k] * w;

  float* out = contrib + r * kRows * e_cap + e;
  auto put = [&](int row, float v) { out[static_cast<size_t>(row) * e_cap] = v; };
  float Wr[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < 6; ++j) acc += W[i * 6 + j] * res[j];
    Wr[i] = acc;
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float gf = 0.f, gt = 0.f;
#pragma unroll
    for (int a = 0; a < 6; ++a) {
      gf += Jf[a * 6 + i] * Wr[a];
      gt += Jt[a * 6 + i] * Wr[a];
    }
    put(kGf + i, gf);
    put(kGt + i, gt);
  }
  // W Jf and W Jt, one column at a time, into the three products
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    float wf[6], wt[6];
#pragma unroll
    for (int a = 0; a < 6; ++a) {
      float sf = 0.f, st = 0.f;
#pragma unroll
      for (int b = 0; b < 6; ++b) {
        sf += W[a * 6 + b] * Jf[b * 6 + j];
        st += W[a * 6 + b] * Jt[b * 6 + j];
      }
      wf[a] = sf;
      wt[a] = st;
    }
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      float ff = 0.f, tt = 0.f, ft = 0.f;
#pragma unroll
      for (int a = 0; a < 6; ++a) {
        ff += Jf[a * 6 + i] * wf[a];
        tt += Jt[a * 6 + i] * wt[a];
        ft += Jf[a * 6 + i] * wt[a];
      }
      put(kHff + i * 6 + j, ff);
      put(kHtt + i * 6 + j, tt);
      put(kHft + i * 6 + j, ft);
    }
  }
}

// -- 2. assemble ------------------------------------------------------------

// Entry (i, j) of one H block: its contributions in index order. A code is
// edge * 4 + slot: slot 0 Jf^T W Jf, 1 Jt^T W Jt, 2 Jf^T W Jt, 3 its
// transpose.
__device__ __forceinline__ float entry_sum(const float* c, int e_cap,
                                           const int* codes, int start,
                                           int end, int i, int j) {
  float acc = 0.f;
  for (int q = start; q < end; ++q) {
    const int code = codes[q];
    const int slot = code & 3;
    const int row = slot == 0   ? kHff + i * 6 + j
                    : slot == 1 ? kHtt + i * 6 + j
                    : slot == 2 ? kHft + i * 6 + j
                                : kHft + j * 6 + i;
    acc = __fadd_rn(acc, c[static_cast<size_t>(row) * e_cap + (code >> 2)]);
  }
  return acc;
}

// A dof's diagonal entry after the free mask (1 on a fixed or invalid
// dof), and its equilibration scale 1/sqrt(max(H_ii + lam H_ii + 1e-6,
// 1e-12)) (the damping on free dofs only), rounded step by step as
// solve.dense_delta rounds them.
__device__ __forceinline__ void dof_scale(float sum, bool fr, float lam,
                                          float& d, float& s) {
  d = fr ? sum : 1.f;
  const float hl =
      fr ? __fadd_rn(d, __fadd_rn(__fmul_rn(lam, d), 1e-6f)) : d;
  s = rsqrtf(fmaxf(hl, 1e-12f));
}

__global__ void __launch_bounds__(kAsmThreads)
    lm_assemble_kernel(const float* __restrict__ contrib,
                       const float* __restrict__ chi2_terms,
                       const int* __restrict__ blocks,
                       const int* __restrict__ codes,
                       const unsigned char* __restrict__ free_,
                       const float* __restrict__ lam,
                       const unsigned char* __restrict__ done, int n,
                       int live, int e_cap, int k_cap, int c_cap, int init,
                       float* __restrict__ Hs, float* __restrict__ bs,
                       float* __restrict__ s_out, float* __restrict__ d_out,
                       float* __restrict__ b_out, float* __restrict__ grad,
                       float* __restrict__ chi2,
                       float* __restrict__ chi2_0) {
  __shared__ float sh[kAsmThreads];
  __shared__ float sa[6], sb[6];
  const size_t r = blockIdx.y;
  const int k = blockIdx.x;
  const int t = threadIdx.x;
  if (done[r]) return;
  if (k == k_cap) {
    // the chi2 at the solve's start, over the edge rows in a fixed tree
    if (!init) return;
    const float* terms = chi2_terms + r * e_cap;
    float acc = 0.f;
    for (int e = t; e < e_cap; e += kAsmThreads) acc += terms[e];
    const float total = block_sum<kAsmThreads>(acc, sh);
    if (t == 0) {
      chi2[r] = total;
      chi2_0[r] = total;
    }
    return;
  }
  const int* blk = blocks + (r * k_cap + k) * 4;
  const int a = blk[0], b = blk[1];
  // padding of a graph with fewer blocks; a pair past the live nodes
  // (none: edges join live nodes)
  if (a < 0 || (b >= live && a != b)) return;
  const float* c = contrib + r * kRows * e_cap;
  const int* cd = codes + r * c_cap;
  const unsigned char* fr = free_ + r * n;
  const float lr = lam[r];
  const size_t D = static_cast<size_t>(6) * n;
  const size_t L = static_cast<size_t>(6) * live;  // Hs's side
  float* H = Hs + r * L * L;
  const int i = t / 6, j = t % 6;
  float v = 0.f;
  if (t < 36) v = entry_sum(c, e_cap, cd, blk[2], blk[3], i, j);
  if (a == b) {
    sh[t] = v;
    __syncthreads();
    const bool fa = fr[a] != 0;
    if (t < 6) {
      float d, s;
      dof_scale(sh[t * 7], fa, lr, d, s);
      sa[t] = s;
      float g = 0.f;
      for (int q = blk[2]; q < blk[3]; ++q) {
        const int code = cd[q];
        const int slot = code & 3;
        if (slot < 2) {
          const int row = (slot == 0 ? kGf : kGt) + t;
          g = __fadd_rn(g, c[static_cast<size_t>(row) * e_cap + (code >> 2)]);
        }
      }
      g = fa ? g : 0.f;
      const float bv = fa ? -g : 0.f;
      const size_t o = r * D + a * 6 + t;
      grad[o] = g;
      b_out[o] = bv;
      s_out[o] = s;
      d_out[o] = d;
      if (a < live) bs[r * L + a * 6 + t] = bv * s;
    }
    __syncthreads();
    if (t < 36 && a < live) {
      float h;
      if (!fa) {
        h = i == j ? 1.f : 0.f;
      } else if (i == j) {
        h = __fadd_rn(v, __fadd_rn(__fmul_rn(lr, v), 1e-6f));
      } else {
        h = v;
      }
      H[(a * 6 + i) * L + a * 6 + j] = h * sa[i] * sa[j];
    }
    return;
  }
  // an off-diagonal block: both nodes' scales from their diagonal blocks'
  // index lists, by the code the diagonal blocks run
  if (t < 12) {
    const int node = t < 6 ? a : b;
    const int m = t % 6;
    const int* nb = blocks + (r * k_cap + node) * 4;
    float d, s;
    dof_scale(entry_sum(c, e_cap, cd, nb[2], nb[3], m, m), fr[node] != 0,
              lr, d, s);
    (t < 6 ? sa : sb)[m] = s;
  }
  __syncthreads();
  if (t < 36) {
    const float h = (fr[a] != 0 && fr[b] != 0) ? v * sa[i] * sb[j] : 0.f;
    H[(a * 6 + i) * L + b * 6 + j] = h;
    H[(b * 6 + j) * L + a * 6 + i] = h;
  }
}

// -- 3. trial -----------------------------------------------------------------

__global__ void __launch_bounds__(kTrialThreads)
    lm_trial_kernel(const float* __restrict__ y0,
                    const float* __restrict__ dy,
                    const float* __restrict__ s_in,
                    const float* __restrict__ d_in,
                    const float* __restrict__ b_in,
                    const int* __restrict__ chol_info,
                    const unsigned char* __restrict__ free_,
                    const int* __restrict__ from,
                    const int* __restrict__ to,
                    const float* __restrict__ meas,
                    const float* __restrict__ info,
                    const int* __restrict__ kernel,
                    const float* __restrict__ delta,
                    const unsigned char* __restrict__ mask, int n,
                    int live, int e_cap, int is_lm, float rel_tol,
                    float* __restrict__ poses, float* __restrict__ trial,
                    float* __restrict__ chi2, float* __restrict__ lam,
                    float* __restrict__ nu, unsigned char* __restrict__ done,
                    unsigned char* __restrict__ relin,
                    int* __restrict__ iters, float* __restrict__ pred_out,
                    float* __restrict__ chi2_new_out) {
  __shared__ float sh[kTrialThreads];
  const size_t r = blockIdx.x;
  const int t = threadIdx.x;
  if (done[r]) {
    // a graph that stopped is frozen: no step, lam and nu kept
    if (t == 0) relin[r] = 0;
    return;
  }
  const size_t D = static_cast<size_t>(6) * n;
  const size_t L = static_cast<size_t>(6) * live;  // the solve's side
  const float* y = y0 + r * L;
  const float* z = dy + r * L;
  const float* s = s_in + r * D;
  const float* dg = d_in + r * D;
  const float* bv = b_in + r * D;
  const float lr = lam[r];
  const bool ok = chol_info[r] == 0;

  // x = (y + dy) s and the predicted reduction x^T (lam diag x + b)
  float acc = 0.f;
  for (size_t d = t; d < L; d += kTrialThreads) {
    const float x = __fmul_rn(__fadd_rn(y[d], z[d]), s[d]);
    acc += __fmul_rn(x, __fadd_rn(__fmul_rn(__fmul_rn(lr, dg[d]), x), bv[d]));
  }
  const float pred = block_sum<kTrialThreads>(acc, sh);

  // the trial poses: the free nodes retracted by their x
  float* pr = poses + r * n * 7;
  float* tr = trial + r * n * 7;
  const unsigned char* fr = free_ + r * n;
  for (int m = t; m < n; m += kTrialThreads) {
    Pose<float> p = load_pose<float>(pr + static_cast<size_t>(m) * 7);
    if (ok && m < live && fr[m]) {
      float xi[6];
#pragma unroll
      for (int k = 0; k < 6; ++k) {
        const size_t d = static_cast<size_t>(m) * 6 + k;
        xi[k] = __fmul_rn(__fadd_rn(y[d], z[d]), s[d]);
      }
      p = pose_retract(p, xi);
    }
    float* o = tr + static_cast<size_t>(m) * 7;
#pragma unroll
    for (int k = 0; k < 3; ++k) o[k] = p.t[k];
#pragma unroll
    for (int k = 0; k < 4; ++k) o[3 + k] = p.q[k];
  }
  __syncthreads();  // the block's trial poses are written and visible

  // the trial's robust chi2 (no Jacobians)
  const Edges g = edges_of(from, to, meas, info, kernel, delta, mask, r,
                           e_cap);
  acc = 0.f;
  if (ok) {
    for (int e = t; e < e_cap; e += kTrialThreads) {
      if (!g.mask[e]) continue;
      float res[6], rho, w;
      pose_error(load_pose<float>(g.meas + static_cast<size_t>(e) * 7),
                 load_pose<float>(tr + static_cast<size_t>(g.from[e]) * 7),
                 load_pose<float>(tr + static_cast<size_t>(g.to[e]) * 7),
                 res);
      robust(quad(res, g.info + static_cast<size_t>(e) * 36), g.kernel[e],
             g.delta[e], rho, w);
      acc += rho;
    }
  }
  const float chi2_new =
      ok ? block_sum<kTrialThreads>(acc, sh) : __int_as_float(0x7fc00000);

  // the verdict (solve._lm_schedule), the same in every thread
  const float c0 = chi2[r];
  const float nr = nu[r];
  const bool accept = ok && chi2_new <= c0;
  float lam_next = lr, nu_next = nr;
  if (is_lm) {
    if (accept) {
      const float rho = (c0 - chi2_new) / fmaxf(pred, 1e-30f);
      const float u = 2.f * rho - 1.f;
      const float shrink = fmaxf(1.f - u * u * u, 1.f / 3.f);
      lam_next = fmaxf(lr * shrink, 1e-12f);
      nu_next = 2.f;
    } else {
      lam_next = fminf(lr * nr, 1e10f);
      nu_next = fminf(nr * 2.f, 1e8f);
    }
  }
  const float rel = (c0 - chi2_new) / fmaxf(c0, 1e-12f);
  const bool stop = (accept && rel < rel_tol) || lam_next > 1e8f;
  __syncthreads();  // every thread has read chi2, lam and nu
  if (t == 0) {
    pred_out[r] = pred;
    chi2_new_out[r] = chi2_new;
    if (accept) chi2[r] = chi2_new;
    lam[r] = lam_next;
    nu[r] = nu_next;
    done[r] = stop ? 1 : 0;
    relin[r] = accept ? 1 : 0;
    iters[r] += 1;
  }
  if (accept) {
    // each thread takes the nodes it retracted
    for (int m = t; m < n; m += kTrialThreads) {
      const float* o = tr + static_cast<size_t>(m) * 7;
      float* p = pr + static_cast<size_t>(m) * 7;
#pragma unroll
      for (int k = 0; k < 7; ++k) p[k] = o[k];
    }
  }
}

}  // namespace

// The three kernels over R graphs of one shape (N nodes, E edge rows) side
// by side; every array has a leading graph axis and is contiguous on the
// device. Each returns cudaGetLastError().

// poses (R, N, 7); from, to (R, E) int32; meas (R, E, 7); info (R, E, 6,
// 6); kernel (R, E) int32; delta (R, E); mask, relin (R, E), (R) bool;
// writes contrib (R, 120, E) and chi2_terms (R, E) of the graphs whose
// relin flag is set.
extern "C" int mrg_lm_linearize(const float* poses, const int* from,
                                const int* to, const float* meas,
                                const float* info, const int* kernel,
                                const float* delta, const unsigned char* mask,
                                const unsigned char* relin, int graphs, int n,
                                int e_cap, float* contrib, float* chi2_terms,
                                void* stream) {
  if (graphs > 0 && e_cap > 0) {
    const dim3 grid((e_cap + kLinThreads - 1) / kLinThreads, graphs);
    lm_linearize_kernel<<<grid, kLinThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        poses, from, to, meas, info, kernel, delta, mask, relin, n, e_cap,
        contrib, chi2_terms);
  }
  return static_cast<int>(cudaGetLastError());
}

// blocks (R, K, 4) int32 (node a, node b, first code, end code; a < 0 for
// padding), codes (R, C) int32; free_ (R, N) bool; lam (R); done (R) bool;
// init: also write chi2 and chi2_0 (R) from chi2_terms. live: the nodes
// below it are the solve's (the others are padding, identity rows that the
// solve leaves out). Writes the nonzero blocks of Hs (R, 6 live, 6 live),
// bs (R, 6 live) and s, diag, b, grad (R, 6N) of the graphs
// not done.
extern "C" int mrg_lm_assemble(const float* contrib, const float* chi2_terms,
                               const int* blocks, const int* codes,
                               const unsigned char* free_, const float* lam,
                               const unsigned char* done, int graphs, int n,
                               int live, int e_cap, int k_cap, int c_cap,
                               int init,
                               float* Hs, float* bs, float* s, float* diag,
                               float* b, float* grad, float* chi2,
                               float* chi2_0, void* stream) {
  if (graphs > 0) {
    const dim3 grid(k_cap + 1, graphs);
    lm_assemble_kernel<<<grid, kAsmThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        contrib, chi2_terms, blocks, codes, free_, lam, done, n, live, e_cap,
        k_cap, c_cap, init, Hs, bs, s, diag, b, grad, chi2, chi2_0);
  }
  return static_cast<int>(cudaGetLastError());
}

// y0, dy (R, 6 live): the equilibrated solution and its refinement; s, diag, b
// (R, 6N) from mrg_lm_assemble; chol_info (R) int32 from the Cholesky;
// the edge tables as for mrg_lm_linearize; is_lm: Nielsen's schedule
// moves lam. Updates poses (R, N, 7) on an accepted step, chi2, lam, nu,
// done, relin, iters (R) and writes the trial poses (R, N, 7), pred and
// the trial's chi2 (R).
extern "C" int mrg_lm_trial(const float* y0, const float* dy, const float* s,
                            const float* diag, const float* b,
                            const int* chol_info, const unsigned char* free_,
                            const int* from, const int* to, const float* meas,
                            const float* info, const int* kernel,
                            const float* delta, const unsigned char* mask,
                            int graphs, int n, int live, int e_cap,
                            int is_lm, float rel_tol, float* poses, float* trial,
                            float* chi2, float* lam, float* nu,
                            unsigned char* done, unsigned char* relin,
                            int* iters, float* pred, float* chi2_new,
                            void* stream) {
  if (graphs > 0) {
    lm_trial_kernel<<<graphs, kTrialThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
        y0, dy, s, diag, b, chol_info, free_, from, to, meas, info, kernel,
        delta, mask, n, live, e_cap, is_lm, rel_tol, poses, trial, chi2, lam,
        nu,
        done, relin, iters, pred, chi2_new);
  }
  return static_cast<int>(cudaGetLastError());
}

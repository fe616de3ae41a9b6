// One evaluation of the coarse tracker's photometric system and its
// cluster reduction, shared by track_reduce.cu (K6) and track_lm.cu (the
// LM level): the residuals of one pyramid level's point list at one
// candidate pose, reduced to one 46-vector (energy, count, the 36 unique
// entries of H = J^T W J, the 8 of g = J^T W r), in either weighting of
// _energy_and_system (tandem_tpu/tracking/coarse_tracker.py:348): DSO's
// Huber + cutoff, or dvo's Student-t (_tdist_weights, :314).
//
// Layout: candidate b is one thread-block cluster of C <= 8 CTAs
// (grid (C, B), cluster (C, 1, 1)); CTA rank c takes the contiguous share
// [c * share, (c + 1) * share) of the points, share = ceil(N / C), and
// thread t its points t, t + kThreads, ... of the share. C is chosen from
// N alone (cluster_size), so K6 and the LM split a level alike for every
// B. When the share fits, the CTA stashes its points once as (un, vn,
// idv, refc) in shared memory (16 B a point, un = NaN for an invalid
// point); otherwise they are read from L2 at every evaluation.
//
// Reduction: each thread sums its points in registers; warp shuffles,
// then the CTA's warps in index order, leave the CTA's vector in its
// shared memory; after cluster.sync() every CTA sums the C vectors in
// rank order through distributed shared memory (map_shared_rank). The
// order is fixed, so the sums are deterministic and every CTA of the
// cluster holds the same totals; no float atomics, no second launch. The
// CTA's vector is double-buffered, so one cluster.sync() a reduction is
// enough: a CTA cannot write a buffer again before every CTA has passed
// the next barrier, which it reaches only after its reads.
//
// Student-t: the weights need the count and sum of r^2, the trimmed
// start (count and sum of r^2 at or below the mean), ten rounds of
// sigma^2 = max(sum(w r^2) / n, 1e-6) and the final weighted system:
// 14 cluster reductions an evaluation. Each point's r^2 stays in the
// CTA's shared memory between them (-1 where the point is not good); the
// final pass evaluates the points again for their Jacobians (the same
// arithmetic, so the same r).
//
// Exactness: every per-point quantity (projection, border test, bilinear
// sample, residual, weight, Jacobian) uses round-to-nearest intrinsics in
// the operation order of the plain PyTorch version
// (tandem_tpu_torch/ops/track_reduce.py; its ``c / x`` of a Python number
// is PyTorch's reciprocal times c, and so is the kernel's), so the kernel
// keeps the same points (num equal) with the same r, w and J; the sums
// differ from the plain version in their order (and fuse each product
// into its addition). Sums use explicit __fmaf_rn / __fadd_rn, so no
// contraction choice of the compiler can make K6's sums differ from the
// LM's.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <mutex>
#include <set>
#include <utility>

namespace cg = cooperative_groups;

// Internal linkage: each source that includes this has its own copy.
namespace {

constexpr int kThreads = 512;        // ops/track_reduce.py THREADS
constexpr int kWarps = kThreads / 32;
constexpr int kPointsPerThread = 4;  // the cluster-size chooser's target
constexpr int kMaxCluster = 8;       // the portable cluster size
constexpr int kAcc = 46;             // energy, num, H upper (36), g (8)
constexpr int kTdistRounds = 10;
constexpr float kNu = 5.0f;          // coarse_tracker.TDIST_DOF
// Dynamic shared memory a CTA may take for its stash and r^2 (the block
// limit is 227 KB; the kernels' static shared memory is < 4 KB).
constexpr size_t kSmemMax = 200 * 1024;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ float dvd(float a, float b) {
  return __fdiv_rn(a, b);
}

// C, from N alone (ops/track_reduce.py cluster_size).
inline int cluster_size(int64_t N) {
  const int64_t per = static_cast<int64_t>(kThreads) * kPointsPerThread;
  const int64_t c = (N + per - 1) / per;
  return static_cast<int>(c < 1 ? 1 : (c > kMaxCluster ? kMaxCluster : c));
}

// How a level is split (ops/track_reduce.py cluster_plan).
struct Plan {
  int C;           // CTAs a candidate
  int64_t share;   // points a CTA
  int stash;       // the points live in shared memory
  int tdist;       // the Student-t weighting (r^2 in shared memory)
  size_t smem;     // dynamic shared memory a CTA
};

// Returns false when the t-mode's r^2 does not fit a CTA's shared memory.
inline bool make_plan(int64_t N, bool tdist, Plan* p) {
  p->C = cluster_size(N);
  p->share = (N + p->C - 1) / p->C;
  p->tdist = tdist ? 1 : 0;
  const size_t r_bytes = tdist ? static_cast<size_t>(p->share) * 4 : 0;
  const size_t both = static_cast<size_t>(p->share) * 16 + r_bytes;
  p->stash = both <= kSmemMax ? 1 : 0;
  p->smem = p->stash ? both : r_bytes;
  return p->smem <= kSmemMax;
}

// One pyramid level: the point list, the new frame's planes, intrinsics.
struct Level {
  const float* pu;
  const float* pv;
  const float* pid;
  const float* pcol;
  const uint8_t* pvalid;
  const float* img;
  const float* gx;
  const float* gy;
  int64_t N;
  int H, W;
  float fx, fy, cx, cy, cutoff, huber;
};

// This CTA's share of the level and its shared buffers.
struct Share {
  int64_t begin, count;
  const float4* stash;  // null: read the points from L2
  float* r2;            // t-mode: r^2 of each point, -1 where not good
};

struct Pose {
  float R[3][3], t[3], a, b;
};

__device__ __forceinline__ Pose load_pose(const float* T, const float* aff) {
  Pose P;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) P.R[i][j] = T[i * 4 + j];
    P.t[i] = T[i * 4 + 3];
  }
  P.a = aff[0];
  P.b = aff[1];
  return P;
}

// A point as (un, vn, idv, refc); false for an invalid one.
__device__ __forceinline__ bool read_point(const Level& L, int64_t n,
                                           float4* p) {
  if (!L.pvalid[n]) return false;
  *p = make_float4(dvd(sub(L.pu[n], L.cx), L.fx),
                   dvd(sub(L.pv[n], L.cy), L.fy), L.pid[n], L.pcol[n]);
  return true;
}

__device__ __forceinline__ bool load_point(const Level& L, const Share& s,
                                           int64_t i, float4* p) {
  if (s.stash != nullptr) {
    *p = s.stash[i];
    return !isnan(p->x);
  }
  return read_point(L, s.begin + i, p);
}

// Cut the level for CTA ``rank`` and, when the plan says so, stash its
// points (each thread stashes the points it will evaluate).
__device__ Share make_share(const Level& L, const Plan& plan, int rank,
                            float4* smem) {
  Share s;
  s.begin = static_cast<int64_t>(rank) * plan.share;
  const int64_t end = s.begin + plan.share < L.N ? s.begin + plan.share
                                                 : L.N;
  s.count = end > s.begin ? end - s.begin : 0;
  s.stash = nullptr;
  float* after = reinterpret_cast<float*>(smem);
  if (plan.stash) {
    for (int64_t i = threadIdx.x; i < s.count; i += kThreads) {
      float4 p;
      if (!read_point(L, s.begin + i, &p)) {
        p = make_float4(__int_as_float(0x7fc00000), 0.0f, 0.0f, 0.0f);
      }
      smem[i] = p;
    }
    s.stash = smem;
    after = reinterpret_cast<float*>(smem + plan.share);
  }
  s.r2 = plan.tdist ? after : nullptr;
  return s;
}

// The residual of point p at pose P (the plain version's level_residuals
// and bilinear_with_grad). False unless the point is good (in front of
// the camera and inside the border). With ``grad``, also the Jacobian
// (the plain version's order of operations, each rounded).
template <bool kGrad>
__device__ __forceinline__ bool residual(const Level& L, const Pose& P,
                                         float4 p, float* r, float J[8]) {
  const float un = p.x, vn = p.y, idv = p.z, refc = p.w;
  float q[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    q[i] = add(add(add(mul(P.R[i][0], un), mul(P.R[i][1], vn)), P.R[i][2]),
               mul(P.t[i], idv));
  }
  if (!(q[2] > 1e-6f)) return false;
  const float u2 = dvd(q[0], q[2]);
  const float v2 = dvd(q[1], q[2]);
  const float px = add(mul(L.fx, u2), L.cx);
  const float py = add(mul(L.fy, v2), L.cy);
  if (!(px > 2.0f && px < static_cast<float>(L.W - 3) && py > 2.0f &&
        py < static_cast<float>(L.H - 3))) {
    return false;
  }
  // Bilinear sample (corners 00, 01, 10, 11 summed left to right).
  const float x0 = floorf(px), y0 = floorf(py);
  const float wx = sub(px, x0), wy = sub(py, y0);
  const float w00 = mul(sub(1.0f, wx), sub(1.0f, wy));
  const float w01 = mul(wx, sub(1.0f, wy));
  const float w10 = mul(sub(1.0f, wx), wy);
  const float w11 = mul(wx, wy);
  const int64_t i00 =
      static_cast<int64_t>(y0) * L.W + static_cast<int>(x0);
  const int W = L.W;
  auto sample = [&](const float* pl) {
    return add(add(add(mul(__ldg(pl + i00), w00), mul(__ldg(pl + i00 + 1), w01)),
                   mul(__ldg(pl + i00 + W), w10)),
               mul(__ldg(pl + i00 + W + 1), w11));
  };
  *r = sub(sample(L.img), add(mul(P.a, refc), P.b));
  if constexpr (kGrad) {
    const float idn = dvd(idv, q[2]);
    const float dxf = mul(sample(L.gx), L.fx);
    const float dyf = mul(sample(L.gy), L.fy);
    const float uv = mul(u2, v2);
    J[0] = mul(idn, dxf);
    J[1] = mul(idn, dyf);
    J[2] = mul(-idn, add(mul(u2, dxf), mul(v2, dyf)));
    J[3] = -add(mul(uv, dxf), mul(add(1.0f, mul(v2, v2)), dyf));
    J[4] = add(mul(add(1.0f, mul(u2, u2)), dxf), mul(uv, dyf));
    J[5] = sub(mul(u2, dyf), mul(v2, dxf));
    J[6] = -refc;
    J[7] = -1.0f;
  }
  return true;
}

// acc[2..45] += the point's terms of H and g with weight w.
__device__ __forceinline__ void add_system(float acc[kAcc], const float J[8],
                                           float w, float r) {
  int k = 2;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float jw = mul(J[i], w);
#pragma unroll
    for (int j = i; j < 8; ++j) {
      acc[k] = __fmaf_rn(jw, J[j], acc[k]);
      ++k;
    }
    acc[38 + i] = __fmaf_rn(jw, r, acc[38 + i]);
  }
}

// (nu + 1) / (nu + r^2 / sigma^2), as the plain version rounds it.
__device__ __forceinline__ float tdist_weight(float r2, float sigma2) {
  return mul(dvd(1.0f, add(kNu, dvd(r2, sigma2))), kNu + 1.0f);
}

// The shared buffers of the cluster reduction.
struct Reducer {
  float (*warp_sums)[kAcc];  // [kWarps][kAcc]
  float (*cta)[kAcc];        // [2][kAcc]: this CTA's vector, double-buffered
  float* total;              // [kAcc]: the cluster's sums
  int parity;
};

// Sum v (NV values a thread) over the cluster's threads into R.total, the
// same totals in every CTA. Every thread of every CTA of the cluster must
// call it.
template <int NV>
__device__ void cluster_sum(const float (&v)[NV], Reducer& R) {
  cg::cluster_group cluster = cg::this_cluster();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    float x = v[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      x = add(x, __shfl_down_sync(kFull, x, off));
    }
    if (lane == 0) R.warp_sums[warp][k] = x;
  }
  __syncthreads();
  float* mine = R.cta[R.parity];
  if (threadIdx.x < NV) {
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s = add(s, R.warp_sums[w][threadIdx.x]);
    mine[threadIdx.x] = s;
  }
  cluster.sync();
  if (threadIdx.x < NV) {
    float s = 0.0f;
    const unsigned C = cluster.num_blocks();
    for (unsigned c = 0; c < C; ++c) {
      s = add(s, cluster.map_shared_rank(mine, c)[threadIdx.x]);
    }
    R.total[threadIdx.x] = s;
  }
  __syncthreads();
  R.parity ^= 1;
}

// One evaluation at pose P: R.total = the 46 sums of this CTA's cluster.
template <bool kTdist>
__device__ void evaluate(const Level& L, const Share& s, const Pose& P,
                         Reducer& R) {
  float acc[kAcc];
#pragma unroll
  for (int k = 0; k < kAcc; ++k) acc[k] = 0.0f;
  if constexpr (!kTdist) {
#pragma unroll 1
    for (int64_t i = threadIdx.x; i < s.count; i += kThreads) {
      float4 p;
      float r, J[8];
      if (!load_point(L, s, i, &p) || !residual<true>(L, P, p, &r, J)) {
        continue;
      }
      acc[1] = add(acc[1], 1.0f);
      const float absr = fabsf(r);
      if (!(absr < L.cutoff)) {  // saturated: the max energy, no weight
        acc[0] = add(acc[0], mul(L.cutoff, L.cutoff));
        continue;
      }
      const float hw = absr < L.huber
                           ? 1.0f
                           : mul(dvd(1.0f, fmaxf(absr, 1e-12f)), L.huber);
      acc[0] = add(acc[0], mul(mul(mul(hw, r), r), sub(2.0f, hw)));
      add_system(acc, J, hw, r);
    }
    cluster_sum(acc, R);
    return;
  }
  // Student-t: n and sum r^2, keeping r^2 (-1: not good).
  float two[2] = {0.0f, 0.0f};
#pragma unroll 1
  for (int64_t i = threadIdx.x; i < s.count; i += kThreads) {
    float4 p;
    float r, r2 = -1.0f;
    if (load_point(L, s, i, &p) && residual<false>(L, P, p, &r, nullptr)) {
      r2 = mul(r, r);
      two[0] = add(two[0], 1.0f);
      two[1] = add(two[1], r2);
    }
    s.r2[i] = r2;
  }
  cluster_sum(two, R);
  const float n = fmaxf(R.total[0], 1.0f);
  const float mean_r2 = dvd(R.total[1], n);
  // The trimmed start: the residuals at or below the mean.
  two[0] = two[1] = 0.0f;
#pragma unroll 1
  for (int64_t i = threadIdx.x; i < s.count; i += kThreads) {
    const float r2 = s.r2[i];
    if (r2 >= 0.0f && r2 <= mean_r2) {
      two[0] = add(two[0], 1.0f);
      two[1] = add(two[1], r2);
    }
  }
  cluster_sum(two, R);
  float sigma2 = fmaxf(dvd(R.total[1], fmaxf(R.total[0], 1.0f)), 1e-6f);
  for (int round = 0; round < kTdistRounds; ++round) {
    float one[1] = {0.0f};
#pragma unroll 1
    for (int64_t i = threadIdx.x; i < s.count; i += kThreads) {
      const float r2 = s.r2[i];
      if (r2 >= 0.0f) {
        one[0] = add(one[0], mul(r2, tdist_weight(r2, sigma2)));
      }
    }
    cluster_sum(one, R);
    sigma2 = fmaxf(dvd(R.total[0], n), 1e-6f);
  }
  // The weighted system, the points evaluated again for J.
#pragma unroll 1
  for (int64_t i = threadIdx.x; i < s.count; i += kThreads) {
    if (!(s.r2[i] >= 0.0f)) continue;
    float4 p;
    float r, J[8];
    load_point(L, s, i, &p);
    residual<true>(L, P, p, &r, J);
    const float w = tdist_weight(mul(r, r), sigma2);
    acc[0] = __fmaf_rn(mul(w, r), r, acc[0]);
    acc[1] = add(acc[1], 1.0f);
    add_system(acc, J, w, r);
  }
  cluster_sum(acc, R);
}

// Upper-triangle accumulator index m (0..35) -> (i, j), j >= i.
__device__ __forceinline__ void tri_index(int m, int* i, int* j) {
  int r = 0;
  while (m >= 8 - r) {
    m -= 8 - r;
    ++r;
  }
  *i = r;
  *j = r + m;
}

// Launch ``kernel`` on grid (C, B) in clusters of (C, 1, 1) with the
// plan's dynamic shared memory; returns the launch's error.
// Let ``kernel`` take up to kSmemMax of dynamic shared memory on the
// current device: set once a kernel and device (the call costs host time
// at every launch otherwise), so a context reset must not follow.
inline cudaError_t allow_smem(const void* kernel) {
  static std::mutex mu;
  static std::set<std::pair<const void*, int>> done;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  if (done.count({kernel, dev}) != 0) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kSmemMax));
  if (err == cudaSuccess) done.insert({kernel, dev});
  return err;
}

template <typename... KArgs, typename... Args>
cudaError_t launch_clusters(void (*kernel)(KArgs...), const Plan& plan,
                            int B, cudaStream_t stream, Args&&... args) {
  cudaError_t err = allow_smem(reinterpret_cast<const void*>(kernel));
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(plan.C, B, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = plan.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = plan.C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, std::forward<Args>(args)...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

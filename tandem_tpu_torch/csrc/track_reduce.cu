// Kernel K6: the coarse tracker's photometric residuals and 8x8 normal
// equations, summed over one pyramid level's point list for B candidate
// poses (the Huber + cutoff branch of _energy_and_system).
//
// Replaces tandem_tpu/tracking/coarse_tracker.py _energy_and_system
// (:348, with _level_residuals :259 and _bilinear_with_grad :235), which the
// JAX package leaves to XLA (an einsum over the point list; it is not a
// Pallas kernel). The reference ran the same reduction as a CUDA kernel of
// 45 accumulators (libdr cuda_coarse_tracker_private.cu:261-445).
//
// Layout: one thread per (candidate, point). Pass 1: block (b, j) takes
// kPointsPerBlock consecutive points of candidate b; each thread projects
// its points, applies the border test, samples intensity and gradients
// bilinearly from the three level planes (the 12-wide corner pack of the
// JAX package was a TPU gather trick and is not kept), and accumulates the
// energy, the count, the 36 unique entries of H = J^T W J and the 8 of
// g = J^T W r in registers. Warp shuffles, then the block's 8 warps in
// order, leave one 46-vector per block. Pass 2 sums a candidate's block
// vectors in index order. No float atomics: the result is deterministic.
//
// Bound: launch latency at the tracker's sizes (at most 42,496 points x 15
// candidates, ~1 MB of point data and the level planes from L2); the work
// per point is ~150 flops. A simple form is enough for now.
//
// Exactness: the projection, border test, bilinear sample and residual use
// round-to-nearest intrinsics in the order of the plain PyTorch version
// (tandem_tpu_torch/ops/track_reduce.py level_residuals), so both keep the
// same points and num is equal; the sums differ only in their order.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;
constexpr int kPointsPerBlock = kThreads * kPerThread;  // ops/track_reduce.py
constexpr int kWarps = kThreads / 32;
constexpr int kAcc = 46;  // energy, num, H upper triangle (36), g (8)

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

__global__ void __launch_bounds__(kThreads)
    track_partial_kernel(const float* __restrict__ pu,
                         const float* __restrict__ pv,
                         const float* __restrict__ pid,
                         const float* __restrict__ pcol,
                         const uint8_t* __restrict__ pvalid,
                         const float* __restrict__ T,
                         const float* __restrict__ aff,
                         const float* __restrict__ img,
                         const float* __restrict__ gxp,
                         const float* __restrict__ gyp, int64_t N, int H,
                         int W, float fx, float fy, float cx, float cy,
                         float cutoff, float huber,
                         float* __restrict__ partial) {
  const int b = blockIdx.y;
  const float* Tb = T + b * 16;
  float R[3][3], t[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) R[i][j] = Tb[i * 4 + j];
    t[i] = Tb[i * 4 + 3];
  }
  const float a = aff[2 * b], bb = aff[2 * b + 1];
  const float xmax = static_cast<float>(W - 3);
  const float ymax = static_cast<float>(H - 3);

  float acc[kAcc];
#pragma unroll
  for (int k = 0; k < kAcc; ++k) acc[k] = 0.0f;

  const int64_t base = static_cast<int64_t>(blockIdx.x) * kPointsPerBlock;
#pragma unroll 1
  for (int s = 0; s < kPerThread; ++s) {
    const int64_t n = base + s * kThreads + threadIdx.x;
    if (n >= N || !pvalid[n]) continue;
    const float idv = pid[n];
    const float un = dvd(sub(pu[n], cx), fx);
    const float vn = dvd(sub(pv[n], cy), fy);
    float q[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      q[i] = add(add(add(mul(R[i][0], un), mul(R[i][1], vn)), R[i][2]),
                 mul(t[i], idv));
    }
    if (!(q[2] > 1e-6f)) continue;
    const float u2 = dvd(q[0], q[2]);
    const float v2 = dvd(q[1], q[2]);
    const float px = add(mul(fx, u2), cx);
    const float py = add(mul(fy, v2), cy);
    if (!(px > 2.0f && px < xmax && py > 2.0f && py < ymax)) continue;

    // Bilinear sample of intensity and gradients (corner order 00, 01, 10,
    // 11, summed left to right as the plain version does).
    const float x0 = floorf(px), y0 = floorf(py);
    const float wx = sub(px, x0), wy = sub(py, y0);
    const float w00 = mul(sub(1.0f, wx), sub(1.0f, wy));
    const float w01 = mul(wx, sub(1.0f, wy));
    const float w10 = mul(sub(1.0f, wx), wy);
    const float w11 = mul(wx, wy);
    const int64_t i00 = static_cast<int64_t>(y0) * W + static_cast<int>(x0);
    float smp[3];
    const float* planes[3] = {img, gxp, gyp};
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float* p = planes[c];
      smp[c] = add(add(add(mul(__ldg(p + i00), w00), mul(__ldg(p + i00 + 1), w01)),
                       mul(__ldg(p + i00 + W), w10)),
                   mul(__ldg(p + i00 + W + 1), w11));
    }
    const float refc = pcol[n];
    const float r = sub(smp[0], add(mul(a, refc), bb));

    acc[1] += 1.0f;
    const float absr = fabsf(r);
    if (!(absr < cutoff)) {
      acc[0] += cutoff * cutoff;  // saturated: the max energy, no weight
      continue;
    }
    const float hw = absr < huber ? 1.0f : huber / fmaxf(absr, 1e-12f);
    acc[0] += hw * r * r * (2.0f - hw);

    const float idn = idv / q[2];
    const float dxf = smp[1] * fx, dyf = smp[2] * fy;
    float J[8];
    J[0] = idn * dxf;
    J[1] = idn * dyf;
    J[2] = -idn * (u2 * dxf + v2 * dyf);
    J[3] = -(u2 * v2 * dxf + (1.0f + v2 * v2) * dyf);
    J[4] = (1.0f + u2 * u2) * dxf + u2 * v2 * dyf;
    J[5] = u2 * dyf - v2 * dxf;
    J[6] = -refc;
    J[7] = -1.0f;
    int k = 2;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float jw = J[i] * hw;
#pragma unroll
      for (int j = i; j < 8; ++j) acc[k++] += jw * J[j];
      acc[38 + i] += jw * r;
    }
  }

  __shared__ float warp_sums[kWarps][kAcc];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < kAcc; ++k) {
    float v = acc[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      v += __shfl_down_sync(0xffffffffu, v, off);
    }
    if (lane == 0) warp_sums[warp][k] = v;
  }
  __syncthreads();
  if (threadIdx.x < kAcc) {
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += warp_sums[w][threadIdx.x];
    partial[(static_cast<int64_t>(b) * gridDim.x + blockIdx.x) * kAcc +
            threadIdx.x] = s;
  }
}

__global__ void track_final_kernel(const float* __restrict__ partial,
                                   int nblk, float* __restrict__ energy,
                                   float* __restrict__ num,
                                   float* __restrict__ Hm,
                                   float* __restrict__ g) {
  const int b = blockIdx.x, k = threadIdx.x;
  if (k >= kAcc) return;
  const float* p = partial + static_cast<int64_t>(b) * nblk * kAcc + k;
  float s = 0.0f;
  for (int j = 0; j < nblk; ++j) s += p[static_cast<int64_t>(j) * kAcc];
  if (k == 0) {
    energy[b] = s;
  } else if (k == 1) {
    num[b] = s;
  } else if (k < 38) {
    int m = k - 2, i = 0;  // upper-triangle index -> (i, j)
    while (m >= 8 - i) {
      m -= 8 - i;
      ++i;
    }
    const int j = i + m;
    Hm[b * 64 + i * 8 + j] = s;
    Hm[b * 64 + j * 8 + i] = s;
  } else {
    g[b * 8 + (k - 38)] = s;
  }
}

}  // namespace

// pu, pv, pid, pcol: (N,) f32; pvalid: (N,) bool; T: (B, 4, 4) f32;
// aff: (B, 2) f32; img, gx, gy: (H, W) f32; partial: (B, nblk, 46) f32
// scratch with nblk = max(ceil(N / 1024), 1); energy, num: (B,);
// Hm: (B, 8, 8); g: (B, 8). All contiguous on the current device. Launches
// both passes on ``stream`` without synchronising; returns
// cudaGetLastError().
extern "C" int tandem_track_reduce(
    const float* pu, const float* pv, const float* pid, const float* pcol,
    const uint8_t* pvalid, const float* T, const float* aff, const float* img,
    const float* gx, const float* gy, int64_t N, int B, int H, int W,
    float fx, float fy, float cx, float cy, float cutoff, float huber,
    float* partial, int nblk, float* energy, float* num, float* Hm, float* g,
    cudaStream_t stream) {
  const int64_t want = N > 0 ? (N + kPointsPerBlock - 1) / kPointsPerBlock : 1;
  if (B <= 0 || nblk != want) return static_cast<int>(cudaErrorInvalidValue);
  track_partial_kernel<<<dim3(nblk, B), kThreads, 0, stream>>>(
      pu, pv, pid, pcol, pvalid, T, aff, img, gx, gy, N, H, W, fx, fy, cx, cy,
      cutoff, huber, partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  track_final_kernel<<<B, 64, 0, stream>>>(partial, nblk, energy, num, Hm, g);
  return static_cast<int>(cudaGetLastError());
}

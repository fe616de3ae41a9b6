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
// Pass 1 is track_partial.cuh (one thread per candidate and point, one
// 46-vector per block; the 12-wide corner pack of the JAX package was a TPU
// gather trick and is not kept); pass 2 sums a candidate's block vectors in
// index order. The LM loop runs K6 inside track_lm.cu; this entry point
// serves the single evaluations (the level-0 statistics, calc_res_eval).
//
// Bound: launch latency at the tracker's sizes (at most 42,496 points x 15
// candidates, ~1 MB of point data and the level planes from L2); the work
// per point is ~150 flops. A simple form is enough for now.
#include "track_partial.cuh"

namespace {

__global__ void track_final_kernel(const float* __restrict__ partial,
                                   int nblk, float* __restrict__ energy,
                                   float* __restrict__ num,
                                   float* __restrict__ Hm,
                                   float* __restrict__ g) {
  const int b = blockIdx.x, k = threadIdx.x;
  if (k >= kAcc) return;
  const float s = sum_partials(partial, b, nblk, k);
  if (k == 0) {
    energy[b] = s;
  } else if (k == 1) {
    num[b] = s;
  } else if (k < 38) {
    int i, j;
    tri_index(k - 2, &i, &j);
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
  if (B <= 0 || nblk != num_blocks(N)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  track_partial_kernel<<<dim3(nblk, B), kThreads, 0, stream>>>(
      pu, pv, pid, pcol, pvalid, T, aff, nullptr, nullptr, img, gx, gy, N, H,
      W, fx, fy, cx, cy, cutoff, huber, partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  track_final_kernel<<<B, 64, 0, stream>>>(partial, nblk, energy, num, Hm, g);
  return static_cast<int>(cudaGetLastError());
}

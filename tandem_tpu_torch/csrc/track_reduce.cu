// Kernel K6: the coarse tracker's photometric residuals and 8x8 normal
// equations, summed over one pyramid level's point list for B candidate
// poses, in the Huber + cutoff or the Student-t weighting of
// _energy_and_system.
//
// Replaces tandem_tpu/tracking/coarse_tracker.py _energy_and_system
// (:348, with _tdist_weights :314, _level_residuals :259 and
// _bilinear_with_grad :235), which the JAX package leaves to XLA (an einsum
// over the point list; it is not a Pallas kernel). The reference ran the
// same reduction as a CUDA kernel of 45 accumulators
// (libdr cuda_coarse_tracker_private.cu:261-445).
//
// One launch a call: candidate b is one cluster of track_partial.cuh's
// evaluation; its CTA of rank 0 writes e, n, H (both triangles) and g. The
// LM kernel (track_lm.cu) runs the same evaluation at every step, so its
// sums at a pose equal K6's at that pose bit for bit; this entry point
// serves the single evaluations (the level-0 statistics, calc_res_eval).
//
// Bound: at the tracker's sizes (at most 42,496 points x 15 candidates)
// ~1 MB of point data and the level planes from L2 and ~180 flops per
// point and candidate (~250 with the t weights): a few microseconds of
// the card; what the design removes is the second launch and its scratch.
#include "track_partial.cuh"

namespace {

template <bool kTdist>
__global__ void __launch_bounds__(kThreads, 1)
    track_reduce_kernel(Level L, Plan plan, const float* __restrict__ T,
                        const float* __restrict__ aff,
                        float* __restrict__ energy, float* __restrict__ num,
                        float* __restrict__ Hm, float* __restrict__ g) {
  extern __shared__ float4 smem[];
  __shared__ float warp_sums[kWarps][kAcc];
  __shared__ float cta[2][kAcc];
  __shared__ float total[kAcc];
  cg::cluster_group cluster = cg::this_cluster();
  const int b = blockIdx.y;
  const unsigned rank = cluster.block_rank();
  const Share s = make_share(L, plan, rank, smem);
  Reducer R{warp_sums, cta, total, 0};
  evaluate<kTdist>(L, s, load_pose(T + 16 * b, aff + 2 * b), R);
  const int k = threadIdx.x;
  if (rank == 0 && k < kAcc) {
    const float v = total[k];
    if (k == 0) {
      energy[b] = v;
    } else if (k == 1) {
      num[b] = v;
    } else if (k < 38) {
      int i, j;
      tri_index(k - 2, &i, &j);
      Hm[b * 64 + i * 8 + j] = v;
      Hm[b * 64 + j * 8 + i] = v;
    } else {
      g[b * 8 + (k - 38)] = v;
    }
  }
  cluster.sync();  // no CTA leaves while another may read its vector
}

}  // namespace

// T: (B, 4, 4) f32; aff: (B, 2) f32; pu, pv, pid, pcol: (N,) f32;
// pvalid: (N,) bool; img, gx, gy: (H, W) f32; energy, num: (B,);
// Hm: (B, 8, 8); g: (B, 8). All contiguous on the current device. tdist
// selects the Student-t weighting (cutoff and huber are then unused).
// Launches one kernel on ``stream`` without synchronising; returns the
// launch's error, or cudaErrorInvalidValue for B <= 0 or a level whose
// t-mode r^2 does not fit a CTA's shared memory.
extern "C" int tandem_track_reduce(
    const float* T, const float* aff, int B, const float* pu, const float* pv,
    const float* pid, const float* pcol, const uint8_t* pvalid,
    const float* img, const float* gx, const float* gy, int64_t N, int H,
    int W, float fx, float fy, float cx, float cy, float cutoff, float huber,
    int tdist, float* energy, float* num, float* Hm, float* g,
    cudaStream_t stream) {
  Plan plan;
  if (B <= 0 || N < 0 || !make_plan(N, tdist != 0, &plan)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Level L{pu, pv, pid, pcol, pvalid, img, gx, gy, N,  H,
                W,  fx, fy,  cx,   cy,     cutoff, huber};
  auto kernel =
      tdist ? &track_reduce_kernel<true> : &track_reduce_kernel<false>;
  return static_cast<int>(launch_clusters(kernel, plan, B, stream, L, plan,
                                          T, aff, energy, num, Hm, g));
}

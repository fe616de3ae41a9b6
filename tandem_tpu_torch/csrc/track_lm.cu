// The coarse tracker's LM on one pyramid level, in one launch: residuals,
// normal equations, the damped 8x8 solve, the SE(3) update and the
// accept/reject of B <= 32 candidate poses until the level's loop ends,
// with no host read inside the level.
//
// Replaces tandem_tpu/tracking/coarse_tracker.py _lm_level (:382, the
// lax.while_loop of cond :394-397 and body :399-425, the n0 >= 32 rule
// :433-435) together with _energy_and_system (:348, both weightings),
// solve_gauss_jordan_batched (tandem_tpu/ops/linalg.py:64) and se3_exp
// (tandem_tpu/core/se3.py:63). The JAX package runs the loop inside one
// jitted program (XLA, not Pallas).
//
// Bound: the level's points and planes read once (at most 42,496 points x
// 17 B and three 640x480 f32 planes, ~4.4 MB, ~1.3 us at 3.35 TB/s) and
// ~180 flops per point, candidate and step (~250 with the t weights).
// What the design is for: the earlier form launched a pair of kernels a
// step and read the loop's condition back every 16 steps, so a 640x480
// frame was ~200 launches and the card idled ~90% of it.
//
// Design: candidate b is one thread-block cluster (track_partial.cuh's
// layout) that runs the whole while_loop for itself: evaluate at the
// proposal, reduce across the cluster, then every CTA judges, counts the
// step, sets the damping and proposes the next step from the same sums
// (redundantly, so nothing is broadcast), with the state in shared
// memory. The JAX loop's condition, it < max_iter and any(~done & lam <
// 1e4), couples the candidates; it is resolved after the fact, because a
// candidate's state after k steps does not depend on the others, a done
// candidate is frozen (it accepts nothing, keeps lam, and proposes the
// same step again), and once the condition is false nothing changes. So
// each cluster runs its candidate until it is done or out of steps and
// records its state after every step in a history (B, steps + 1, 128);
// the last cluster to finish (a __threadfence and an atomic counter,
// which it resets) finds K, the first step after which no candidate is
// live, and writes candidate b's state at min(K, its last step) with the
// n0 >= 32 rule, and it = K. Clusters need not be co-resident: B x C CTAs
// may run in waves.
//
// Exactness: the judge, the damped Gauss-Jordan (in the operation order of
// ops/linalg._gauss_jordan, lane c of a warp holding column c of [Hl | g])
// and se3_exp use round-to-nearest intrinsics without FMA contraction and
// keep se3_exp's Taylor switches in full f32; matrix products sum in index
// order. cuBLAS and the CPU sum 3x3/4x4 products in their own order, so
// the kernel matches the plain version to rounding, not bit for bit.
#include <cstddef>

#include "track_partial.cuh"

namespace {

constexpr int kMaxB = 32;  // ops/track_lm.py MAX_CANDIDATES
constexpr float kLam0 = 0.01f;
constexpr float kLamMax = 1e4f;
constexpr float kMinTerms = 32.0f;
constexpr int kOutFields = 20;  // T (16), aff (2), e, n

// One candidate's state: a record of the history (ops/track_lm.py
// RECORD_FIELDS). live = !done && lam < 1e4.
struct LmState {
  float T[16], aff[2], T_new[16], aff_new[2], dx[8], Hm[64], g[8];
  float lam, done, e, n, n0, live;
  float pad[6];
};
constexpr int kRecord = 128;
static_assert(sizeof(LmState) == kRecord * sizeof(float), "record layout");

// se3_exp (core/se3.py) of xi = (v, w): the top three rows of the 4x4.
__device__ void se3_exp(const float xi[6], float E[3][4]) {
  const float v[3] = {xi[0], xi[1], xi[2]};
  const float w[3] = {xi[3], xi[4], xi[5]};
  const float theta2 =
      add(add(mul(w[0], w[0]), mul(w[1], w[1])), mul(w[2], w[2]));
  const float theta = __fsqrt_rn(fmaxf(theta2, 1e-8f));
  const bool small = theta2 < 1e-5f;
  const float A =
      small ? sub(1.0f, dvd(theta2, 6.0f)) : dvd(sinf(theta), theta);
  const float B = small ? sub(0.5f, dvd(theta2, 24.0f))
                        : dvd(sub(1.0f, cosf(theta)), theta2);
  const float C = small ? sub(static_cast<float>(1.0 / 6.0),
                              dvd(theta2, 120.0f))
                        : dvd(sub(1.0f, A), theta2);
  const float Wm[3][3] = {
      {0.0f, -w[2], w[1]}, {w[2], 0.0f, -w[0]}, {-w[1], w[0], 0.0f}};
  float V[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float WW = add(add(mul(Wm[i][0], Wm[0][k]), mul(Wm[i][1], Wm[1][k])),
                           mul(Wm[i][2], Wm[2][k]));
      const float I = i == k ? 1.0f : 0.0f;
      E[i][k] = add(add(I, mul(A, Wm[i][k])), mul(B, WW));
      V[i][k] = add(add(I, mul(B, Wm[i][k])), mul(C, WW));
    }
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    E[i][3] = add(add(mul(V[i][0], v[0]), mul(V[i][1], v[1])),
                  mul(V[i][2], v[2]));
  }
}

// x of (Hm + lam diag(Hm) + 1e-5 I) x = g by unpivoted Gauss-Jordan on the
// 8x9 matrix [Hl | g] (ops/linalg._gauss_jordan, pivot floored at 1e-30):
// lane c < 9 of the warp holds column c, the other lanes carry zeros. Every
// lane of the warp must call it; every lane gets x.
__device__ void damped_solve(const float* Hm, const float* g, float lam,
                             int lane, float x[8]) {
  float col[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    col[i] = lane < 8 ? Hm[i * 8 + lane] : (lane == 8 ? g[i] : 0.0f);
    if (i == lane) col[i] = add(add(col[i], mul(lam, col[i])), 1e-5f);
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float pivot = __shfl_sync(kFull, col[j], j);
    const float safe = fabsf(pivot) > 1e-30f ? pivot : 1e-30f;
    const float row = dvd(col[j], safe);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float f = __shfl_sync(kFull, col[i], j);  // M[i][j] before step j
      if (i != j) col[i] = sub(col[i], mul(f, row));
    }
    col[j] = row;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) x[i] = __shfl_sync(kFull, col[i], 8);
}

// The sums of an evaluation as the state's e, n, H (both triangles), g.
__device__ void take_sums(LmState& s, const float* tot, int lane) {
  for (int m = lane; m < 36; m += 32) {
    int i, j;
    tri_index(m, &i, &j);
    s.Hm[i * 8 + j] = tot[2 + m];
    s.Hm[j * 8 + i] = tot[2 + m];
  }
  if (lane < 8) s.g[lane] = tot[38 + lane];
  if (lane == 0) {
    s.e = tot[0];
    s.n = tot[1];
  }
}

// The state after the level's first evaluation, at (T, aff) (warp 0).
__device__ void init_state(LmState& s, const float* T, const float* aff,
                           const float* tot, int lane) {
  float* f = reinterpret_cast<float*>(&s);
  for (int k = lane; k < kRecord; k += 32) f[k] = 0.0f;
  __syncwarp();
  if (lane < 16) s.T[lane] = s.T_new[lane] = T[lane];
  if (lane < 2) s.aff[lane] = s.aff_new[lane] = aff[lane];
  take_sums(s, tot, lane);
  if (lane == 0) {
    s.n0 = tot[1];
    s.lam = kLam0;
    s.live = 1.0f;
  }
  __syncwarp();
}

// Judge the proposal whose sums are ``tot`` (warp 0; the candidate is not
// done): accept if the normalised energy fell, converge on a tiny step or
// a tiny accepted gain, halve or quadruple lam (ops/track_lm.py
// lm_step_plain).
__device__ void judge(LmState& s, const float* tot, int lane) {
  const float e_old_n = dvd(s.e, fmaxf(s.n, 1.0f));
  const float e_new_n = dvd(tot[0], fmaxf(tot[1], 1.0f));
  const bool accept = e_new_n < e_old_n;
  float step = 0.0f;
#pragma unroll
  for (int i = 0; i < 8; ++i) step = fmaxf(step, fabsf(s.dx[i]));
  const bool small =
      step < 1e-5f || (accept && sub(e_old_n, e_new_n) <
                                     mul(1e-4f, fmaxf(e_old_n, 1e-6f)));
  const float lam = mul(s.lam, accept ? 0.5f : 4.0f);
  __syncwarp();  // every lane has read the state
  if (accept) {
    if (lane < 16) s.T[lane] = s.T_new[lane];
    if (lane < 2) s.aff[lane] = s.aff_new[lane];
    take_sums(s, tot, lane);
  }
  if (lane == 0) {
    s.lam = lam;
    s.done = small ? 1.0f : 0.0f;
    s.live = !small && lam < kLamMax ? 1.0f : 0.0f;
  }
  __syncwarp();
}

// Propose: dx = -solve(Hl, g), T_new = se3_exp(dx[:6]) @ T, aff_new = aff
// + dx[6:] (warp 0).
__device__ void propose(LmState& s, int lane) {
  float x[8];
  damped_solve(s.Hm, s.g, s.lam, lane, x);
  if (lane == 0) {
    float dx[8], E[3][4];
#pragma unroll
    for (int i = 0; i < 8; ++i) dx[i] = -x[i];
    se3_exp(dx, E);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        s.T_new[i * 4 + k] =
            add(add(add(mul(E[i][0], s.T[k]), mul(E[i][1], s.T[4 + k])),
                    mul(E[i][2], s.T[8 + k])),
                mul(E[i][3], s.T[12 + k]));
      }
      s.T_new[12 + k] = s.T[12 + k];  // se3_exp's bottom row is (0, 0, 0, 1)
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) s.dx[i] = dx[i];
    s.aff_new[0] = add(s.aff[0], dx[6]);
    s.aff_new[1] = add(s.aff[1], dx[7]);
  }
  __syncwarp();
}

// The last cluster's tail (one CTA): K and the outputs.
__device__ void finish(const float* __restrict__ hist,
                       const float* __restrict__ last,
                       const float* __restrict__ T_in,
                       const float* __restrict__ aff_in, int it0,
                       int max_iter, int n_steps, float* __restrict__ out) {
  __shared__ int steps[kMaxB];
  __shared__ int K;
  const int B = gridDim.y, n_rec = n_steps + 1;
  if (threadIdx.x < B) {
    steps[threadIdx.x] = static_cast<int>(__ldcg(last + threadIdx.x));
  }
  if (threadIdx.x == 0) K = n_steps;
  __syncthreads();
  // K: the first step after which no candidate is live (the loop's
  // condition is false), or the steps taken.
  for (int k = threadIdx.x; k <= n_steps; k += kThreads) {
    bool any = false;
    if (it0 + k < max_iter) {
      for (int c = 0; c < B; ++c) {
        if (k <= steps[c]) {
          const float* rec =
              hist + (static_cast<int64_t>(c) * n_rec + k) * kRecord;
          any |= __ldcg(rec + offsetof(LmState, live) / 4) != 0.0f;
        }
      }
    }
    if (!any) atomicMin(&K, k);
  }
  __syncthreads();
  for (int j = threadIdx.x; j < B * kOutFields; j += kThreads) {
    const int c = j / kOutFields, f = j % kOutFields;
    const int k = K < steps[c] ? K : steps[c];
    const float* rec = hist + (static_cast<int64_t>(c) * n_rec + k) * kRecord;
    const bool enough =
        __ldcg(rec + offsetof(LmState, n0) / 4) >= kMinTerms;
    if (f < 16) {
      out[c * 16 + f] = enough ? __ldcg(rec + f) : T_in[c * 16 + f];
    } else if (f < 18) {
      out[16 * B + c * 2 + f - 16] =
          enough ? __ldcg(rec + offsetof(LmState, aff) / 4 + f - 16)
                 : aff_in[c * 2 + f - 16];
    } else if (f == 18) {
      out[18 * B + c] = __ldcg(rec + offsetof(LmState, e) / 4);
    } else {
      out[19 * B + c] = __ldcg(rec + offsetof(LmState, n) / 4);
    }
  }
  if (threadIdx.x == 0) out[20 * B] = static_cast<float>(it0 + K);
}

// Grid (C, B), clusters (C, 1, 1). state_in null: the level's first
// evaluation at (T_in, aff_in) starts the state; otherwise candidate b
// starts from record b of state_in after it0 steps. Takes at most n_steps
// steps (n_steps <= max_iter - it0).
template <bool kTdist>
__global__ void __launch_bounds__(kThreads, 1)
    track_lm_kernel(Level L, Plan plan, const float* __restrict__ T_in,
                    const float* __restrict__ aff_in,
                    const float* __restrict__ state_in, int it0,
                    int max_iter, int n_steps, float* __restrict__ hist,
                    float* __restrict__ last, unsigned* __restrict__ counter,
                    float* __restrict__ out) {
  extern __shared__ float4 smem[];
  __shared__ float warp_sums[kWarps][kAcc];
  __shared__ float cta[2][kAcc];
  __shared__ float total[kAcc];
  __shared__ LmState s;
  __shared__ int is_last;
  cg::cluster_group cluster = cg::this_cluster();
  const int b = blockIdx.y, lane = threadIdx.x & 31;
  const bool warp0 = threadIdx.x < 32;
  const unsigned rank = cluster.block_rank();
  const Share share = make_share(L, plan, rank, smem);
  Reducer R{warp_sums, cta, total, 0};
  float* my_hist = hist + static_cast<int64_t>(b) * (n_steps + 1) * kRecord;

  if (state_in != nullptr) {
    if (threadIdx.x < kRecord) {
      reinterpret_cast<float*>(&s)[threadIdx.x] =
          state_in[b * kRecord + threadIdx.x];
    }
  } else {
    evaluate<kTdist>(L, share, load_pose(T_in + 16 * b, aff_in + 2 * b), R);
    if (warp0) {
      init_state(s, T_in + 16 * b, aff_in + 2 * b, total, lane);
      if (it0 < max_iter) propose(s, lane);
    }
  }
  __syncthreads();
  if (rank == 0 && threadIdx.x < kRecord) {
    my_hist[threadIdx.x] = reinterpret_cast<const float*>(&s)[threadIdx.x];
  }
  int k = 0;
  while (k < n_steps && s.done == 0.0f) {
    ++k;
    evaluate<kTdist>(L, share, load_pose(s.T_new, s.aff_new), R);
    if (warp0) {
      judge(s, total, lane);
      if (it0 + k < max_iter) propose(s, lane);
    }
    __syncthreads();
    if (rank == 0 && threadIdx.x < kRecord) {
      my_hist[k * kRecord + threadIdx.x] =
          reinterpret_cast<const float*>(&s)[threadIdx.x];
    }
  }
  cluster.sync();  // every CTA is done reading the others' vectors
  if (rank != 0) return;
  if (threadIdx.x == 0) last[b] = static_cast<float>(k);
  __threadfence();  // this candidate's records, before it is counted
  __syncthreads();
  if (threadIdx.x == 0) is_last = atomicAdd(counter, 1u) == gridDim.y - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  finish(hist, last, T_in, aff_in, it0, max_iter, n_steps, out);
  if (threadIdx.x == 0) atomicExch(counter, 0u);  // ready for the next call
}

}  // namespace

// T, aff: (B, 4, 4) and (B, 2) f32, the level's input; pu, pv, pid, pcol:
// (N,) f32; pvalid: (N,) bool; img, gx, gy: (H, W) f32; state_in: null,
// or (B, 128) records to start from after it0 steps; hist: f32 scratch of
// B * (n_steps + 1) * 128 + B (the history, then each candidate's last
// step); counter: one unsigned, 0 between calls, used by the calls of one
// stream only; out: f32 (B * 20 + 1): T (B, 4, 4), aff (B, 2), e (B,),
// n (B,), it. All contiguous on the current device. tdist selects the
// Student-t weighting. Launches one kernel on ``stream`` without
// synchronising; returns the launch's error, or cudaErrorInvalidValue.
extern "C" int tandem_track_lm(
    const float* T, const float* aff, int B, const float* pu, const float* pv,
    const float* pid, const float* pcol, const uint8_t* pvalid,
    const float* img, const float* gx, const float* gy, int64_t N, int H,
    int W, float fx, float fy, float cx, float cy, float cutoff, float huber,
    int tdist, const float* state_in, int it0, int max_iter, int n_steps,
    float* hist, unsigned* counter, float* out, cudaStream_t stream) {
  Plan plan;
  if (B <= 0 || B > kMaxB || N < 0 || it0 < 0 || n_steps < 0 ||
      it0 + n_steps > (max_iter > it0 ? max_iter : it0) ||
      !make_plan(N, tdist != 0, &plan)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Level L{pu, pv, pid, pcol, pvalid, img, gx, gy, N,  H,
                W,  fx, fy,  cx,   cy,     cutoff, huber};
  float* last = hist + static_cast<int64_t>(B) * (n_steps + 1) * kRecord;
  auto kernel = tdist ? &track_lm_kernel<true> : &track_lm_kernel<false>;
  return static_cast<int>(launch_clusters(kernel, plan, B, stream, L, plan,
                                          T, aff, state_in, it0, max_iter,
                                          n_steps, hist, last, counter, out));
}

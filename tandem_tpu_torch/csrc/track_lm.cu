// The coarse tracker's whole LM iteration on one pyramid level: residuals,
// normal equations, the damped 8x8 solve, the SE(3) update and the
// accept/reject of B <= 32 candidate poses, in two launches, with the
// level's state on the card.
//
// Replaces tandem_tpu/tracking/coarse_tracker.py _lm_level (:382, the
// lax.while_loop of cond :394-397 and body :399-425, the n0 >= 32 rule
// :433-435) together with _energy_and_system (:348, the Huber branch),
// solve_gauss_jordan_batched (tandem_tpu/ops/linalg.py:64) and se3_exp
// (tandem_tpu/core/se3.py:63). The JAX package runs the loop inside one
// jitted program (XLA, not Pallas).
//
// Bound: the level's points and planes read once (at most 42,496 points x
// 17 B and three 640x480 f32 planes, ~4.4 MB, ~1.3 us at 3.35 TB/s) and
// ~180 flops per point and candidate: far below one launch. What this
// design is for: eager PyTorch spent ~150 launches and one host sync on
// every iteration (the unrolled Gauss-Jordan, se3_exp, the selects, the
// loop condition); here an iteration is two launches and no sync:
//   pass 1  K6's partial pass (track_partial.cuh) at the proposal T_new,
//           leaving at once when the level is no longer active and skipping
//           candidates that are done;
//   pass 2  one block, one warp per candidate: sum the partials in block
//           order (as track_reduce.cu does, so the sums equal K6's), judge
//           the proposal (ops/track_lm.py lm_step_plain), count the step,
//           set the level's active flag, and propose the next step.
// The host launches pairs without reading anything back; once the active
// flag is off every further pair is a no-op.
//
// Exactness: the judge, the damped Gauss-Jordan (in the operation order of
// ops/linalg._gauss_jordan, lane c of a warp holding column c of [Hl | g])
// and se3_exp use round-to-nearest intrinsics without FMA contraction and
// keep se3_exp's Taylor switches in full f32; matrix products sum in index
// order. cuBLAS and the CPU sum 3x3/4x4 products in their own order, so
// the kernel matches the plain version to rounding, not bit for bit.
#include "track_partial.cuh"

namespace {

constexpr int kMaxB = 32;  // ops/track_lm.py MAX_CANDIDATES
constexpr unsigned kFull = 0xffffffffu;
constexpr float kLam0 = 0.01f;
constexpr float kLamMax = 1e4f;

// The level's state (ops/track_lm.py _FIELDS): f32 blocks over the B
// candidates, then flags = (it, active).
struct LmState {
  float *T, *aff, *T_new, *aff_new, *dx, *Hm, *g, *lam, *done, *e, *n, *n0,
      *flags;
  __host__ __device__ LmState(float* base, int B)
      : T(base), aff(T + 16 * B), T_new(aff + 2 * B),
        aff_new(T_new + 16 * B), dx(aff_new + 2 * B), Hm(dx + 8 * B),
        g(Hm + 64 * B), lam(g + 8 * B), done(lam + B), e(done + B),
        n(e + B), n0(n + B), flags(n0 + B) {}
};

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

// Pass 2: one block of B warps. init: the level's first evaluation (at the
// input T_in, aff_in) becomes the state, lam = 0.01, done = 0, it = 0.
// Otherwise, unless the level is inactive: judge the proposal, it += 1.
// Then active = it < max_iter and any(!done & lam < 1e4), and if active
// every candidate proposes its next step.
__global__ void __launch_bounds__(32 * kMaxB)
    track_lm_kernel(const float* __restrict__ partial, int nblk,
                    float* __restrict__ state, int B, int max_iter, int init,
                    const float* __restrict__ T_in,
                    const float* __restrict__ aff_in) {
  const LmState s(state, B);
  if (!init && s.flags[1] == 0.0f) return;  // converged: a no-op
  __shared__ float sums[kMaxB][kAcc];
  __shared__ int active;
  const int b = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool was_done = !init && s.done[b] != 0.0f;
  if (!was_done) {
    for (int k = lane; k < kAcc; k += 32) {
      sums[b][k] = sum_partials(partial, b, nblk, k);
    }
  }
  __syncwarp();

  // Judge (every lane alike; the writes wait until all lanes have read).
  bool accept = init, small = false;
  if (!init && !was_done) {
    const float e_old_n = dvd(s.e[b], fmaxf(s.n[b], 1.0f));
    const float e_new_n = dvd(sums[b][0], fmaxf(sums[b][1], 1.0f));
    accept = e_new_n < e_old_n;
    float step = 0.0f;
#pragma unroll
    for (int i = 0; i < 8; ++i) step = fmaxf(step, fabsf(s.dx[b * 8 + i]));
    small = step < 1e-5f ||
            (accept && sub(e_old_n, e_new_n) <
                           mul(1e-4f, fmaxf(e_old_n, 1e-6f)));
  }
  const float lam = init ? kLam0
                         : (was_done ? s.lam[b]
                                     : mul(s.lam[b], accept ? 0.5f : 4.0f));
  __syncwarp();
  if (accept) {
    const float* Ts = init ? T_in + b * 16 : s.T_new + b * 16;
    const float* As = init ? aff_in + b * 2 : s.aff_new + b * 2;
    if (lane < 16) s.T[b * 16 + lane] = Ts[lane];
    if (lane < 2) s.aff[b * 2 + lane] = As[lane];
    for (int m = lane; m < 36; m += 32) {
      int i, j;
      tri_index(m, &i, &j);
      s.Hm[b * 64 + i * 8 + j] = sums[b][2 + m];
      s.Hm[b * 64 + j * 8 + i] = sums[b][2 + m];
    }
    if (lane < 8) s.g[b * 8 + lane] = sums[b][38 + lane];
    if (lane == 0) {
      s.e[b] = sums[b][0];
      s.n[b] = sums[b][1];
    }
  }
  if (init) {  // the proposal before the first solve is the input itself
    if (lane < 16) s.T_new[b * 16 + lane] = T_in[b * 16 + lane];
    if (lane < 2) s.aff_new[b * 2 + lane] = aff_in[b * 2 + lane];
    if (lane < 8) s.dx[b * 8 + lane] = 0.0f;
    if (lane == 0) s.n0[b] = sums[b][1];
  }
  if (lane == 0) {
    s.lam[b] = lam;
    s.done[b] = (was_done || small) ? 1.0f : 0.0f;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const int it = init ? 0 : static_cast<int>(s.flags[0]) + 1;
    bool any = false;
    for (int c = 0; c < B; ++c) any |= s.done[c] == 0.0f && s.lam[c] < kLamMax;
    active = it < max_iter && any;
    s.flags[0] = static_cast<float>(it);
    s.flags[1] = active ? 1.0f : 0.0f;
  }
  __syncthreads();
  if (!active) return;

  // Propose: dx = -solve(Hl, g), T_new = se3_exp(dx[:6]) @ T,
  // aff_new = aff + dx[6:].
  float x[8];
  damped_solve(s.Hm + b * 64, s.g + b * 8, s.lam[b], lane, x);
  if (lane != 0) return;
  float dx[8], E[3][4];
#pragma unroll
  for (int i = 0; i < 8; ++i) dx[i] = -x[i];
  se3_exp(dx, E);
  const float* Tb = s.T + b * 16;
  float* Tn = s.T_new + b * 16;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      Tn[i * 4 + k] = add(add(add(mul(E[i][0], Tb[k]), mul(E[i][1], Tb[4 + k])),
                              mul(E[i][2], Tb[8 + k])),
                          mul(E[i][3], Tb[12 + k]));
    }
    Tn[12 + k] = Tb[12 + k];  // se3_exp's bottom row is (0, 0, 0, 1)
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) s.dx[b * 8 + i] = dx[i];
  s.aff_new[b * 2] = add(s.aff[b * 2], dx[6]);
  s.aff_new[b * 2 + 1] = add(s.aff[b * 2 + 1], dx[7]);
}

}  // namespace

// pu, pv, pid, pcol: (N,) f32; pvalid: (N,) bool; T, aff: (B, 4, 4) and
// (B, 2) f32, the level's input (read by the init launch only); img, gx,
// gy: (H, W) f32; partial: (B, nblk, 46) f32 scratch with nblk =
// max(ceil(N / 1024), 1); state: the level's f32 state (ops/track_lm.py
// new_state), written in full by the init launch. All contiguous on the
// current device. Launches, on ``stream`` and without synchronising, the
// init pair when ``init`` and then ``n_steps`` step pairs; returns the
// first launch error, or 0.
extern "C" int tandem_track_lm(
    const float* pu, const float* pv, const float* pid, const float* pcol,
    const uint8_t* pvalid, const float* T, const float* aff, const float* img,
    const float* gx, const float* gy, int64_t N, int B, int H, int W,
    float fx, float fy, float cx, float cy, float cutoff, float huber,
    float* partial, int nblk, float* state, int max_iter, int init,
    int n_steps, cudaStream_t stream) {
  if (B <= 0 || B > kMaxB || nblk != num_blocks(N) || n_steps < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const LmState s(state, B);
  const dim3 grid(nblk, B);
  for (int step = init ? -1 : 0; step < n_steps; ++step) {
    const bool first = step < 0;
    track_partial_kernel<<<grid, kThreads, 0, stream>>>(
        pu, pv, pid, pcol, pvalid, first ? T : s.T_new,
        first ? aff : s.aff_new, first ? nullptr : s.flags + 1,
        first ? nullptr : s.done, img, gx, gy, N, H, W, fx, fy, cx, cy,
        cutoff, huber, partial);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    track_lm_kernel<<<1, 32 * B, 0, stream>>>(partial, nblk, state, B,
                                              max_iter, first ? 1 : 0, T, aff);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

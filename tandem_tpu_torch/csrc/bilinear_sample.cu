// Bilinear sample of an NHWC image, straight from the image: positions ->
// four corners -> blend, in one launch. Two position modes:
//   plane sweep (tandem_warp_sample): the positions of every reference
//     pixel and depth hypothesis are computed here from the 3x4 ref->src
//     matrix and the depth, and the output is the warped volume
//     (B, D, H, W, C);
//   explicit (tandem_bilinear_sample): the positions are given, (B, N).
// And the plane sweep's gradient with respect to the image
// (tandem_warp_sample_grad, at the end of the file): the same cells,
// scattered with atomics.
//
// Replaces on the main path the TPU kernels experiments/bench_idxchain.py
// make_pallas (P5, the bilinear index chain) and
// experiments/pallas_gather_probe.py make_pallas_fused (P3, the
// packed-corner gather and blend), and the position math of
// tandem_tpu/ops/warp.py:96-116 (XLA). On the TPU the chain and the gather
// are two kernels around a packed-corner table 4x as wide as the image, a
// VMEM gather trick. Here the image (2.5-9.8 MB a view at the abl04
// stages) lives in the 50 MB L2: the four corners are read from it
// directly, and no position, row, weight or table reaches device memory.
//
// Bound: memory, by the write of the output (C values a sample) and the
// read of the depth; the image is read once from device memory and then
// from L2/L1. What the design does about it:
// - one warp takes 32 consecutive samples of a row of one plane. Lane l
//   computes the position, the four weights and the cell of sample l
//   once (~80 instructions, two IEEE divisions in sweep mode), then the
//   warp walks its 32 samples in L = C / VEC rounds of 32 (sample,
//   channel chunk) items, taking each sample's numbers from its lane by
//   __shfl_sync. Neighbouring lanes store neighbouring 16-byte chunks, so
//   each round writes 512 contiguous bytes;
// - a corner pair (y, x), (y, x + 1) is one contiguous 2C segment of the
//   image, read by the sample's L lanes through the read-only path
//   (__ldg); neighbouring samples share corners, so L1 serves most reads;
// - in sweep mode a warp walks planes_per_warp (<= 4) consecutive depth
//   planes of its 32 pixels and loads all their depths before it samples
//   the first: the kernel is latency-bound where a plane has few rounds
//   (L = 1-4 at stages 2 and 3), and one depth load a plane in turn cost a
//   DRAM latency each; consecutive planes of a pixel read nearby corners;
// - a corner outside the image reads 16 zero bytes (kZeros), not a
//   predicated load into zero-filled registers, and a sample of one lane
//   (L = 1) takes its own numbers without shuffles: both cut instructions,
//   which is what holds the bf16 sweep back (the exact blend is 7 f32
//   operations a channel, without FMA, plus the bf16 unpacking);
// - the grid is (W tiles, H tiles, plane groups) with 8 warps a block,
//   covering rows_per_block rows of the reference.
//
// Exactness: the arithmetic is the plain version's (ops/bilinear_sample.py)
// in its order, with __fmul_rn/__fadd_rn/__fsub_rn/__fdiv_rn so nvcc
// contracts nothing: dir_i = (r_i0 x + r_i1 y) + r_i2, p_i = dir_i d + t_i,
// z clamped away from 0 at 1e-12, px = p0 / z, py = p1 / z, samples with
// z < min_depth dropped; then floor, x - x0, 1 - w, the in-bounds test,
// (wx0 wy0) ins, one rounding of each weight to the image type, and the
// blend ((g00 w00 + g10 w10) + g01 w01) + g11 w11 in f32, rounded once at
// the store. The corners are those of the clamped cell, zero outside the
// image: the values the padded packed-corner table holds. So the kernel
// equals the plain version bit for bit for finite inputs, in f32 and bf16.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kMaxPlanes = 4;  // depth planes a warp, at most
constexpr unsigned kFull = 0xffffffffu;
__device__ __align__(16) float kZeros[4];  // the value of a corner outside

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <int BYTES>
struct Raw;
template <>
struct Raw<16> {
  using type = uint4;
};
template <>
struct Raw<8> {
  using type = uint2;
};
template <>
struct Raw<4> {
  using type = unsigned int;
};
template <>
struct Raw<2> {
  using type = unsigned short;
};

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Vec {
  T v[VEC];
};

// VEC values at p (aligned to the vector) through the read-only path.
template <typename T, int VEC>
__device__ __forceinline__ Vec<T, VEC> load(const T* p) {
  using R = typename Raw<sizeof(T) * VEC>::type;
  union {
    R raw;
    Vec<T, VEC> vec;
  } u;
  u.raw = __ldg(reinterpret_cast<const R*>(p));
  return u.vec;
}

// a rounded once to T (round to nearest even), two values an instruction
// in bf16.
template <typename T, int VEC>
__device__ __forceinline__ Vec<T, VEC> round_vec(const float (&a)[VEC]) {
  Vec<T, VEC> o;
  if constexpr (sizeof(T) == 2 && VEC % 2 == 0) {
#pragma unroll
    for (int e = 0; e < VEC; e += 2) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(a[e], a[e + 1]);
      o.v[e] = h.x;
      o.v[e + 1] = h.y;
    }
  } else {
#pragma unroll
    for (int e = 0; e < VEC; ++e) o.v[e] = from_f32<T>(a[e]);
  }
  return o;
}

// One sample's weights (rounded to the image type) and its clamped cell
// (x0 + 1) | (y0 + 1) << 16, x0 in [-1, W-1] and y0 in [-1, H-1].
struct Cell {
  float w00, w10, w01, w11;
  int xy;
};

template <typename T>
__device__ __forceinline__ Cell make_cell(float px, float py, bool kept,
                                          int H, int W) {
  const float x0 = floorf(px);
  const float y0 = floorf(py);
  const float wx1 = __fsub_rn(px, x0);
  const float wy1 = __fsub_rn(py, y0);
  const float wx0 = __fsub_rn(1.0f, wx1);
  const float wy0 = __fsub_rn(1.0f, wy1);
  const float xmax = static_cast<float>(W - 1);
  const float ymax = static_cast<float>(H - 1);
  // Cells whose floor lies beyond the 1-pixel pad have every corner
  // outside the image: their weights are exactly zero.
  const bool inside =
      kept && x0 >= -1.0f && x0 <= xmax && y0 >= -1.0f && y0 <= ymax;
  const float ins = inside ? 1.0f : 0.0f;
  Cell c;
  c.w00 = to_f32(from_f32<T>(__fmul_rn(__fmul_rn(wx0, wy0), ins)));
  c.w10 = to_f32(from_f32<T>(__fmul_rn(__fmul_rn(wx1, wy0), ins)));
  c.w01 = to_f32(from_f32<T>(__fmul_rn(__fmul_rn(wx0, wy1), ins)));
  c.w11 = to_f32(from_f32<T>(__fmul_rn(__fmul_rn(wx1, wy1), ins)));
  const int xc = static_cast<int>(fminf(fmaxf(x0, -1.0f), xmax)) + 1;
  const int yc = static_cast<int>(fminf(fmaxf(y0, -1.0f), ymax)) + 1;
  c.xy = xc | (yc << 16);
  return c;
}

__device__ __forceinline__ Cell shfl_cell(const Cell& c, int src) {
  Cell o;
  o.w00 = __shfl_sync(kFull, c.w00, src);
  o.w10 = __shfl_sync(kFull, c.w10, src);
  o.w01 = __shfl_sync(kFull, c.w01, src);
  o.w11 = __shfl_sync(kFull, c.w11, src);
  o.xy = __shfl_sync(kFull, c.xy, src);
  return o;
}

// Channels [c, c + VEC) of one sample: the four corners (zero outside the
// image), blended in f32, rounded once, stored at dst.
template <typename T, int VEC>
__device__ __forceinline__ void blend(const T* __restrict__ image,
                                      const Cell& s, int c, int H, int W,
                                      int C, T* __restrict__ dst) {
  using V = Vec<T, VEC>;
  const int x = (s.xy & 0xffff) - 1;
  const int y = (s.xy >> 16) - 1;
  // A corner outside the image reads 16 zero bytes: no predicated loads
  // and no zero fill of the registers.
  const T* zero = reinterpret_cast<const T*>(kZeros);
  const bool x0in = x >= 0, x1in = x + 1 < W;
  const bool y0in = y >= 0, y1in = y + 1 < H;
  const int off = (y * W + x) * C + c;  // the image has < 2^31 values
  const V g00 = load<T, VEC>(y0in && x0in ? image + off : zero);
  const V g10 = load<T, VEC>(y0in && x1in ? image + off + C : zero);
  const V g01 = load<T, VEC>(y1in && x0in ? image + off + W * C : zero);
  const V g11 = load<T, VEC>(y1in && x1in ? image + off + W * C + C : zero);
  float a[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    float t = __fmul_rn(to_f32(g00.v[e]), s.w00);
    t = __fadd_rn(t, __fmul_rn(to_f32(g10.v[e]), s.w10));
    t = __fadd_rn(t, __fmul_rn(to_f32(g01.v[e]), s.w01));
    a[e] = __fadd_rn(t, __fmul_rn(to_f32(g11.v[e]), s.w11));
  }
  *reinterpret_cast<V*>(dst) = round_vec<T, VEC>(a);
}

// The warp's 32 samples (own: lane l's cell; n of them valid), written to
// out[j * C, (j + 1) * C) for sample j.
template <typename T, int VEC>
__device__ __forceinline__ void sample_row(const T* __restrict__ image,
                                           const Cell& own, int n, int lane,
                                           int H, int W, int C,
                                           T* __restrict__ out) {
  const int L = C / VEC;  // lanes a sample
  if (L == 1) {           // one round, each lane its own sample
    if (lane < n) blend<T, VEC>(image, own, 0, H, W, C, out + lane * C);
  } else if (32 % L == 0) {  // a round is 32 / L whole samples
    const int per = 32 / L;
    const int j0 = lane / L;
    const int c = (lane - j0 * L) * VEC;
#pragma unroll 2
    for (int k = 0; k < L; ++k) {
      const int j = j0 + k * per;
      const Cell s = shfl_cell(own, j);
      if (j < n) blend<T, VEC>(image, s, c, H, W, C, out + j * C + c);
    }
  } else {                // C / VEC = 3, 5, 6, 7, ... or > 32
#pragma unroll 2
    for (int t = lane; t < 32 * L; t += 32) {
      const int j = t / L;
      const int c = (t - j * L) * VEC;
      const Cell s = shfl_cell(own, j);
      if (j < n) blend<T, VEC>(image, s, c, H, W, C, out + j * C + c);
    }
  }
}

// The gradient of blend: grad_out's channels [c, c + VEC) of one sample
// (at src), times each corner's weight, added to the float32 image
// gradient at the corners that lie in the image and weigh more than zero.
template <typename T, int VEC>
__device__ __forceinline__ void scatter(float* __restrict__ grad,
                                        const Cell& s, int c, int H, int W,
                                        int C, const T* __restrict__ src) {
  const int x = (s.xy & 0xffff) - 1;
  const int y = (s.xy >> 16) - 1;
  const bool x0in = x >= 0, x1in = x + 1 < W;
  const bool y0in = y >= 0, y1in = y + 1 < H;
  const bool a00 = y0in && x0in && s.w00 != 0.0f;
  const bool a10 = y0in && x1in && s.w10 != 0.0f;
  const bool a01 = y1in && x0in && s.w01 != 0.0f;
  const bool a11 = y1in && x1in && s.w11 != 0.0f;
  if (!(a00 || a10 || a01 || a11)) return;  // dropped or outside
  const Vec<T, VEC> g = load<T, VEC>(src);
  const int off = (y * W + x) * C + c;  // the image has < 2^31 values
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    const float v = to_f32(g.v[e]);
    if (a00) atomicAdd(grad + off + e, __fmul_rn(v, s.w00));
    if (a10) atomicAdd(grad + off + C + e, __fmul_rn(v, s.w10));
    if (a01) atomicAdd(grad + off + W * C + e, __fmul_rn(v, s.w01));
    if (a11) atomicAdd(grad + off + W * C + C + e, __fmul_rn(v, s.w11));
  }
}

// sample_row's walk over the warp's 32 samples, scattering grad_out
// (gout: sample j's C values at gout[j * C]) into the image gradient.
template <typename T, int VEC>
__device__ __forceinline__ void scatter_row(float* __restrict__ grad,
                                            const Cell& own, int n, int lane,
                                            int H, int W, int C,
                                            const T* __restrict__ gout) {
  const int L = C / VEC;  // lanes a sample
  if (L == 1) {
    if (lane < n) scatter<T, VEC>(grad, own, 0, H, W, C, gout + lane * C);
  } else if (32 % L == 0) {
    const int per = 32 / L;
    const int j0 = lane / L;
    const int c = (lane - j0 * L) * VEC;
#pragma unroll 2
    for (int k = 0; k < L; ++k) {
      const int j = j0 + k * per;
      const Cell s = shfl_cell(own, j);
      if (j < n) scatter<T, VEC>(grad, s, c, H, W, C, gout + j * C + c);
    }
  } else {
#pragma unroll 2
    for (int t = lane; t < 32 * L; t += 32) {
      const int j = t / L;
      const int c = (t - j * L) * VEC;
      const Cell s = shfl_cell(own, j);
      if (j < n) scatter<T, VEC>(grad, s, c, H, W, C, gout + j * C + c);
    }
  }
}

// Geometry of one launch. Sweep: B images, D planes each, the reference
// grid H x W (the image's), planes_per_warp planes a warp. Explicit: B
// images, one plane of one row of N samples each, planes_per_warp 1.
struct Grid {
  int64_t D;
  int rows, cols, planes_per_warp;
  int H, W, C;  // the image
  int rows_per_block;
};

// A warp's share of a plane sweep: 32 consecutive pixels of one row of
// the reference (n of them in the image) over np consecutive planes from
// d0 of image b, and lane's cell on each plane. The forward kernel and the
// gradient kernel both take their samples from here, so they see the same
// positions, weights, cells and drop decisions, bit for bit.
struct SweepTile {
  int64_t b, d0, plane_size, pix;
  int lane, n, np;
  Cell cells[kMaxPlanes];
};

// Fills t for this warp; false if the warp has no pixel (uniform).
template <typename T>
__device__ __forceinline__ bool sweep_tile(const Grid& g,
                                           const float* __restrict__ mat,
                                           const float* __restrict__ depth,
                                           float min_depth, SweepTile& t) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps_per_row = kWarps / g.rows_per_block;
  const int row = blockIdx.y * g.rows_per_block + warp / warps_per_row;
  const int col0 = (blockIdx.x * warps_per_row + warp % warps_per_row) * 32;
  if (row >= g.rows || col0 >= g.cols) return false;  // whole warp
  const int64_t groups = (g.D + g.planes_per_warp - 1) / g.planes_per_warp;
  const int64_t b = blockIdx.z / groups;
  const int64_t d0 = (blockIdx.z - b * groups) * g.planes_per_warp;
  const int64_t d1 = min(d0 + g.planes_per_warp, g.D);
  const int col = col0 + lane;
  const bool valid = col < g.cols;
  const int n = min(32, g.cols - col0);
  const int64_t plane_size = static_cast<int64_t>(g.rows) * g.cols;
  const int64_t pix = static_cast<int64_t>(row) * g.cols + col;

  // The pixel's ray: dir_i = (r_i0 x + r_i1 y) + r_i2, and t_i.
  const float* m = mat + b * 12;
  const float x = static_cast<float>(col);
  const float y = static_cast<float>(row);
  float dir[3], tr[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    dir[i] = __fadd_rn(__fadd_rn(__fmul_rn(__ldg(m + 4 * i), x),
                                 __fmul_rn(__ldg(m + 4 * i + 1), y)),
                       __ldg(m + 4 * i + 2));
    tr[i] = __ldg(m + 4 * i + 3);
  }
  // All of the warp's depths first: one DRAM latency a warp, not one a
  // plane (a plane's rounds are too short to hide it).
  const float* dp = depth + (b * g.D + d0) * plane_size + pix;
  const int np = static_cast<int>(d1 - d0);
  float dv[kMaxPlanes];
#pragma unroll
  for (int k = 0; k < kMaxPlanes; ++k) {
    dv[k] = valid && k < np ? dp[k * plane_size] : 0.0f;
  }
  // Then every plane's cell (independent chains, two divisions each).
#pragma unroll
  for (int k = 0; k < kMaxPlanes; ++k) {
    t.cells[k] = Cell{0.0f, 0.0f, 0.0f, 0.0f, 0};
    if (valid && k < np) {
      float p[3];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        p[i] = __fadd_rn(__fmul_rn(dir[i], dv[k]), tr[i]);
      }
      const float z = p[2];
      const float zs = fabsf(z) < 1e-12f ? 1e-12f : z;
      t.cells[k] = make_cell<T>(__fdiv_rn(p[0], zs), __fdiv_rn(p[1], zs),
                                !(z < min_depth), g.H, g.W);
    }
  }
  t.b = b;
  t.d0 = d0;
  t.plane_size = plane_size;
  t.pix = pix;
  t.lane = lane;
  t.n = n;
  t.np = np;
  return true;
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kWarps * 32)
    warp_sample_kernel(const T* __restrict__ img, Grid g,
                       const float* __restrict__ mat,
                       const float* __restrict__ depth, float min_depth,
                       T* __restrict__ out) {
  SweepTile t;
  if (!sweep_tile<T>(g, mat, depth, min_depth, t)) return;
  const T* image = img + t.b * g.H * g.W * static_cast<int64_t>(g.C);
  // Then the planes' rounds.
  T* dst = out + ((t.b * g.D + t.d0) * t.plane_size + t.pix - t.lane) * g.C;
#pragma unroll
  for (int k = 0; k < kMaxPlanes; ++k) {
    if (k >= t.np) break;  // uniform
    sample_row<T, VEC>(image, t.cells[k], t.n, t.lane, g.H, g.W, g.C,
                       dst + k * t.plane_size * g.C);
  }
}

// The plane sweep's gradient with respect to the image: each sample's
// grad_out, times its four weights, added to its corners. Replaces the
// scatter-add that XLA derives from the gather of
// tandem_tpu/ops/warp.py:147-157 for jax.grad. Bound: memory, by the read
// of grad_out (C values a sample, read once, coalesced as the forward
// writes it) and the float32 atomics into the image gradient, which stays
// in the 50 MB L2 (2.5-9.8 MB a view at the abl04 stages). One thread a
// (sample, channel vector), up to 4 x VEC atomicAdds each; neighbouring
// samples hit neighbouring corners, so the atomics of a warp contend for
// the same L2 lines. The order of the additions changes from run to run:
// the gradient is not bit-reproducible, to a few float32 ulps of each sum.
template <typename T, int VEC>
__global__ void __launch_bounds__(kWarps * 32)
    warp_sample_grad_kernel(const T* __restrict__ grad_out, Grid g,
                            const float* __restrict__ mat,
                            const float* __restrict__ depth, float min_depth,
                            float* __restrict__ grad) {
  SweepTile t;
  if (!sweep_tile<T>(g, mat, depth, min_depth, t)) return;
  float* gimg = grad + t.b * g.H * g.W * static_cast<int64_t>(g.C);
  const T* src =
      grad_out + ((t.b * g.D + t.d0) * t.plane_size + t.pix - t.lane) * g.C;
#pragma unroll
  for (int k = 0; k < kMaxPlanes; ++k) {
    if (k >= t.np) break;  // uniform
    scatter_row<T, VEC>(gimg, t.cells[k], t.n, t.lane, g.H, g.W, g.C,
                        src + k * t.plane_size * g.C);
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kWarps * 32)
    bilinear_sample_kernel(const T* __restrict__ img, Grid g,
                           const float* __restrict__ pxs,
                           const float* __restrict__ pys,
                           const uint8_t* __restrict__ keep,
                           T* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int col0 = (blockIdx.x * kWarps + (threadIdx.x >> 5)) * 32;
  if (col0 >= g.cols) return;  // whole warp: uniform
  const int64_t b = blockIdx.z;
  const int col = col0 + lane;
  const int64_t i = b * g.cols + col;
  Cell own{0.0f, 0.0f, 0.0f, 0.0f, 0};
  if (col < g.cols) {
    own = make_cell<T>(pxs[i], pys[i], keep == nullptr || keep[i] != 0,
                       g.H, g.W);
  }
  sample_row<T, VEC>(img + b * g.H * g.W * static_cast<int64_t>(g.C), own,
                     min(32, g.cols - col0), lane, g.H, g.W, g.C,
                     out + (i - lane) * g.C);
}

dim3 grid_of(const Grid& g, int64_t planes) {
  const int warps_per_row = kWarps / g.rows_per_block;
  return dim3(static_cast<unsigned>((g.cols + 32 * warps_per_row - 1) /
                                    (32 * warps_per_row)),
              static_cast<unsigned>((g.rows + g.rows_per_block - 1) /
                                    g.rows_per_block),
              static_cast<unsigned>(planes));
}

// The two launches, as functors on the runtime (type, vector width).
struct SweepLaunch {
  const void* img;
  Grid g;
  int64_t B;
  const float* mat;
  const float* depth;
  float min_depth;
  void* out;
  cudaStream_t stream;
  template <typename T, int VEC>
  int run() const {
    const int64_t groups = (g.D + g.planes_per_warp - 1) / g.planes_per_warp;
    warp_sample_kernel<T, VEC><<<grid_of(g, B * groups), kWarps * 32, 0,
                                 stream>>>(static_cast<const T*>(img), g, mat,
                                           depth, min_depth,
                                           static_cast<T*>(out));
    return static_cast<int>(cudaGetLastError());
  }
};

struct GradLaunch {
  const void* grad_out;
  Grid g;
  int64_t B;
  const float* mat;
  const float* depth;
  float min_depth;
  float* grad;
  cudaStream_t stream;
  template <typename T, int VEC>
  int run() const {
    const int64_t groups = (g.D + g.planes_per_warp - 1) / g.planes_per_warp;
    warp_sample_grad_kernel<T, VEC><<<grid_of(g, B * groups), kWarps * 32, 0,
                                      stream>>>(
        static_cast<const T*>(grad_out), g, mat, depth, min_depth, grad);
    return static_cast<int>(cudaGetLastError());
  }
};

struct ExplicitLaunch {
  const void* img;
  Grid g;
  int64_t B;
  const float* px;
  const float* py;
  const uint8_t* keep;
  void* out;
  cudaStream_t stream;
  template <typename T, int VEC>
  int run() const {
    bilinear_sample_kernel<T, VEC><<<grid_of(g, B), kWarps * 32, 0,
                                     stream>>>(static_cast<const T*>(img), g,
                                               px, py, keep,
                                               static_cast<T*>(out));
    return static_cast<int>(cudaGetLastError());
  }
};

template <typename F>
int dispatch(int bf16, int vec, const F& f) {
  if (bf16) {
    switch (vec) {
      case 8: return f.template run<__nv_bfloat16, 8>();
      case 4: return f.template run<__nv_bfloat16, 4>();
      case 2: return f.template run<__nv_bfloat16, 2>();
      case 1: return f.template run<__nv_bfloat16, 1>();
    }
  } else {
    switch (vec) {  // 16 bytes of f32 is 4
      case 4: return f.template run<float, 4>();
      case 2: return f.template run<float, 2>();
      case 1: return f.template run<float, 1>();
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The launch limits and the int32 offsets inside one image (and the
// 16-bit cell coordinates of Cell::xy).
bool bad_geometry(int64_t H, int64_t W, int64_t C, int vec) {
  return H < 1 || W < 1 || C < 1 || vec < 1 || C % vec != 0 ||
         H >= 65535 || W >= 65535 || (H + 1) * (W + 1) * C >= (1LL << 31);
}

}  // namespace

// The arguments of each entry point, passed as one block (one ctypes
// argument instead of 13-15: a few µs of host time a launch). The
// wrapper (ops/bilinear_sample.py) packs them with a struct format of the
// same layout: pointers, then int64s, then int32s and floats, no padding.
struct SweepArgs {
  const void* img;     // (B, H, W, C) float32 (bf16 = 0) or bfloat16
  const float* mat;    // (B, 3, 4) float32 ref -> src pixel projection
  const float* depth;  // (B, D, H, W) float32
  void* out;           // (B, D, H, W, C) of img's type
  int64_t B, D;
  int H, W, C;
  int vec;             // channels a lane: C % vec == 0, vec x element size
                       // <= 16, img and out aligned to it
  int rows_per_block;  // 1, 2, 4 or 8
  int planes_per_warp;  // 1-4
  int bf16;
  float min_depth;
};
static_assert(sizeof(SweepArgs) == 80, "SweepArgs layout");

struct SampleArgs {
  const void* img;     // (B, H, W, C) as above
  const float* px;     // (B, N) float32
  const float* py;     // (B, N) float32
  const uint8_t* keep;  // (B, N) bytes (0 = drop) or null
  void* out;           // (B, N, C) of img's type
  int64_t B, N;
  int H, W, C, vec, bf16;
  int unused;
};
static_assert(sizeof(SampleArgs) == 80, "SampleArgs layout");

// Plane sweep: all arrays contiguous. Launches on ``stream`` without
// synchronising; returns cudaGetLastError().
extern "C" int tandem_warp_sample(const SweepArgs* a, cudaStream_t stream) {
  if (a->B <= 0 || a->D <= 0) return 0;
  const int planes = a->planes_per_warp, rows = a->rows_per_block;
  const int64_t groups = planes < 1 || planes > kMaxPlanes
                             ? 0
                             : (a->D + planes - 1) / planes;
  if (bad_geometry(a->H, a->W, a->C, a->vec) || groups < 1 ||
      a->B * groups > 65535 ||
      (rows != 1 && rows != 2 && rows != 4 && rows != 8)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Grid g{a->D, a->H, a->W, planes, a->H, a->W, a->C, rows};
  return dispatch(a->bf16, a->vec,
                  SweepLaunch{a->img, g, a->B, a->mat, a->depth,
                              a->min_depth, a->out, stream});
}

// Explicit positions: all arrays contiguous. Launches on ``stream``
// without synchronising; returns cudaGetLastError().
extern "C" int tandem_bilinear_sample(const SampleArgs* a,
                                      cudaStream_t stream) {
  if (a->B <= 0 || a->N <= 0) return 0;
  if (bad_geometry(a->H, a->W, a->C, a->vec) || a->B > 65535 ||
      a->N >= (1LL << 31) - 256) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Grid g{1, 1, static_cast<int>(a->N), 1, a->H, a->W, a->C, 1};
  return dispatch(a->bf16, a->vec,
                  ExplicitLaunch{a->img, g, a->B, a->px, a->py, a->keep,
                                 a->out, stream});
}

struct GradArgs {
  const void* grad_out;  // (B, D, H, W, C) float32 (bf16 = 0) or bfloat16
  const float* mat;      // (B, 3, 4) float32, as the forward's
  const float* depth;    // (B, D, H, W) float32, as the forward's
  float* grad;           // (B, H, W, C) float32, zeroed: the gradient's sums
  int64_t B, D;
  int H, W, C;
  int vec;               // channels a lane, as SweepArgs; grad_out aligned
  int rows_per_block;    // 1, 2, 4 or 8
  int planes_per_warp;   // 1-4
  int bf16;
  float min_depth;
};
static_assert(sizeof(GradArgs) == 80, "GradArgs layout");

// The plane sweep's image gradient: one launch of the scatter kernel,
// which adds into the zeroed float32 sums. All arrays contiguous.
// Launches on ``stream`` without synchronising; returns
// cudaGetLastError().
extern "C" int tandem_warp_sample_grad(const GradArgs* a,
                                       cudaStream_t stream) {
  if (a->B <= 0 || a->D <= 0) return 0;
  const int planes = a->planes_per_warp, rows = a->rows_per_block;
  const int64_t groups = planes < 1 || planes > kMaxPlanes
                             ? 0
                             : (a->D + planes - 1) / planes;
  if (bad_geometry(a->H, a->W, a->C, a->vec) || groups < 1 ||
      a->B * groups > 65535 ||
      (rows != 1 && rows != 2 && rows != 4 && rows != 8)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Grid g{a->D, a->H, a->W, planes, a->H, a->W, a->C, rows};
  return dispatch(a->bf16, a->vec,
                  GradLaunch{a->grad_out, g, a->B, a->mat, a->depth,
                             a->min_depth, a->grad, stream});
}

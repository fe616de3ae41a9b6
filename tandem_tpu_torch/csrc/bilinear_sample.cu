// Bilinear sample of an NHWC image, straight from the image: positions ->
// four corners -> blend, in one launch. Two position modes:
//   plane sweep (tandem_warp_sample): the positions of every reference
//     pixel and depth hypothesis are computed here from the 3x4 ref->src
//     matrix and the depth, and the output is the warped volume
//     (B, D, H, W, C);
//   explicit (tandem_bilinear_sample): the positions are given, (B, N).
// And the variance cost volume's step (tandem_warp_variance): the plane
// sweep's samples of one source view added straight into the running sum
// and sum of squares of the cost volume, in place, with no warped volume
// in device memory. And the correlation cost volume's step
// (tandem_warp_correlation): the plane sweep's samples of one source view
// multiplied by the reference's features and averaged over the channels,
// written as one float32 value a (plane, pixel). And the plane sweep's gradient with respect to the image
// (tandem_warp_sample_grad, at the end of the file): the same cells, each
// thread summing a run of one pixel's planes in registers and adding a
// sum to the image gradient with one vector atomic a corner where the
// run's cell changes.
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

// The running sums of a variance cost volume (tandem_warp_variance), of
// the warped volume's layout: the first source view writes its samples x
// and their squares, each later view adds them.
template <typename T>
struct VarianceSums {
  T* sum;
  T* sq;
  bool first;
};

// A blend's VEC channels stored at out + at: the warped volume's values,
// rounded once to T.
template <typename T, int VEC>
__device__ __forceinline__ void store(T* __restrict__ out, int at,
                                      const float (&a)[VEC]) {
  *reinterpret_cast<Vec<T, VEC>*>(out + at) = round_vec<T, VEC>(a);
}

// ... or added to the variance's sums: x = the blend rounded once to T,
// x x rounded once to T, and each sum + term rounded once to T (the plain
// version's roundings in its order; none in float32 but the operations').
template <typename T, int VEC>
__device__ __forceinline__ void store(const VarianceSums<T>& out, int at,
                                      const float (&a)[VEC]) {
  using V = Vec<T, VEC>;
  const V x = round_vec<T, VEC>(a);
  float s[VEC], q[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    s[e] = to_f32(x.v[e]);
    q[e] = to_f32(from_f32<T>(__fmul_rn(s[e], s[e])));
  }
  if (!out.first) {
    const V s0 = *reinterpret_cast<const V*>(out.sum + at);
    const V q0 = *reinterpret_cast<const V*>(out.sq + at);
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      s[e] = __fadd_rn(to_f32(s0.v[e]), s[e]);
      q[e] = __fadd_rn(to_f32(q0.v[e]), q[e]);
    }
  }
  *reinterpret_cast<V*>(out.sum + at) = round_vec<T, VEC>(s);
  *reinterpret_cast<V*>(out.sq + at) = round_vec<T, VEC>(q);
}

// The correlation's row of 32 samples: the reference's features at the
// warp's first pixel (the row's layout: sample j's channels at j * C) and
// the warp's scratch of partial sums, one a (sample, lane of VEC channels).
template <typename T>
struct CorrelationRow {
  const T* ref;
  float* partial;
};

// ... or multiplied by the reference's channels: x = the blend rounded
// once to T (the warped value), then the VEC products x r summed in channel
// order, ((x0 r0 + x1 r1) + x2 r2) + x3 r3, each product and sum rounded
// once in float32, into the scratch at at / VEC (sample j, lane c / VEC).
template <typename T, int VEC>
__device__ __forceinline__ void store(const CorrelationRow<T>& out, int at,
                                      const float (&a)[VEC]) {
  const Vec<T, VEC> x = round_vec<T, VEC>(a);
  const Vec<T, VEC> r = load<T, VEC>(out.ref + at);
  float p = __fmul_rn(to_f32(x.v[0]), to_f32(r.v[0]));
#pragma unroll
  for (int e = 1; e < VEC; ++e) {
    p = __fadd_rn(p, __fmul_rn(to_f32(x.v[e]), to_f32(r.v[e])));
  }
  out.partial[at / VEC] = p;
}

// Channels [c, c + VEC) of one sample: the four corners (zero outside the
// image), blended in f32, then stored at ``at`` of out (``store``).
template <typename T, int VEC, typename Out>
__device__ __forceinline__ void blend(const T* __restrict__ image,
                                      const Cell& s, int c, int H, int W,
                                      int C, const Out& out, int at) {
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
  store<T, VEC>(out, at, a);
}

// The warp's 32 samples (own: lane l's cell; n of them valid), stored at
// [j * C, (j + 1) * C) of out for sample j.
template <typename T, int VEC, typename Out>
__device__ __forceinline__ void sample_row(const T* __restrict__ image,
                                           const Cell& own, int n, int lane,
                                           int H, int W, int C,
                                           const Out& out) {
  const int L = C / VEC;  // lanes a sample
  if (L == 1) {           // one round, each lane its own sample
    if (lane < n) blend<T, VEC>(image, own, 0, H, W, C, out, lane * C);
  } else if (32 % L == 0) {  // a round is 32 / L whole samples
    const int per = 32 / L;
    const int j0 = lane / L;
    const int c = (lane - j0 * L) * VEC;
#pragma unroll 2
    for (int k = 0; k < L; ++k) {
      const int j = j0 + k * per;
      const Cell s = shfl_cell(own, j);
      if (j < n) blend<T, VEC>(image, s, c, H, W, C, out, j * C + c);
    }
  } else {                // C / VEC = 3, 5, 6, 7, ... or > 32
#pragma unroll 2
    for (int t = lane; t < 32 * L; t += 32) {
      const int j = t / L;
      const int c = (t - j * L) * VEC;
      const Cell s = shfl_cell(own, j);
      if (j < n) blend<T, VEC>(image, s, c, H, W, C, out, j * C + c);
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

// A reference pixel's ray in the source camera: dir_i = (r_i0 x + r_i1 y)
// + r_i2 and t_i, from the 3x4 ref->src matrix m.
struct Ray {
  float dir[3], t[3];
};

__device__ __forceinline__ Ray pixel_ray(const float* __restrict__ m,
                                         float x, float y) {
  Ray r;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    r.dir[i] = __fadd_rn(__fadd_rn(__fmul_rn(__ldg(m + 4 * i), x),
                                   __fmul_rn(__ldg(m + 4 * i + 1), y)),
                         __ldg(m + 4 * i + 2));
    r.t[i] = __ldg(m + 4 * i + 3);
  }
  return r;
}

// The cell of the ray's sample at depth d: p_i = dir_i d + t_i, z clamped
// away from 0 at 1e-12, px = p0 / z, py = p1 / z, dropped if z <
// min_depth. The forward kernel and the gradient kernel both take their
// samples from here, so they see the same positions, weights, cells and
// drop decisions, bit for bit.
template <typename T>
__device__ __forceinline__ Cell plane_cell(const Ray& r, float d,
                                           float min_depth, int H, int W) {
  float p[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) p[i] = __fadd_rn(__fmul_rn(r.dir[i], d), r.t[i]);
  const float z = p[2];
  const float zs = fabsf(z) < 1e-12f ? 1e-12f : z;
  return make_cell<T>(__fdiv_rn(p[0], zs), __fdiv_rn(p[1], zs),
                      !(z < min_depth), H, W);
}

// A warp's share of a plane sweep in the forward kernel: 32 consecutive
// pixels of one row of the reference (n of them in the image) over np
// consecutive planes from d0 of image b, and lane's cell on each plane.
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

  const Ray ray = pixel_ray(mat + b * 12, static_cast<float>(col),
                            static_cast<float>(row));
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
    t.cells[k] = valid && k < np
                     ? plane_cell<T>(ray, dv[k], min_depth, g.H, g.W)
                     : Cell{0.0f, 0.0f, 0.0f, 0.0f, 0};
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

// The variance cost volume's step for one source view: the plane sweep's
// samples, as warp_sample_kernel computes them, added to the running sum
// and sum of squares in place (written by the first view). The eager form
// writes the view's warped volume, squares it into a second and adds both
// to the sums: 6 passes over a (D, H, W, C) volume a view against 4 here
// (2 for the first view).
template <typename T, int VEC>
__global__ void __launch_bounds__(kWarps * 32)
    warp_variance_kernel(const T* __restrict__ img, Grid g,
                         const float* __restrict__ mat,
                         const float* __restrict__ depth, float min_depth,
                         VarianceSums<T> sums) {
  SweepTile t;
  if (!sweep_tile<T>(g, mat, depth, min_depth, t)) return;
  const T* image = img + t.b * g.H * g.W * static_cast<int64_t>(g.C);
  const int64_t at =
      ((t.b * g.D + t.d0) * t.plane_size + t.pix - t.lane) * g.C;
#pragma unroll
  for (int k = 0; k < kMaxPlanes; ++k) {
    if (k >= t.np) break;  // uniform
    const int64_t plane = at + k * t.plane_size * g.C;
    sample_row<T, VEC>(image, t.cells[k], t.n, t.lane, g.H, g.W, g.C,
                       VarianceSums<T>{sums.sum + plane, sums.sq + plane,
                                       sums.first});
  }
}

// The correlation cost volume's step for one source view: the plane
// sweep's samples, as warp_sample_kernel computes them, multiplied by the
// reference's features at the same pixel and averaged over the C channels,
// out(d, p) = (1 / C) sum_c ref(c, p) x(c, d, p): one float32 value a
// sample. The eager form writes the view's (D, H, W, C) warped volume and
// reads it back with the reference for the product and the channel sum (382
// MB a view at CasMVSNet's stage 1 of 1152 x 864); here only the (D, H, W)
// similarity is written. A sample's C channels lie on L = C / VEC lanes
// (sample_row's rounds): each lane sums its VEC products (``store``) into a
// per-warp scratch in shared memory (32 x L floats), and after the plane's
// rounds lane j sums sample j's L partials in lane order and divides by C.
// The channel order of the sum is therefore fixed by VEC:
//   (((p_0 + p_1) + p_2) + ... + p_{L-1}) / C, p_l = the VEC products of
// channels [l VEC, (l + 1) VEC) summed in order,
// which ops/bilinear_sample.warp_correlation_plain repeats in torch ops.
template <typename T, int VEC>
__global__ void __launch_bounds__(kWarps * 32)
    warp_correlation_kernel(const T* __restrict__ img, Grid g,
                            const float* __restrict__ mat,
                            const float* __restrict__ depth, float min_depth,
                            const T* __restrict__ ref,
                            float* __restrict__ out) {
  extern __shared__ float scratch[];  // kWarps x 32 x L partial sums
  SweepTile t;
  if (!sweep_tile<T>(g, mat, depth, min_depth, t)) return;
  const int L = g.C / VEC;
  float* partial = scratch + (threadIdx.x >> 5) * 32 * L;
  const T* image = img + t.b * g.H * g.W * static_cast<int64_t>(g.C);
  const int64_t pix0 = t.pix - t.lane;
  const CorrelationRow<T> row{ref + (t.b * t.plane_size + pix0) * g.C,
                              partial};
  float* dst = out + (t.b * g.D + t.d0) * t.plane_size + pix0;
  const float channels = static_cast<float>(g.C);
#pragma unroll
  for (int k = 0; k < kMaxPlanes; ++k) {
    if (k >= t.np) break;  // uniform
    sample_row<T, VEC>(image, t.cells[k], t.n, t.lane, g.H, g.W, g.C, row);
    __syncwarp();
    if (t.lane < t.n) {
      const float* mine = partial + t.lane * L;
      float s = mine[0];
      for (int l = 1; l < L; ++l) s = __fadd_rn(s, mine[l]);
      dst[k * t.plane_size + t.lane] = __fdiv_rn(s, channels);
    }
    __syncwarp();  // the next plane's rounds rewrite the scratch
  }
}

// The plane sweep's gradient with respect to the image: each sample's
// grad_out, times its four weights, added to its corners. Replaces the
// scatter-add that XLA derives from the gather of
// tandem_tpu/ops/warp.py:147-157 for jax.grad.
//
// Bound: memory, by the read of grad_out (C values a sample in front of
// the source camera with a corner in its image, read once, coalesced as
// the forward writes it); the image gradient (2.5-9.8 MB a view at the
// abl04 stages) stays in the 50 MB L2. A design with one thread a
// (sample, channel vector) issues 4 x C float32 atomics a sample and is
// bound by their number (136-172 G a second on the H100 at every stage):
// a golden stage-1 sweep puts 47 samples on a touched source cell. What
// this design does about it:
// - a thread keeps one (pixel, channel vector) and walks `planes`
//   consecutive depth planes of it (GradGrid::planes, chosen by the
//   wrapper from D and the card's SM count). While the sample's cell stays
//   the same it sums grad_out x weight into four register accumulators of
//   VEC floats; when the cell changes, and after its last plane, it adds
//   each sum with one atomic, and only for the corners that lie in the
//   image and weighed more than 0. A dropped sample, or one whose cell
//   lies outside, adds nothing, reads no grad_out and leaves the run as it
//   was. On the golden stage-1 sweep a pixel's 48 planes make ~12 runs
//   (the sample crosses cells along its epipolar line): 4.5x fewer float32
//   additions into memory (counted on the H100, CHANGES.md);
// - a lane sums VEC = 4 channels (one 16-byte float4), in f32 and bf16
//   alike (a bf16 lane reads 8 bytes of grad_out), and flushes a corner
//   with one float4 atomicAdd (sm_90's vector reduction on global memory):
//   4x fewer atomic operations again. Where grad_out's alignment leaves a
//   lane 2 or 1 channels (the wrapper's choice of VEC) the flush is one
//   float2 atomicAdd or scalar ones;
// - the lanes of a warp take consecutive (pixel, channel vector) items of
//   one plane, 32 / L pixels of L = C / VEC lanes, so each plane's read of
//   grad_out is one contiguous segment a warp (512 bytes in f32). Where L
//   divides 32 the cells are computed once a (pixel, plane), not once a
//   lane: in a round of L planes lane l computes the cell of pixel
//   l % (32 / L) on plane l / (32 / L) and the warp takes each plane's
//   cells from their lanes by __shfl_sync; the next round's depth is
//   loaded while this round runs. Otherwise (L = 3, 5, ... or > 32) each
//   lane computes its own pixel's cells;
// - kBatch planes' grad_out reads are issued before their sums, so that
//   several loads of a thread are in flight at once.
// The cells, weights and drop decisions are the forward's (plane_cell);
// the products are fused into the sums (fmaf). The order of the atomics
// changes from run to run: the gradient is not bit-reproducible, to a few
// float32 ulps of each sum.
constexpr int kBatch = 4;

// Geometry of a gradient launch: the image (= the reference grid) H x W x
// C, D planes; a thread walks `planes` consecutive planes; grid.y is the
// images x the `groups` plane groups. The image has < 2^31 values, so the
// indices within one plane are 32-bit.
struct GradGrid {
  int64_t D;
  int H, W, C, planes, groups;
};

// The corners of a sample's cell that lie in the image and weigh more
// than 0: bit 0 (x0, y0), bit 1 (x1, y0), bit 2 (x0, y1), bit 3 (x1, y1).
// None for a dropped sample (its weights are 0) or a cell outside.
__device__ __forceinline__ unsigned corner_bits(const Cell& s, int H,
                                                int W) {
  const int x = (s.xy & 0xffff) - 1;
  const int y = (s.xy >> 16) - 1;
  const bool x0in = x >= 0, x1in = x + 1 < W;
  const bool y0in = y >= 0, y1in = y + 1 < H;
  return (y0in && x0in && s.w00 != 0.0f ? 1u : 0u) |
         (y0in && x1in && s.w10 != 0.0f ? 2u : 0u) |
         (y1in && x0in && s.w01 != 0.0f ? 4u : 0u) |
         (y1in && x1in && s.w11 != 0.0f ? 8u : 0u);
}

// VEC float32 sums added at p (aligned to VEC floats) by one atomic: the
// float4 / float2 atomicAdd on global memory of compute capability 9.x
// (sm_90_rt.h), or scalar atomics for one channel.
template <int VEC>
__device__ __forceinline__ void atomic_add(float* p, const float (&a)[VEC]) {
  if constexpr (VEC == 4) {
    atomicAdd(reinterpret_cast<float4*>(p),
              make_float4(a[0], a[1], a[2], a[3]));
  } else if constexpr (VEC == 2) {
    atomicAdd(reinterpret_cast<float2*>(p), make_float2(a[0], a[1]));
  } else {
#pragma unroll
    for (int e = 0; e < VEC; ++e) atomicAdd(p + e, a[e]);
  }
}

// A thread's run of samples on one cell: each corner's sum of grad_out x
// weight, the corners to add (corner_bits of the run's samples), the cell.
template <int VEC>
struct Run {
  float a[4][VEC];
  unsigned bits;
  int xy;
};

// The run's sums added to the image gradient (grad: this thread's channel
// vector of pixel (0, 0)).
template <int VEC>
__device__ __forceinline__ void flush(const Run<VEC>& r,
                                      float* __restrict__ grad, int W,
                                      int C) {
  if (r.bits == 0) return;
  const int x = (r.xy & 0xffff) - 1;
  const int y = (r.xy >> 16) - 1;
  float* p = grad + (y * W + x) * C;  // the image has < 2^31 values
  if (r.bits & 1u) atomic_add<VEC>(p, r.a[0]);
  if (r.bits & 2u) atomic_add<VEC>(p + C, r.a[1]);
  if (r.bits & 4u) atomic_add<VEC>(p + W * C, r.a[2]);
  if (r.bits & 8u) atomic_add<VEC>(p + W * C + C, r.a[3]);
}

// A live sample (bits != 0, g its grad_out) into the run; a new cell
// flushes the run first and starts the next.
template <typename T, int VEC>
__device__ __forceinline__ void add_sample(Run<VEC>& r, const Cell& s,
                                           unsigned bits,
                                           const Vec<T, VEC>& g,
                                           float* __restrict__ grad, int W,
                                           int C) {
  if (s.xy != r.xy) {
    flush<VEC>(r, grad, W, C);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) r.a[q][e] = 0.0f;
    }
    r.bits = 0;
    r.xy = s.xy;
  }
  r.bits |= bits;
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    const float v = to_f32(g.v[e]);
    r.a[0][e] = fmaf(v, s.w00, r.a[0][e]);
    r.a[1][e] = fmaf(v, s.w10, r.a[1][e]);
    r.a[2][e] = fmaf(v, s.w01, r.a[2][e]);
    r.a[3][e] = fmaf(v, s.w11, r.a[3][e]);
  }
}

// kBatch consecutive planes of a thread (their cells s and corner bits
// given, grad_out of the first at src): the live ones' reads first, all
// in flight together, then their sums in plane order.
template <typename T, int VEC>
__device__ __forceinline__ void add_batch(Run<VEC>& r,
                                          const Cell (&s)[kBatch],
                                          const unsigned (&bits)[kBatch],
                                          const T* __restrict__ src,
                                          int64_t step,
                                          float* __restrict__ grad, int W,
                                          int C) {
  Vec<T, VEC> v[kBatch];
#pragma unroll
  for (int u = 0; u < kBatch; ++u) {
    if (bits[u]) v[u] = load<T, VEC>(src + u * step);
  }
#pragma unroll
  for (int u = 0; u < kBatch; ++u) {
    if (bits[u]) add_sample<T, VEC>(r, s[u], bits[u], v[u], grad, W, C);
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kWarps * 32)
    warp_sample_grad_kernel(const T* __restrict__ grad_out, GradGrid g,
                            const float* __restrict__ mat,
                            const float* __restrict__ depth, float min_depth,
                            float* __restrict__ grad) {
  const int lane = threadIdx.x & 31;
  const int L = g.C / VEC;  // lanes (channel vectors) a pixel
  const int plane_size = g.H * g.W;
  const int b = static_cast<int>(blockIdx.y) / g.groups;
  const int64_t d0 =
      static_cast<int64_t>(blockIdx.y - b * g.groups) * g.planes;
  const int np = static_cast<int>(min(d0 + g.planes, g.D) - d0);
  const unsigned item = blockIdx.x * blockDim.x + threadIdx.x;
  const int pix = static_cast<int>(item / L);
  const int c = static_cast<int>(item - pix * L) * VEC;
  const float* m = mat + b * 12;
  // Plane k of pixel p: depth at dp[k * plane_size + p], this thread's
  // grad_out at src + k * step.
  const float* dp = depth + (b * g.D + d0) * plane_size;
  const int64_t step = static_cast<int64_t>(plane_size) * g.C;
  const T* src = grad_out + (b * g.D + d0) * step +
                 static_cast<int64_t>(pix) * g.C + c;
  float* gimg = grad + b * step + c;
  Run<VEC> run;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
#pragma unroll
    for (int e = 0; e < VEC; ++e) run.a[q][e] = 0.0f;
  }
  run.bits = 0;
  run.xy = -1;
  if (32 % L == 0) {  // uniform: a warp is px whole pixels
    const int px = 32 / L;
    const int pix0 = pix - lane / L;
    if (pix0 >= plane_size) return;  // the whole warp
    const int j = lane / L;          // this lane's pixel in the warp
    // This lane's cells: pixel pix0 + lane % px on plane lane / px of each
    // round of L planes.
    const int pc = pix0 + lane % px;
    const bool vc = pc < plane_size;
    const Ray ray = pixel_ray(m, static_cast<float>(pc % g.W),
                              static_cast<float>(pc / g.W));
    const float* dc =
        dp + static_cast<int64_t>(lane / px) * plane_size + pc;
    float dnext = vc && lane / px < np ? dc[0] : 0.0f;
    for (int r0 = 0; r0 < np; r0 += L) {  // uniform
      const int kc = r0 + lane / px;
      const float d = dnext;
      if (vc && kc + L < np) {
        dnext = dc[static_cast<int64_t>(r0 + L) * plane_size];
      }
      const Cell mine = vc && kc < np
                            ? plane_cell<T>(ray, d, min_depth, g.H, g.W)
                            : Cell{0.0f, 0.0f, 0.0f, 0.0f, 0};
      const int nr = min(L, np - r0);
      for (int k0 = 0; k0 < nr; k0 += kBatch) {
        Cell s[kBatch];
        unsigned bits[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int k = k0 + u;
          s[u] = shfl_cell(mine, (k < L ? k : 0) * px + j);
          bits[u] = k < nr && pix < plane_size
                        ? corner_bits(s[u], g.H, g.W)
                        : 0u;
        }
        add_batch<T, VEC>(run, s, bits, src + (r0 + k0) * step, step, gimg,
                          g.W, g.C);
      }
    }
  } else {  // each lane its own pixel's cells
    if (pix >= plane_size) return;
    const Ray ray = pixel_ray(m, static_cast<float>(pix % g.W),
                              static_cast<float>(pix / g.W));
    for (int k0 = 0; k0 < np; k0 += kBatch) {
      float d[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        d[u] = k0 + u < np
                   ? dp[static_cast<int64_t>(k0 + u) * plane_size + pix]
                   : 0.0f;
      }
      Cell s[kBatch];
      unsigned bits[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        s[u] = plane_cell<T>(ray, d[u], min_depth, g.H, g.W);
        bits[u] = k0 + u < np ? corner_bits(s[u], g.H, g.W) : 0u;
      }
      add_batch<T, VEC>(run, s, bits, src + k0 * step, step, gimg, g.W,
                        g.C);
    }
  }
  flush<VEC>(run, gimg, g.W, g.C);
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

// The launches, as functors on the runtime (type, vector width). The
// plane sweep's output is the warped volume (a pointer) or the variance's
// running sums (VarianceOut) or the correlation's similarity
// (CorrelationOut), and launch_sweep picks the kernel by it.
struct VarianceOut {
  void* sum;
  void* sq;
  bool first;
};

template <typename T, int VEC>
void launch_sweep(dim3 grid, cudaStream_t stream, const T* img, Grid g,
                  const float* mat, const float* depth, float min_depth,
                  void* out) {
  warp_sample_kernel<T, VEC><<<grid, kWarps * 32, 0, stream>>>(
      img, g, mat, depth, min_depth, static_cast<T*>(out));
}

template <typename T, int VEC>
void launch_sweep(dim3 grid, cudaStream_t stream, const T* img, Grid g,
                  const float* mat, const float* depth, float min_depth,
                  const VarianceOut& out) {
  warp_variance_kernel<T, VEC><<<grid, kWarps * 32, 0, stream>>>(
      img, g, mat, depth, min_depth,
      VarianceSums<T>{static_cast<T*>(out.sum), static_cast<T*>(out.sq),
                      out.first});
}

// The correlation's output: the reference's features (the image's layout
// and type) and the float32 (B, D, H, W) similarity.
struct CorrelationOut {
  const void* ref;
  float* out;
};

template <typename T, int VEC>
void launch_sweep(dim3 grid, cudaStream_t stream, const T* img, Grid g,
                  const float* mat, const float* depth, float min_depth,
                  const CorrelationOut& out) {
  const size_t scratch = sizeof(float) * kWarps * 32 * (g.C / VEC);
  warp_correlation_kernel<T, VEC><<<grid, kWarps * 32, scratch, stream>>>(
      img, g, mat, depth, min_depth, static_cast<const T*>(out.ref),
      out.out);
}

template <typename Out>
struct SweepLaunch {
  const void* img;
  Grid g;
  int64_t B;
  const float* mat;
  const float* depth;
  float min_depth;
  Out out;
  cudaStream_t stream;
  template <typename T, int VEC>
  int run() const {
    const int64_t groups = (g.D + g.planes_per_warp - 1) / g.planes_per_warp;
    launch_sweep<T, VEC>(grid_of(g, B * groups), stream,
                         static_cast<const T*>(img), g, mat, depth,
                         min_depth, out);
    return static_cast<int>(cudaGetLastError());
  }
};

struct GradLaunch {
  const void* grad_out;
  GradGrid g;
  int64_t B;
  const float* mat;
  const float* depth;
  float min_depth;
  float* grad;
  cudaStream_t stream;
  template <typename T, int VEC>
  int run() const {
    if constexpr (VEC > 4) {  // a lane sums one float4 at most
      return static_cast<int>(cudaErrorInvalidValue);
    } else {
      const int64_t items = static_cast<int64_t>(g.H) * g.W * (g.C / VEC);
      const dim3 grid(
          static_cast<unsigned>((items + kWarps * 32 - 1) / (kWarps * 32)),
          static_cast<unsigned>(B * g.groups));
      warp_sample_grad_kernel<T, VEC><<<grid, kWarps * 32, 0, stream>>>(
          static_cast<const T*>(grad_out), g, mat, depth, min_depth, grad);
      return static_cast<int>(cudaGetLastError());
    }
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

struct VarianceArgs {
  SweepArgs sweep;     // its out: the running sum, (B, D, H, W, C) of img's
                       // type; the sums aligned to vec too
  void* sq;            // the running sum of squares, as the sum
  int first;           // 1: write the sums (the first view), 0: add
  int unused;
};
static_assert(sizeof(VarianceArgs) == 96, "VarianceArgs layout");

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

// The plane sweep's launch into ``out`` after the checks of its geometry
// and tiling.
template <typename Out>
int sweep(const SweepArgs* a, const Out& out, cudaStream_t stream) {
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
                  SweepLaunch<Out>{a->img, g, a->B, a->mat, a->depth,
                                   a->min_depth, out, stream});
}

// Plane sweep: all arrays contiguous. Launches on ``stream`` without
// synchronising; returns cudaGetLastError().
extern "C" int tandem_warp_sample(const SweepArgs* a, cudaStream_t stream) {
  return sweep(a, a->out, stream);
}

// The variance step of one source view: all arrays contiguous, the sums
// of the warped volume's shape. Launches on ``stream`` without
// synchronising; returns cudaGetLastError().
extern "C" int tandem_warp_variance(const VarianceArgs* a,
                                    cudaStream_t stream) {
  return sweep(&a->sweep, VarianceOut{a->sweep.out, a->sq, a->first != 0},
               stream);
}

struct CorrelationArgs {
  SweepArgs sweep;     // its out: the float32 (B, D, H, W) similarity
  const void* ref;     // (B, H, W, C) of img's type: the reference's
                       // features, aligned to vec too
};
static_assert(sizeof(CorrelationArgs) == 88, "CorrelationArgs layout");

// The correlation step of one source view: all arrays contiguous. A
// sample's channels take at most 32 lanes (C / vec <= 32). Launches on
// ``stream`` without synchronising; returns cudaGetLastError().
extern "C" int tandem_warp_correlation(const CorrelationArgs* a,
                                       cudaStream_t stream) {
  if (a->sweep.vec < 1 || a->sweep.C / a->sweep.vec > 32) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return sweep(&a->sweep,
               CorrelationOut{a->ref, static_cast<float*>(a->sweep.out)},
               stream);
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
  int vec;               // channels a lane: 4, 2 or 1, C % vec == 0,
                         // grad_out aligned to vec elements
  int planes;            // consecutive planes a thread walks, >= 1
  int bf16;
  float min_depth;
  int unused;
};
static_assert(sizeof(GradArgs) == 80, "GradArgs layout");

// The plane sweep's image gradient: one launch of the gradient kernel,
// which adds into the zeroed float32 sums. All arrays contiguous.
// Launches on ``stream`` without synchronising; returns
// cudaGetLastError().
extern "C" int tandem_warp_sample_grad(const GradArgs* a,
                                       cudaStream_t stream) {
  if (a->B <= 0 || a->D <= 0) return 0;
  const int64_t groups =
      a->planes < 1 ? 0 : (a->D + a->planes - 1) / a->planes;
  if (bad_geometry(a->H, a->W, a->C, a->vec) || a->vec > 4 || groups < 1 ||
      a->B * groups > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const GradGrid g{a->D, a->H, a->W, a->C, a->planes,
                   static_cast<int>(groups)};
  return dispatch(a->bf16, a->vec,
                  GradLaunch{a->grad_out, g, a->B, a->mat, a->depth,
                             a->min_depth, a->grad, stream});
}

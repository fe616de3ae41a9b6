// TSDF fusion of one keyframe on the card, three kernels:
//   tandem_tsdf_integrate  fuse a (depth, colour) scan into every allocated
//                          block (mapping/tsdf.py integrate_plain);
//   tandem_tsdf_splat      the splat render's z-buffer: per (block, axis,
//                          column) the nearest-to-camera sdf zero crossing,
//                          projected and kept by an atomic minimum
//                          (splat_zbuf_plain's full walk);
//   tandem_tsdf_fill_holes one round of the 3x3 minimum hole fill
//                          (fill_holes_plain), the first round also turning
//                          the z-buffer's empty (inf) pixels to 0.
//
// Replaces no Pallas kernel: the JAX package fuses with XLA
// (tandem_tpu/mapping/tsdf.py integrate, integrate_culled,
// render_depth_splat), and the port ran the same arithmetic as a chain of
// torch ops, ~40 a chunk of 8,192 blocks to integrate and ~70 an axis a
// chunk to splat, behind two culls whose slot counts the host had to read
// to size its loops (each read drains the stream). A voxel's update and a
// column's crossing are each a few dozen flops on data one thread holds in
// registers, so each stage is one launch here and culls inside itself:
// - integrate takes one thread a voxel of every allocated block and loads
//   and stores a voxel's tsdf, weight and colour only where the plain
//   version's ``update`` holds; a voxel it skips is one the plain
//   ``torch.where`` leaves unchanged, so no slot list is needed;
// - splat takes a block of 3 * b * b threads a slot (one thread an (axis,
//   column)); the block first runs the frustum test of ``_frustum_mask``
//   on the block's bounding ball and leaves at once if no point of the
//   block can land in the image, so the tsdf and weight of culled blocks
//   are never read. Else the block's tsdf and weight go to shared memory
//   (coalesced, 4 KB at b = 8) and each thread walks its column there,
//   reading only the +axis neighbour's first slice from device memory
//   through the page table. The z-buffer holds the float bits of the
//   depth: every emitted z is > min_depth > 0 and +inf is the largest
//   positive pattern, so atomicMin on the bits is the float minimum and
//   the result does not depend on the order of the atomics;
// - the fill is one thread a pixel, reading its 3x3 neighbourhood.
//
// Bound: bytes. Integrate reads each block's coordinates (12 bytes) and
// moves 40 bytes a voxel it updates (tsdf, weight and colour read and
// written) plus the scan's depth, ray norms and colour; splat reads 4 KB
// a block that passes the frustum test (and 12 bytes a culled one) and
// writes the z-buffer; a fill round reads and writes the image once (the
// neighbours come from L1/L2).
//
// Exactness: each kernel repeats the plain version's float32 operations in
// its order, with __fmul_rn/__fadd_rn/__fsub_rn/__fdiv_rn/__fsqrt_rn so
// nvcc contracts no product into an FMA, and rintf for torch.round's half
// to even; the results equal the plain version's bit for bit. The
// camera's world-to-camera translation and the scan's ray norms come from
// the plain version's own torch expressions (_world_to_cam, _Scan). The
// splat's frustum test is not the plain cull's arithmetic (that one runs
// the centres through a matrix product): it uses the exact per-axis
// bound of the ball's projection with the ball's radius inflated by 2%
// and 0.01 px more a side, far above any rounding, and no far-depth test
// (the full walk has none), so it never drops a block that could emit.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// The packed arguments of the entry points (mapping/tsdf.py mirrors them
// with struct.Struct; keep the layouts in step).
struct IntegrateArgs {
  const int* coords;      // (pool, 3) int32 block coordinates
  float* tsdf;            // (pool, b^3)
  float* weight;          // (pool, b^3)
  float* color;           // (pool, b^3, 3)
  const float* depth;     // (H, W)
  const float* rgb;       // (H, W, 3) RGB in [0, 255]
  const float* ray_norm;  // (H * W,) |K^-1 (u, v, 1)|
  const float* K;         // (3, 3)
  const float* c2w;       // (4, 4) camera to world
  const float* t;         // (3,) world to camera translation
  int64_t n_blocks;       // the allocated slots [0, n_blocks)
  int H, W, b;
  float voxel_size, truncation, max_weight, min_depth, max_depth;
  int unused[2];
};
static_assert(sizeof(IntegrateArgs) == 128, "IntegrateArgs layout");

struct SplatArgs {
  const int* coords;      // (pool, 3) int32 block coordinates
  const float* tsdf;      // (pool, b^3)
  const float* weight;    // (pool, b^3)
  const int* page_table;  // (T^3,) int32 slot, -1 = unallocated
  unsigned int* zbuf;     // (H * W,) float bits, +inf where empty
  const float* K;         // (3, 3)
  const float* c2w;       // (4, 4) camera to world
  const float* t;         // (3,) world to camera translation
  int64_t n_blocks;       // the allocated slots [0, n_blocks)
  int H, W, b, table_dim;
  float voxel_size, min_depth, block_extent;
  int unused;
};
static_assert(sizeof(SplatArgs) == 104, "SplatArgs layout");

struct FillArgs {
  const float* src;  // (H, W)
  float* dst;        // (H, W), not src
  int H, W;
  int from_zbuf;     // 1: src is the splat's z-buffer, read as 0 where
                     // not finite
  int unused;
};
static_assert(sizeof(FillArgs) == 32, "FillArgs layout");

namespace {

constexpr int kIntegrateThreads = 256;
constexpr int kFillThreads = 256;

struct Camera {
  float R[3][3];  // world to camera rotation: the transpose of c2w's
  float t[3];     // world to camera translation
  float fx, fy, cx, cy;
};

__device__ __forceinline__ Camera load_camera(const float* __restrict__ K,
                                              const float* __restrict__ c2w,
                                              const float* __restrict__ t) {
  Camera c;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) c.R[i][j] = __ldg(c2w + j * 4 + i);
    c.t[i] = __ldg(t + i);
  }
  c.fx = __ldg(K + 0);
  c.fy = __ldg(K + 4);
  c.cx = __ldg(K + 2);
  c.cy = __ldg(K + 5);
  return c;
}

// Row i of R applied to p, then + t_i, as the plain version's
// ((R_i0 p0 + R_i1 p1) + R_i2 p2) + t_i.
__device__ __forceinline__ float cam_row(const Camera& c, int i, float p0,
                                         float p1, float p2) {
  return __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(c.R[i][0], p0),
                                       __fmul_rn(c.R[i][1], p1)),
                             __fmul_rn(c.R[i][2], p2)),
                   c.t[i]);
}

__global__ void __launch_bounds__(kIntegrateThreads)
    integrate_kernel(const IntegrateArgs a) {
  const Camera c = load_camera(a.K, a.c2w, a.t);
  const int b = a.b, b2 = b * b, b3 = b2 * b;
  const float fb = static_cast<float>(b);
  const int64_t total = a.n_blocks * b3;
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                   threadIdx.x;
       i < total; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t slot = i / b3;
    const int li = static_cast<int>(i - slot * b3);
    const int* bc = a.coords + slot * 3;
    // _voxel_world: (coords * b + l) * voxel_size, l = (x, y, z) of
    // li = (z * b + y) * b + x.
    const float wx = __fmul_rn(
        __fadd_rn(__fmul_rn(static_cast<float>(__ldg(bc)), fb),
                  static_cast<float>(li % b)),
        a.voxel_size);
    const float wy = __fmul_rn(
        __fadd_rn(__fmul_rn(static_cast<float>(__ldg(bc + 1)), fb),
                  static_cast<float>((li / b) % b)),
        a.voxel_size);
    const float wz = __fmul_rn(
        __fadd_rn(__fmul_rn(static_cast<float>(__ldg(bc + 2)), fb),
                  static_cast<float>(li / b2)),
        a.voxel_size);
    const float xc = cam_row(c, 0, wx, wy, wz);
    const float yc = cam_row(c, 1, wx, wy, wz);
    const float z = cam_row(c, 2, wx, wy, wz);
    const float z_safe = z <= 1e-6f ? 1.0f : z;
    const float u = rintf(__fadd_rn(__fdiv_rn(__fmul_rn(c.fx, xc), z_safe),
                                    c.cx));
    const float v = rintf(__fadd_rn(__fdiv_rn(__fmul_rn(c.fy, yc), z_safe),
                                    c.cy));
    if (!(z > 0.0f && u >= 0.0f && u < static_cast<float>(a.W) &&
          v >= 0.0f && v < static_cast<float>(a.H))) {
      continue;
    }
    const int64_t pix = static_cast<int64_t>(v) * a.W + static_cast<int64_t>(u);
    const float d = __ldg(a.depth + pix);
    if (!(d > 0.0f && d >= a.min_depth && d < a.max_depth)) continue;
    const float surface = __fmul_rn(d, __ldg(a.ray_norm + pix));
    const float dist = __fsqrt_rn(__fadd_rn(
        __fadd_rn(__fmul_rn(xc, xc), __fmul_rn(yc, yc)), __fmul_rn(z, z)));
    const float lo = __fsub_rn(surface, a.truncation);
    const bool band = dist > lo && dist < __fadd_rn(surface, a.truncation);
    if (!(band || dist < lo)) continue;  // neither in the band nor free
    const float sdf = band ? __fsub_rn(surface, dist) : a.truncation;
    const float w = a.weight[i];
    const float denom = __fadd_rn(w, 1.0f);
    a.tsdf[i] = __fdiv_rn(__fadd_rn(__fmul_rn(a.tsdf[i], w), sdf), denom);
    float* col = a.color + i * 3;
    const float* src = a.rgb + pix * 3;
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      col[ch] = __fdiv_rn(__fadd_rn(__fmul_rn(col[ch], w), __ldg(src + ch)),
                          denom);
    }
    a.weight[i] = fminf(denom, a.max_weight);
  }
}

// The frustum test of ``_frustum_mask`` (see there) on the block's
// bounding ball, made safe against rounding as the header says: false
// only where no point of the block can land in the image.
__device__ bool block_may_show(const Camera& c, const SplatArgs& a,
                               const int* bc) {
  const float r = a.block_extent * (0.8660254f * 1.02f);
  float centre[3];
#pragma unroll
  for (int k = 0; k < 3; ++k)
    centre[k] = (static_cast<float>(bc[k]) + 0.5f) * a.block_extent;
  const float x = cam_row(c, 0, centre[0], centre[1], centre[2]);
  const float y = cam_row(c, 1, centre[0], centre[1], centre[2]);
  const float z = cam_row(c, 2, centre[0], centre[1], centre[2]);
  if (z + r <= 0.0f) return false;  // wholly behind the camera
  if (z - r <= 0.0f) {
    // Reaches the camera plane: a point in the image lies within the
    // widest ray's cone, |p| <= p_z * norm_max.
    const float tu = (fmaxf(c.cx, a.W - 1 - c.cx) + 0.5f) / c.fx;
    const float tv = (fmaxf(c.cy, a.H - 1 - c.cy) + 0.5f) / c.fy;
    const float norm_max = sqrtf(1.0f + tu * tu + tv * tv);
    return sqrtf(x * x + y * y + z * z) <= (z + r) * norm_max + r;
  }
  const float zr = z - r;
  const float u = c.fx * x / z + c.cx;
  const float v = c.fy * y / z + c.cy;
  const float mu = (c.fx + fabsf(u - c.cx)) * r / zr + 0.01f;
  const float mv = (c.fy + fabsf(v - c.cy)) * r / zr + 0.01f;
  return u + mu >= -0.5f && u - mu <= a.W - 0.5f && v + mv >= -0.5f &&
         v - mv <= a.H - 0.5f;
}

// One block of 3 * b * b threads a slot: thread (axis, o1, o2) walks the
// column of the block along ``axis`` at the other two axes' (o1, o2), in
// _axis_layout's order: x columns (z, y), y columns (z, x), z columns
// (y, x).
__global__ void splat_kernel(const SplatArgs a) {
  extern __shared__ float tile[];  // tsdf then weight of the block, b^3 each
  const int b = a.b, b2 = b * b, b3 = b2 * b;
  const int64_t slot = blockIdx.x;
  const int* bc = a.coords + slot * 3;
  const Camera c = load_camera(a.K, a.c2w, a.t);
  int coord[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) coord[k] = __ldg(bc + k);
  if (!block_may_show(c, a, coord)) return;  // the same for the whole block
  float* ts = tile;
  float* ws = tile + b3;
  const float* tsdf = a.tsdf + slot * b3;
  const float* weight = a.weight + slot * b3;
  for (int i = threadIdx.x; i < b3; i += blockDim.x) {
    ts[i] = tsdf[i];
    ws[i] = weight[i];
  }
  __syncthreads();

  const int axis = threadIdx.x / b2;
  const int jk = threadIdx.x - axis * b2;
  const int o1 = jk / b, o2 = jk - (jk / b) * b;
  // The column's first voxel, the step along it, and the axes of o1, o2.
  int li0, step, ax1, ax2;
  if (axis == 0) {
    li0 = o1 * b2 + o2 * b; step = 1; ax1 = 2; ax2 = 1;
  } else if (axis == 1) {
    li0 = o1 * b2 + o2; step = b; ax1 = 2; ax2 = 0;
  } else {
    li0 = o1 * b + o2; step = b2; ax1 = 1; ax2 = 0;
  }
  // The +axis neighbour's first slice closes the gap between blocks.
  const int T = a.table_dim, half = T / 2;
  int nb[3] = {coord[0] + half, coord[1] + half, coord[2] + half};
  nb[axis] += 1;
  float s_nb = 0.0f, w_nb = 0.0f;
  if (nb[0] >= 0 && nb[0] < T && nb[1] >= 0 && nb[1] < T && nb[2] >= 0 &&
      nb[2] < T) {
    const int nb_slot = __ldg(a.page_table +
                              (static_cast<int64_t>(nb[0]) * T + nb[1]) * T +
                              nb[2]);
    if (nb_slot >= 0) {
      s_nb = __ldg(a.tsdf + static_cast<int64_t>(nb_slot) * b3 + li0);
      w_nb = __ldg(a.weight + static_cast<int64_t>(nb_slot) * b3 + li0);
    }
  }

  const float fb = static_cast<float>(b);
  float base[3];
#pragma unroll
  for (int k = 0; k < 3; ++k)
    base[k] = __fmul_rn(static_cast<float>(coord[k]), fb);
  const float p1 = __fadd_rn(base[ax1], static_cast<float>(o1));
  const float p2 = __fadd_rn(base[ax2], static_cast<float>(o2));
  const float z_12 = __fadd_rn(__fmul_rn(c.R[2][ax1], p1),
                               __fmul_rn(c.R[2][ax2], p2));
  // The nearest crossing (first index on ties, as torch.min).
  float best = INFINITY, t_best = 0.0f;
  int g = 0;
  for (int k = 0; k < b; ++k) {
    const int li = li0 + k * step;
    const float s0 = ts[li], w0 = ws[li];
    const float s1 = k + 1 < b ? ts[li + step] : s_nb;
    const float w1 = k + 1 < b ? ws[li + step] : w_nb;
    if (!(w0 > 0.0f && w1 > 0.0f && __fmul_rn(s0, s1) <= 0.0f &&
          !(s0 == 0.0f && s1 == 0.0f))) {
      continue;  // no valid sign change between voxels k and k + 1
    }
    const float denom = __fsub_rn(s0, s1);
    const float tt = fminf(
        fmaxf(__fdiv_rn(s0, fabsf(denom) < 1e-20f ? 1.0f : denom), 0.0f),
        1.0f);
    const float pa = __fadd_rn(__fadd_rn(base[axis], static_cast<float>(k)),
                               tt);
    const float zc = __fadd_rn(
        __fmul_rn(__fadd_rn(z_12, __fmul_rn(c.R[2][axis], pa)),
                  a.voxel_size),
        c.t[2]);
    if (zc < best) {
      best = zc;
      g = k;
      t_best = tt;
    }
  }
  if (!(isfinite(best) && best > 0.0f && best > a.min_depth)) return;
  float p[3];
  p[axis] = __fadd_rn(__fadd_rn(base[axis], static_cast<float>(g)), t_best);
  p[ax1] = p1;
  p[ax2] = p2;
  const float xc = __fadd_rn(
      __fmul_rn(__fadd_rn(__fadd_rn(__fmul_rn(c.R[0][0], p[0]),
                                    __fmul_rn(c.R[0][1], p[1])),
                          __fmul_rn(c.R[0][2], p[2])),
                a.voxel_size),
      c.t[0]);
  const float yc = __fadd_rn(
      __fmul_rn(__fadd_rn(__fadd_rn(__fmul_rn(c.R[1][0], p[0]),
                                    __fmul_rn(c.R[1][1], p[1])),
                          __fmul_rn(c.R[1][2], p[2])),
                a.voxel_size),
      c.t[1]);
  const float z_safe = best <= 1e-6f ? 1.0f : best;
  const float u = rintf(__fadd_rn(__fdiv_rn(__fmul_rn(c.fx, xc), z_safe),
                                  c.cx));
  const float v = rintf(__fadd_rn(__fdiv_rn(__fmul_rn(c.fy, yc), z_safe),
                                  c.cy));
  if (!(u >= 0.0f && u < static_cast<float>(a.W) && v >= 0.0f &&
        v < static_cast<float>(a.H))) {
    return;
  }
  atomicMin(a.zbuf + static_cast<int64_t>(v) * a.W + static_cast<int64_t>(u),
            __float_as_uint(best));
}

__device__ __forceinline__ float fill_read(const FillArgs& a, int64_t i) {
  const float d = __ldg(a.src + i);
  return a.from_zbuf && !isfinite(d) ? 0.0f : d;
}

// fill_holes_plain's round: an empty pixel (<= 0) takes the least
// non-empty value of its 3x3 neighbourhood, 0 where there is none.
__global__ void __launch_bounds__(kFillThreads)
    fill_holes_kernel(const FillArgs a) {
  const int64_t n = static_cast<int64_t>(a.H) * a.W;
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                   threadIdx.x;
       i < n; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const float d = fill_read(a, i);
    if (d > 0.0f) {
      a.dst[i] = d;
      continue;
    }
    const int y = static_cast<int>(i / a.W), x = static_cast<int>(i % a.W);
    float m = INFINITY;
    for (int yy = max(y - 1, 0); yy <= min(y + 1, a.H - 1); ++yy) {
      for (int xx = max(x - 1, 0); xx <= min(x + 1, a.W - 1); ++xx) {
        const float e = fill_read(a, static_cast<int64_t>(yy) * a.W + xx);
        if (e > 0.0f) m = fminf(m, e);
      }
    }
    a.dst[i] = isfinite(m) ? m : 0.0f;
  }
}

int grid_for(int64_t items, int threads) {
  const int64_t want = (items + threads - 1) / threads;
  return static_cast<int>(want < 65535 * 32 ? want : 65535 * 32);
}

}  // namespace

// All arrays contiguous float32 / int32 on one device. Each entry point
// launches on ``stream`` without synchronising and returns
// cudaGetLastError().
extern "C" int tandem_tsdf_integrate(const IntegrateArgs* a,
                                     cudaStream_t stream) {
  if (a->b < 1 || a->H < 1 || a->W < 1 || a->n_blocks < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (a->n_blocks == 0) return 0;
  integrate_kernel<<<grid_for(a->n_blocks * a->b * a->b * a->b,
                              kIntegrateThreads),
                     kIntegrateThreads, 0, stream>>>(*a);
  return static_cast<int>(cudaGetLastError());
}

// zbuf: the caller fills it with +inf first.
extern "C" int tandem_tsdf_splat(const SplatArgs* a, cudaStream_t stream) {
  const int b = a->b;
  if (b < 1 || 3 * b * b > 1024 || a->H < 1 || a->W < 1 ||
      a->table_dim < 1 || a->n_blocks < 0 || a->n_blocks > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (a->n_blocks == 0) return 0;
  const size_t smem = 2 * sizeof(float) * b * b * b;
  splat_kernel<<<static_cast<unsigned>(a->n_blocks), 3 * b * b, smem,
                 stream>>>(*a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tandem_tsdf_fill_holes(const FillArgs* a,
                                      cudaStream_t stream) {
  if (a->H < 1 || a->W < 1 || a->src == a->dst) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  fill_holes_kernel<<<grid_for(static_cast<int64_t>(a->H) * a->W,
                               kFillThreads),
                      kFillThreads, 0, stream>>>(*a);
  return static_cast<int>(cudaGetLastError());
}

// Depth edge filter: per-pixel 15th smallest |window - centre| over a 5x5
// zero-padded window (cva_mvsnet/models/module.py:1338-1344 semantics).
//
// Replaces the TPU kernel tandem_tpu/ops/pallas_kernels.py
// edge_kth_value_pallas (body _edge_kth_kernel). It computes the same
// function, not the same blocking: the Pallas kernel streams row blocks of
// the whole padded image through VMEM; here each 32x8 thread block loads
// its tile plus a 2-pixel zero halo into shared memory once, and every
// thread selects its pixel's value from 25 differences held in registers.
//
// Bound: compute. Rank counting costs 625 compares per pixel, while the
// traffic is one read and one write of the map (1.2 MB each way at
// 640x480 f32). This simple form is enough for now; a partial sorting
// network (fewer compares) is the known next step.
//
// Exactness: the value kept is min{v_i : #(v_j <= v_i) >= 15}, which is
// sort(v)[14] for any ties, so the kernel equals the plain sort version
// bit for bit.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWin = 5;
constexpr int kHalf = kWin / 2;
constexpr int kTaps = kWin * kWin;
constexpr int kRank = kWin * (kHalf + 1);  // 15 of 25
constexpr int kBx = 32;
constexpr int kBy = 8;
constexpr int kTileW = kBx + 2 * kHalf;
constexpr int kTileH = kBy + 2 * kHalf;

__global__ void edge_kth_kernel(const float* __restrict__ depth,
                                float* __restrict__ out, int H, int W) {
  __shared__ float tile[kTileH][kTileW];
  const size_t plane = static_cast<size_t>(H) * W;
  const float* img = depth + blockIdx.z * plane;
  const int gx0 = blockIdx.x * kBx - kHalf;
  const int gy0 = blockIdx.y * kBy - kHalf;
  for (int i = threadIdx.y * kBx + threadIdx.x; i < kTileH * kTileW;
       i += kBx * kBy) {
    const int ty = i / kTileW, tx = i % kTileW;
    const int gy = gy0 + ty, gx = gx0 + tx;
    tile[ty][tx] = (gy >= 0 && gy < H && gx >= 0 && gx < W)
                       ? img[static_cast<size_t>(gy) * W + gx]
                       : 0.0f;
  }
  __syncthreads();

  const int x = blockIdx.x * kBx + threadIdx.x;
  const int y = blockIdx.y * kBy + threadIdx.y;
  if (x >= W || y >= H) return;

  const float c = tile[threadIdx.y + kHalf][threadIdx.x + kHalf];
  float v[kTaps];
#pragma unroll
  for (int dy = 0; dy < kWin; ++dy) {
#pragma unroll
    for (int dx = 0; dx < kWin; ++dx) {
      v[dy * kWin + dx] = fabsf(tile[threadIdx.y + dy][threadIdx.x + dx] - c);
    }
  }
  float kth = INFINITY;
#pragma unroll
  for (int i = 0; i < kTaps; ++i) {
    int le = 0;
#pragma unroll
    for (int j = 0; j < kTaps; ++j) le += v[j] <= v[i];
    if (le >= kRank && v[i] < kth) kth = v[i];
  }
  out[blockIdx.z * plane + static_cast<size_t>(y) * W + x] = kth;
}

}  // namespace

// depth, out: (B, H, W) float32, contiguous, on the current device.
// Launches on ``stream`` without synchronising; returns cudaGetLastError().
extern "C" int tandem_edge_kth(const float* depth, float* out, int B, int H,
                               int W, cudaStream_t stream) {
  const dim3 block(kBx, kBy);
  const dim3 grid((W + kBx - 1) / kBx, (H + kBy - 1) / kBy, B);
  edge_kth_kernel<<<grid, block, 0, stream>>>(depth, out, H, W);
  return static_cast<int>(cudaGetLastError());
}

// Plane-sweep bilinear index chain: pixel positions -> the packed-corner
// table row of each sample's floor cell and its four corner weights, with
// out-of-pad cells and an optional keep mask folded into the weights.
//
// Replaces the TPU kernel experiments/bench_idxchain.py make_pallas (the
// chain of tandem_tpu/ops/warp.py:124-140 and ops/grid_sample.py:50-65).
// The Pallas kernel streams (tn, 128) tiles of x and y through VMEM; here
// each thread takes one sample in a grid-stride loop: there is no reuse
// between samples, so tiles buy nothing on this card.
//
// Bound: memory. 8 bytes in (+1 with the keep mask) and 4 + 4 x 4 (f32) or
// 4 + 4 x 2 (bf16) bytes out per sample, a handful of flops each.
//
// Exactness: the chain is the JAX package's, in its order (floor, x - x0,
// 1 - w, the in-bounds test, (wx0 * wy0) * ins, one rounding to the weight
// type), written with __fsub_rn/__fmul_rn so nvcc cannot contract into an
// FMA. The kernel therefore equals the plain PyTorch version
// (ops/bilinear_index.py) bit for bit for finite positions, in f32 and in
// bf16 (round to nearest even, as torch's cast).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

template <typename T>
__global__ void bilinear_index_kernel(const float* __restrict__ px,
                                      const float* __restrict__ py,
                                      const uint8_t* __restrict__ keep,
                                      int64_t n, int64_t per_batch, int H,
                                      int W, int* __restrict__ rows,
                                      T* __restrict__ w) {
  const float xmax = static_cast<float>(W - 1);
  const float ymax = static_cast<float>(H - 1);
  const int64_t batch_rows = static_cast<int64_t>(H + 1) * (W + 1);
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                   threadIdx.x;
       i < n; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const float x = px[i];
    const float y = py[i];
    const float x0 = floorf(x);
    const float y0 = floorf(y);
    const float wx1 = __fsub_rn(x, x0);
    const float wy1 = __fsub_rn(y, y0);
    const float wx0 = __fsub_rn(1.0f, wx1);
    const float wy0 = __fsub_rn(1.0f, wy1);
    // Cells whose floor lies beyond the 1-pixel pad have every corner
    // outside the image: their weights are exactly zero.
    bool inside = x0 >= -1.0f && x0 <= xmax && y0 >= -1.0f && y0 <= ymax;
    if (keep != nullptr) inside = inside && keep[i] != 0;
    const float ins = inside ? 1.0f : 0.0f;
    w[i] = from_f32<T>(__fmul_rn(__fmul_rn(wx0, wy0), ins));
    w[n + i] = from_f32<T>(__fmul_rn(__fmul_rn(wx1, wy0), ins));
    w[2 * n + i] = from_f32<T>(__fmul_rn(__fmul_rn(wx0, wy1), ins));
    w[3 * n + i] = from_f32<T>(__fmul_rn(__fmul_rn(wx1, wy1), ins));
    const int xi = static_cast<int>(fminf(fmaxf(x0, -1.0f), xmax)) + 1;
    const int yi = static_cast<int>(fminf(fmaxf(y0, -1.0f), ymax)) + 1;
    rows[i] = static_cast<int>((i / per_batch) * batch_rows) + yi * (W + 1) +
              xi;
  }
}

template <typename T>
int launch(const float* px, const float* py, const uint8_t* keep, int64_t n,
           int64_t per_batch, int H, int W, int* rows, void* w,
           cudaStream_t stream) {
  constexpr int kThreads = 256;
  const int64_t want = (n + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < 65535 * 16 ? want : 65535 * 16);
  bilinear_index_kernel<T><<<blocks, kThreads, 0, stream>>>(
      px, py, keep, n, per_batch, H, W, rows, static_cast<T*>(w));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// px, py: n float32 positions (contiguous); keep: n bytes (0 = drop) or
// null; samples [b * per_batch, (b + 1) * per_batch) index batch b of a
// packed-corner table of B * (H + 1) * (W + 1) rows. rows: n int32; w: the
// four weights as (4, n), float32 (w_bf16 = 0) or bfloat16 (w_bf16 = 1).
// Launches on ``stream`` without synchronising; returns cudaGetLastError().
extern "C" int tandem_bilinear_index(const float* px, const float* py,
                                     const uint8_t* keep, int64_t n,
                                     int64_t per_batch, int H, int W,
                                     int* rows, void* w, int w_bf16,
                                     cudaStream_t stream) {
  if (n <= 0) return 0;
  return w_bf16 ? launch<__nv_bfloat16>(px, py, keep, n, per_batch, H, W,
                                        rows, w, stream)
                : launch<float>(px, py, keep, n, per_batch, H, W, rows, w,
                                stream);
}

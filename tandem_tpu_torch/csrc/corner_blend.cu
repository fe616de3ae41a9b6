// Packed-corner bilinear sample: gather one 4C-wide row of the corner
// table per sample and blend its four C-wide corners with the sample's
// four weights.
//
// Replaces the TPU kernel experiments/pallas_gather_probe.py
// make_pallas_fused, the inner sample of the plane-sweep warp
// (tandem_tpu/ops/warp.py:147-157, ``_plain``). The Pallas kernel holds the
// whole table in VMEM and gathers (tn, 4C) tiles with take_along_axis; on
// this card the table (10 MB for stage 1 in f32) stays in device memory
// behind the 50 MB L2, and each thread reads VEC channels of each corner of
// one sample's row with 16-byte vector loads where the row allows it, so a
// warp reads whole rows in few transactions.
//
// Bound: memory (random rows). Per sample: one 4C row read (64-512 bytes
// at the abl04 stage shapes), four weights and a row index read, C outputs
// written; 7 flops per output.
//
// Exactness: every corner and weight is widened to f32 and blended as
// ((g00 w00 + g10 w10) + g01 w01) + g11 w11 with __fmul_rn/__fadd_rn (no
// FMA contraction), then rounded once to the table type at the store. The
// plain version (ops/corner_blend.py) does the same, so the two agree bit
// for bit in f32 and bf16. A row outside [0, M) reads as zeros.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Vec {
  T v[VEC];
};

template <typename T, int VEC>
__global__ void corner_blend_kernel(const T* __restrict__ table,
                                    const int* __restrict__ rows,
                                    const T* __restrict__ w, int64_t n,
                                    int64_t m, int C, T* __restrict__ out) {
  using V = Vec<T, VEC>;
  const int groups = C / VEC;
  const int64_t total = n * groups;
  for (int64_t t = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                   threadIdx.x;
       t < total; t += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t i = t / groups;
    const int c = static_cast<int>(t - i * groups) * VEC;
    const int r = rows[i];
    float acc[VEC];
    if (r >= 0 && r < m) {
      const T* src = table + static_cast<int64_t>(r) * 4 * C + c;
      const V g0 = *reinterpret_cast<const V*>(src);
      const V g1 = *reinterpret_cast<const V*>(src + C);
      const V g2 = *reinterpret_cast<const V*>(src + 2 * C);
      const V g3 = *reinterpret_cast<const V*>(src + 3 * C);
      const float w0 = to_f32(w[i]);
      const float w1 = to_f32(w[n + i]);
      const float w2 = to_f32(w[2 * n + i]);
      const float w3 = to_f32(w[3 * n + i]);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        float a = __fmul_rn(to_f32(g0.v[j]), w0);
        a = __fadd_rn(a, __fmul_rn(to_f32(g1.v[j]), w1));
        a = __fadd_rn(a, __fmul_rn(to_f32(g2.v[j]), w2));
        acc[j] = __fadd_rn(a, __fmul_rn(to_f32(g3.v[j]), w3));
      }
    } else {
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc[j] = 0.0f;
    }
    V o;
#pragma unroll
    for (int j = 0; j < VEC; ++j) o.v[j] = from_f32<T>(acc[j]);
    *reinterpret_cast<V*>(out + i * C + c) = o;
  }
}

template <typename T, int VEC>
int launch(const void* table, const int* rows, const void* w, int64_t n,
           int64_t m, int C, void* out, cudaStream_t stream) {
  constexpr int kThreads = 256;
  const int64_t total = n * (C / VEC);
  const int64_t want = (total + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < 65535 * 16 ? want : 65535 * 16);
  corner_blend_kernel<T, VEC><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(table), rows, static_cast<const T*>(w), n, m, C,
      static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* table, const int* rows, const void* w, int64_t n,
             int64_t m, int C, int vec, void* out, cudaStream_t stream) {
  switch (vec) {
    case 8:  // 16 bytes of bf16; f32 stops at 4
      if constexpr (sizeof(T) == 2) {
        return launch<T, 8>(table, rows, w, n, m, C, out, stream);
      }
      break;
    case 4:
      return launch<T, 4>(table, rows, w, n, m, C, out, stream);
    case 2:
      return launch<T, 2>(table, rows, w, n, m, C, out, stream);
    case 1:
      return launch<T, 1>(table, rows, w, n, m, C, out, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// table: (m, 4C) contiguous, float32 (bf16 = 0) or bfloat16 (bf16 = 1);
// rows: n int32; w: (4, n) weights of the table's type; out: (n, C).
// vec: channels per thread (C % vec == 0, vec * element size <= 16, and
// table and out aligned to vec * element size), chosen by the wrapper.
// Launches on ``stream`` without synchronising; returns cudaGetLastError().
extern "C" int tandem_corner_blend(const void* table, const int* rows,
                                   const void* w, int64_t n, int64_t m,
                                   int C, int vec, int bf16, void* out,
                                   cudaStream_t stream) {
  if (n <= 0) return 0;
  return bf16 ? dispatch<__nv_bfloat16>(table, rows, w, n, m, C, vec, out,
                                        stream)
              : dispatch<float>(table, rows, w, n, m, C, vec, out, stream);
}

// The cost regulariser's decoder step in one launch (CostRegNet's conv7,
// conv9 and conv11 in eval mode, models/cost_reg.py):
//
//   out = skip + relu(x_t * inv + off),  x_t = conv_transpose3d(x, w,
//         stride, padding 1, output_padding stride - 1), kernel 3x3x3,
//
// with inv and off the folded BatchNorm (models/layers.py fold_bn) and the
// skip the encoder's tensor of the output's level (or none).
//
// Replaces no Pallas kernel: the JAX package leaves this convolution to XLA
// (tandem_tpu/models/cost_reg.py, nn.ConvTranspose), and the port ran it as
// cuDNN's transposed convolution (held by cudnn.deterministic to a "grouped
// direct" algorithm that is slow at these few channels: 64->32, 32->16,
// 16->8) and three elementwise passes over its output.
//
// Gather, not zero insertion. Each output axis is taken by its phase, so
// no product with an inserted zero is formed and every output voxel is
// written exactly once, by one thread, with no atomics:
//   stride 2 (padding 1, output padding 1): output 2m takes tap 1 from
//     input m; output 2m + 1 takes tap 0 from input m + 1 (where m + 1 is
//     inside the input) and tap 2 from input m;
//   stride 1 (the D axis of stride (1, 2, 2), CostRegNet's deepest level
//     when D == 4): output o takes tap k from input o + 1 - k.
// A thread owns two neighbouring input cells along W, (md, mh, mw) and
// (md, mh, mw + 1), and computes all of their output phases (2 x 2 x 2 at
// stride 2, 1 x 2 x 2 at stride (1, 2, 2)) for kCout = 4 output channels.
// Per input channel it reads its window of 12 (18 at stride (1, 2, 2))
// input values once into registers and forms the taps' products from
// them, each against the tap's 4 weights, one float4 broadcast from shared
// memory that feeds both cells.
//
// Bound: bytes. The step reads the input and the skip and writes the
// output once (the output and skip have 8x the voxels of the input and
// half its channels, so they are ~80% of the bytes), and does 27 / 8 of a
// kernel's taps an output, ~3.4 multiply-adds an (output, input channel).
// What the tiling does about it:
//  - a block's weights (all input channels x 27 taps x its 4 output
//    channels, converted to float32) and folded BatchNorm go to shared
//    memory once, so no weight is read from device memory in the loop;
//  - the window's re-reads across neighbouring threads (a cell's m + 1 is
//    the next thread's m) fall on the same lines of one warp's loads, so
//    the input leaves DRAM about once and the window is served by L1/L2;
//  - the shared-memory weight reads, not the FMAs, set the pace of the
//    loop: with two cells a thread each float4 feeds 8 FMAs instead of 4;
//  - the epilogue runs in registers and each thread stores its output
//    pairs (2m, 2m + 1) along W as one 8- (float32) or 4-byte (bfloat16)
//    store: a warp writes 256 (128) contiguous bytes an instruction, and
//    reads the skip the same way.
//
// Determinism and rounding: each output sums over the input channels in
// ascending order, and within a channel over its taps in ascending (kd,
// kh, kw) order, with fmaf into a float32 accumulator; the same inputs give the same bits on every call. Only this summation
// order differs from the eager path (cuDNN's); the epilogue rounds as the
// eager torch ops do: in float32 __fmul_rn then __fadd_rn (no contraction)
// for the BatchNorm and __fadd_rn for the skip; in bfloat16 the sum rounded
// to bfloat16, then the product, the sum with the offset and the sum with
// the skip each computed in float32 and rounded to bfloat16. relu is
// std::max(v, 0) (NaN kept).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// The packed arguments of the entry point (ops/deconv3d.py _ARGS mirrors
// them; keep the layouts in step). 88 bytes, 4 of them tail padding.
struct DeconvArgs {
  const void* x;     // (N, Ci, Di, Hi, Wi)
  const void* w;     // (Ci, Co, 3, 3, 3)
  const void* inv;   // (Co,) folded BatchNorm scale
  const void* off;   // (Co,) folded BatchNorm offset
  const void* skip;  // (N, Co, Do, Ho, Wo) or null
  void* out;         // (N, Co, Do, Ho, Wo), Do = sd * Di, Ho = 2 Hi, ...
  int N, Ci, Co, Di, Hi, Wi;
  int stride_d;      // 1 or 2; H and W take stride 2
  int bf16;          // 0: every tensor float32, 1: every tensor bfloat16
  int relu;
};
static_assert(sizeof(DeconvArgs) == 88, "DeconvArgs layout");

namespace {

constexpr int kThreads = 128;
constexpr int kCout = 4;  // output channels a thread: one float4 of weights
constexpr int kCells = 2;  // input cells along W a thread
constexpr int kTaps = 27;
// Input channels whose weights fit the 48 KB of shared memory a block
// takes without opting in to more.
constexpr int kMaxCin = (48 * 1024 / 4 - 2 * kCout) / (kTaps * kCout);

// One axis of the gather, by its stride: P output phases; a window of WIN
// input positions m + LO .. m + LO + WIN - 1 a thread reads; phase p takes
// ntaps(p) taps, its t-th tap k(p, t) (ascending) from window slot
// slot(p, t).
template <int S>
struct Axis;

template <>
struct Axis<2> {
  static constexpr int P = 2, WIN = 2, LO = 0;
  __host__ __device__ static constexpr int ntaps(int p) {
    return p == 0 ? 1 : 2;
  }
  __host__ __device__ static constexpr int k(int p, int t) {
    return p == 0 ? 1 : (t == 0 ? 0 : 2);
  }
  __host__ __device__ static constexpr int slot(int p, int t) {
    return p == 0 ? 0 : (t == 0 ? 1 : 0);
  }
};

template <>
struct Axis<1> {
  static constexpr int P = 1, WIN = 3, LO = -1;
  __host__ __device__ static constexpr int ntaps(int) { return 3; }
  __host__ __device__ static constexpr int k(int, int t) { return t; }
  __host__ __device__ static constexpr int slot(int, int t) { return 2 - t; }
};

template <typename T>
struct Elem;

template <>
struct Elem<float> {
  __device__ static float load(const float* p) { return __ldg(p); }
  __device__ static float2 load2(const float* p) {
    return __ldg(reinterpret_cast<const float2*>(p));
  }
  __device__ static void store2(float* p, float a, float b) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  }
  // The eager epilogue in float32: x * inv, + off, relu, skip +.
  __device__ static float epilogue(float acc, float inv, float off, float s,
                                   bool relu) {
    float v = __fadd_rn(__fmul_rn(acc, inv), off);
    if (relu) v = v < 0.f ? 0.f : v;
    return __fadd_rn(s, v);
  }
};

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <>
struct Elem<__nv_bfloat16> {
  __device__ static float load(const __nv_bfloat16* p) {
    return __bfloat162float(__ldg(p));
  }
  __device__ static float2 load2(const __nv_bfloat16* p) {
    return __bfloat1622float2(
        __ldg(reinterpret_cast<const __nv_bfloat162*>(p)));
  }
  __device__ static void store2(__nv_bfloat16* p, float a, float b) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  }
  // The eager epilogue in bfloat16: the convolution's output rounded, and
  // each op computed in float32 and rounded, as torch's bfloat16 ops do.
  // The last rounding is store2's.
  __device__ static float epilogue(float acc, float inv, float off, float s,
                                   bool relu) {
    float v = bf16_round(__fmul_rn(bf16_round(acc), inv));
    v = bf16_round(__fadd_rn(v, off));
    if (relu) v = v < 0.f ? 0.f : v;
    return __fadd_rn(s, v);
  }
};

template <typename T>
__device__ __forceinline__ float to_float(T v);
template <>
__device__ __forceinline__ float to_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// A thread computes kCells neighbouring input cells along W (sharing their
// window: kCells + 1 positions along W) for kCout output channels.
// Grid: x blocks of kThreads thread columns (flattened (md, mh, tw), a
// column kCells cells along W), y groups of kCout output channels, z the
// batch. Shared memory: the group's weights [ci][tap][kCout] then
// inv[kCout], off[kCout], as float32.
template <typename T, int SD>
__global__ void __launch_bounds__(kThreads, 4)
    deconv_bn_relu_add_kernel(const DeconvArgs a) {
  using AD = Axis<SD>;
  using AH = Axis<2>;
  constexpr int WW = kCells + 1;  // window positions along W
  extern __shared__ float4 smem4[];
  float* w_s = reinterpret_cast<float*>(smem4);
  const int Ci = a.Ci, Co = a.Co, Di = a.Di, Hi = a.Hi, Wi = a.Wi;
  const int co0 = blockIdx.y * kCout;
  const int n = blockIdx.z;
  // The group's weights, read in their (ci, co, tap) order (coalesced),
  // stored [ci][tap][c].
  const T* w = static_cast<const T*>(a.w);
  const int n_w = Ci * kTaps * kCout;
  for (int i = threadIdx.x; i < n_w; i += kThreads) {
    const int ci = i / (kCout * kTaps), r = i % (kCout * kTaps);
    const int c = r / kTaps, tap = r % kTaps, co = co0 + c;
    w_s[(ci * kTaps + tap) * kCout + c] =
        co < Co ? to_float(w[(static_cast<int64_t>(ci) * Co + co) * kTaps +
                             tap])
                : 0.f;
  }
  float* inv_s = w_s + n_w;
  float* off_s = inv_s + kCout;
  if (threadIdx.x < kCout) {
    const int co = co0 + threadIdx.x;
    inv_s[threadIdx.x] =
        co < Co ? to_float(static_cast<const T*>(a.inv)[co]) : 0.f;
    off_s[threadIdx.x] =
        co < Co ? to_float(static_cast<const T*>(a.off)[co]) : 0.f;
  }
  __syncthreads();

  const int Tw = (Wi + kCells - 1) / kCells;  // thread columns a row
  const int64_t cells = static_cast<int64_t>(Di) * Hi * Wi;
  const int64_t col =
      static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (col >= static_cast<int64_t>(Di) * Hi * Tw) return;
  const int mw = static_cast<int>(col % Tw) * kCells;
  const int mh = static_cast<int>((col / Tw) % Hi);
  const int md = static_cast<int>(col / (static_cast<int64_t>(Tw) * Hi));

  // The window's offsets in one input channel, and which are inside.
  int offs[AD::WIN][2][WW];
  bool inside[AD::WIN][2][WW];
#pragma unroll
  for (int jd = 0; jd < AD::WIN; ++jd) {
#pragma unroll
    for (int jh = 0; jh < 2; ++jh) {
#pragma unroll
      for (int jw = 0; jw < WW; ++jw) {
        const int id = md + AD::LO + jd, ih = mh + jh, iw = mw + jw;
        inside[jd][jh][jw] = id >= 0 && id < Di && ih < Hi && iw < Wi;
        offs[jd][jh][jw] = inside[jd][jh][jw] ? (id * Hi + ih) * Wi + iw : 0;
      }
    }
  }

  float acc[kCells][AD::P][2][2][kCout];
#pragma unroll
  for (int j = 0; j < kCells; ++j)
#pragma unroll
    for (int pd = 0; pd < AD::P; ++pd)
#pragma unroll
      for (int ph = 0; ph < 2; ++ph)
#pragma unroll
        for (int pw = 0; pw < 2; ++pw)
#pragma unroll
          for (int c = 0; c < kCout; ++c) acc[j][pd][ph][pw][c] = 0.f;

  const T* xc =
      static_cast<const T*>(a.x) + static_cast<int64_t>(n) * Ci * cells;
  for (int ci = 0; ci < Ci; ++ci, xc += cells) {
    float xv[AD::WIN][2][WW];
#pragma unroll
    for (int jd = 0; jd < AD::WIN; ++jd)
#pragma unroll
      for (int jh = 0; jh < 2; ++jh)
#pragma unroll
        for (int jw = 0; jw < WW; ++jw)
          xv[jd][jh][jw] =
              inside[jd][jh][jw] ? Elem<T>::load(xc + offs[jd][jh][jw]) : 0.f;
    const float4* ws =
        reinterpret_cast<const float4*>(w_s) + ci * kTaps;
#pragma unroll
    for (int pd = 0; pd < AD::P; ++pd)
#pragma unroll
      for (int ph = 0; ph < 2; ++ph)
#pragma unroll
        for (int pw = 0; pw < 2; ++pw)
#pragma unroll
          for (int td = 0; td < AD::ntaps(pd); ++td)
#pragma unroll
            for (int th = 0; th < AH::ntaps(ph); ++th)
#pragma unroll
              for (int tw = 0; tw < AH::ntaps(pw); ++tw) {
                const int tap =
                    (AD::k(pd, td) * 3 + AH::k(ph, th)) * 3 + AH::k(pw, tw);
                const float4 wq = ws[tap];
#pragma unroll
                for (int j = 0; j < kCells; ++j) {
                  const float v = xv[AD::slot(pd, td)][AH::slot(ph, th)]
                                    [j + AH::slot(pw, tw)];
                  float* r = acc[j][pd][ph][pw];
                  r[0] = fmaf(v, wq.x, r[0]);
                  r[1] = fmaf(v, wq.y, r[1]);
                  r[2] = fmaf(v, wq.z, r[2]);
                  r[3] = fmaf(v, wq.w, r[3]);
                }
              }
  }

  const int Do = SD * Di, Ho = 2 * Hi, Wo = 2 * Wi;
  const T* skip = static_cast<const T*>(a.skip);
  T* out = static_cast<T*>(a.out);
  const bool relu = a.relu != 0;
#pragma unroll
  for (int c = 0; c < kCout; ++c) {
    const int co = co0 + c;
    if (co >= Co) break;
    const float inv = inv_s[c], off = off_s[c];
#pragma unroll
    for (int j = 0; j < kCells; ++j) {
      if (j > 0 && mw + j >= Wi) break;
#pragma unroll
      for (int pd = 0; pd < AD::P; ++pd)
#pragma unroll
        for (int ph = 0; ph < 2; ++ph) {
          const int64_t at = ((static_cast<int64_t>(n) * Co + co) * Do +
                              SD * md + pd) * Ho * Wo +
                             static_cast<int64_t>(2 * mh + ph) * Wo +
                             2 * (mw + j);
          float2 s = make_float2(0.f, 0.f);
          if (skip != nullptr) s = Elem<T>::load2(skip + at);
          Elem<T>::store2(
              out + at,
              Elem<T>::epilogue(acc[j][pd][ph][0][c], inv, off, s.x, relu),
              Elem<T>::epilogue(acc[j][pd][ph][1][c], inv, off, s.y, relu));
        }
    }
  }
}

template <typename T, int SD>
int launch(const DeconvArgs& a, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(a.Ci) * kTaps * kCout + 2 * kCout);
  const int64_t cols = static_cast<int64_t>(a.Di) * a.Hi *
                       ((a.Wi + kCells - 1) / kCells);
  const dim3 grid(static_cast<unsigned>((cols + kThreads - 1) / kThreads),
                  static_cast<unsigned>((a.Co + kCout - 1) / kCout),
                  static_cast<unsigned>(a.N));
  deconv_bn_relu_add_kernel<T, SD><<<grid, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The sizes are checked by the wrapper (ops/deconv3d.py); this refuses
// only what would launch an invalid grid or overflow shared memory.
extern "C" int tandem_deconv_bn_relu_add(const DeconvArgs* a,
                                         cudaStream_t stream) {
  if (a->N < 1 || a->N > 65535 || a->Ci < 1 || a->Ci > kMaxCin ||
      a->Co < 1 || a->Di < 1 || a->Hi < 1 || a->Wi < 1 ||
      (a->stride_d != 1 && a->stride_d != 2)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (a->bf16) {
    return a->stride_d == 2 ? launch<__nv_bfloat16, 2>(*a, stream)
                            : launch<__nv_bfloat16, 1>(*a, stream);
  }
  return a->stride_d == 2 ? launch<float, 2>(*a, stream)
                          : launch<float, 1>(*a, stream);
}

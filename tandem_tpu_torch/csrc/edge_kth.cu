// The depth edge filter on the card (cva_mvsnet/models/module.py:1320-1361
// semantics): per pixel the 15th smallest |window - centre| over a 5x5
// zero-padded window, then per image the k-th smallest of those values as
// the threshold, then mask = edge > threshold and depth and confidence
// zeroed where the mask is set.
//
// Replaces the TPU kernel tandem_tpu/ops/pallas_kernels.py:59
// edge_kth_value_pallas (body _edge_kth_kernel), and the threshold, mask
// and zeroing around it that the JAX package leaves to XLA
// (tandem_tpu/models/edge_filter.py: a histogram bisection _kth_value and
// two wheres). It computes the same function, not the same blocking: the
// Pallas kernel streams row blocks of the whole padded image through VMEM
// and XLA bisects the threshold in four count passes. Here the filter is
// a memset and four launches on the caller's stream, with no host read
// between them:
//
//   1. select: each 32x16 tile is staged with a 2-pixel zero halo in shared
//      memory; each thread forms its pixel's 24 |differences| to the
//      neighbours in registers and selects the 14th smallest with a pruned
//      sorting network (edge_select.cuh). The centre's own difference is
//      +0, the least of the 25, so that is the 15th smallest of the window.
//      It writes the value to a scratch image (1.2 MB at 640x480: it stays
//      in the 50 MB L2) and counts its top 11 key bits in a shared-memory
//      histogram, which the block adds to the image's histogram.
//   2. refine: every block walks the 2,048-entry histogram to the bin that
//      holds rank k and the rank left inside it, and histograms the next 11
//      key bits of the values in that bin; block 0 stores (bin, rank).
//   3. refine: the same over the next 11 bits for the last 9.
//   4. outputs: the last walk gives the threshold's key (the k-th value
//      exactly, equal to torch.kthvalue, with no tolerance); one pass writes
//      mask, fdepth and fconf, and block 0 the threshold.
// The key of a value is its bit pattern: edge values are >= +0 (fabsf never
// yields -0), and for non-negative floats the bit patterns order as the
// values do. A memset zeroes the histograms first.
//
// Bound: operations. The selection is Parberry's pairwise sorting network
// for 32 inputs pruned to one output: 165 fminf/fmaxf a pixel, against 625
// compare-and-add pairs of rank counting before. The bytes are small (depth
// and confidence read once, fdepth, fconf and the mask written once: 5.2
// MB at 640x480); the radix passes re-read the scratch image from L2 and
// add a few integer operations a pixel. Only fminf/fmaxf move values, so
// the result is one of the 24 bit for bit, for any ties.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "edge_select.cuh"

constexpr int kMaxBatch = 64;  // images a call

// The C entry point's argument block (outside the unnamed namespace, so
// that the entry point keeps external linkage). Must match ops/edge_kth.py's
// _FILTER_ARGS.
struct FilterArgs {
  const float* depth;  // (B, H, W) float32
  const float* conf;   // (B, H, W) float32 or null
  float* fdepth;       // (B, H, W)
  float* fconf;        // (B, H, W) or null
  uint8_t* mask;       // (B, H, W) bool
  float* threshold;    // (B,): the k-th edge value of each image
  unsigned* scratch;   // (B, kScratch) histograms and state, then the
                       // (B, H, W) float32 edge values
  int B, H, W, unused;
  unsigned rank[kMaxBatch];  // k of each image: 0-indexed, < H * W
};
static_assert(sizeof(FilterArgs) == 72 + 4 * kMaxBatch, "FilterArgs layout");

namespace {

constexpr int kWin = 5;
constexpr int kHalf = kWin / 2;
constexpr int kTaps = kWin * kWin;
constexpr int kBx = 32;
constexpr int kBy = 8;
constexpr int kRowsPerThread = 2;
constexpr int kTileRows = kBy * kRowsPerThread;  // 16
constexpr int kTileW = kBx + 2 * kHalf;
constexpr int kTileH = kTileRows + 2 * kHalf;
constexpr int kThreads = kBx * kBy;  // 256

// Radix select over the 31 key bits below the sign: 11 + 11 + 9.
constexpr int kBins1 = 2048, kBins2 = 2048, kBins3 = 512;
constexpr int kShift1 = 20, kShift2 = 9;
// Per image: the three histograms, then the state: (bin of pass 1, rank
// left), (bins of passes 1-2, rank left), padded to 128 bytes, so that the
// edge values after the B images' words start on a 128-byte line.
constexpr int kStateAt = kBins1 + kBins2 + kBins3;
constexpr int kScratch = kStateAt + 32;  // uint32 words an image
constexpr int kItemsPerThread = 4;  // radix passes: items a thread
constexpr int kMaxBlocks = 1024;    // radix passes: blocks an image

// The 15th smallest |tile(y+dy, x+dx) - tile(y, x)| of the window whose top
// left corner is (ty, tx) in the tile: the 14th smallest of the 24
// neighbours' differences (the centre's is +0).
__device__ __forceinline__ float window_kth(const float (*tile)[kTileW],
                                           int ty, int tx) {
  const float c = tile[ty + kHalf][tx + kHalf];
  float v[kTaps - 1];
#pragma unroll
  for (int t = 0; t < kTaps; ++t) {
    if (t == kTaps / 2) continue;
    v[t < kTaps / 2 ? t : t - 1] =
        fabsf(tile[ty + t / kWin][tx + t % kWin] - c);
  }
  return select_rank13_of24(v);
}

// The edge values of image b, after the B images' histograms and state.
__host__ __device__ inline float* edge_values(const FilterArgs& a, int b) {
  return reinterpret_cast<float*>(a.scratch + a.B * kScratch) +
         static_cast<size_t>(b) * a.H * a.W;
}

// Launch 1 (and, without a histogram, the edge values alone): one thread
// per column of kRowsPerThread pixels of a 32x16 tile.
template <bool kHistogram>
__global__ void __launch_bounds__(kThreads)
    select_kernel(const float* __restrict__ depth, float* __restrict__ out,
                  unsigned* __restrict__ scratch, int H, int W) {
  __shared__ float tile[kTileH][kTileW];
  __shared__ unsigned hist[kHistogram ? kBins1 : 1];
  const int tid = threadIdx.y * kBx + threadIdx.x;
  const size_t plane = static_cast<size_t>(H) * W;
  const float* img = depth + blockIdx.z * plane;
  const int gx0 = blockIdx.x * kBx - kHalf;
  const int gy0 = blockIdx.y * kTileRows - kHalf;
  for (int i = tid; i < kTileH * kTileW; i += kThreads) {
    const int ty = i / kTileW, tx = i % kTileW;
    const int gy = gy0 + ty, gx = gx0 + tx;
    tile[ty][tx] = (gy >= 0 && gy < H && gx >= 0 && gx < W)
                       ? img[static_cast<size_t>(gy) * W + gx]
                       : 0.0f;
  }
  if constexpr (kHistogram) {
    for (int i = tid; i < kBins1; i += kThreads) hist[i] = 0;
  }
  __syncthreads();

  const int x = blockIdx.x * kBx + threadIdx.x;
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    const int ty = threadIdx.y + r * kBy;
    const int y = blockIdx.y * kTileRows + ty;
    if (x < W && y < H) {
      const float kth = window_kth(tile, ty, threadIdx.x);
      out[blockIdx.z * plane + static_cast<size_t>(y) * W + x] = kth;
      if constexpr (kHistogram) {
        atomicAdd(&hist[__float_as_uint(kth) >> kShift1], 1u);
      }
    }
  }
  if constexpr (kHistogram) {
    __syncthreads();
    unsigned* ghist = scratch + blockIdx.z * kScratch;
    for (int i = tid; i < kBins1; i += kThreads) {
      if (hist[i]) atomicAdd(&ghist[i], hist[i]);
    }
  }
}

// The whole block finds the bin of ``counts`` (kBins entries) that holds
// the rank-th smallest counted value, 0-indexed: before <= rank < before +
// counts[bin]. Every thread returns (bin, rank - before). The counts sum to
// more than rank, so exactly one thread finds it.
template <int kBins>
__device__ uint2 walk(const unsigned* counts, unsigned rank) {
  constexpr int kPer = kBins / kThreads;
  __shared__ unsigned warp_sums[kThreads / 32];
  __shared__ uint2 found;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  unsigned c[kPer], sum = 0;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    c[i] = counts[tid * kPer + i];
    sum += c[i];
  }
  unsigned incl = sum;  // inclusive scan over the warp
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const unsigned v = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += v;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  unsigned before = incl - sum;
  for (int w = 0; w < warp; ++w) before += warp_sums[w];
  if (rank >= before && rank - before < sum) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      if (rank - before < c[i]) {
        found = make_uint2(tid * kPer + i, rank - before);
        break;
      }
      before += c[i];
    }
  }
  __syncthreads();
  return found;
}

// Launches 2 and 3: histogram the next key bits of the values in the bin
// that holds rank k. kPass 2: the bin of histogram 1, bits 19..9 into
// histogram 2; kPass 3: the bin of histogram 2 within it, bits 8..0 into
// histogram 3.
template <int kPass>
__global__ void __launch_bounds__(kThreads) refine_kernel(FilterArgs a) {
  constexpr int kBins = kPass == 2 ? kBins2 : kBins3;
  __shared__ unsigned hist[kBins];
  const int b = blockIdx.y;
  unsigned* img_scratch = a.scratch + b * kScratch;
  unsigned* state = img_scratch + kStateAt;
  unsigned prefix;  // the key bits above this pass's, of the selected bin
  uint2 sel;
  if constexpr (kPass == 2) {
    sel = walk<kBins1>(img_scratch, a.rank[b]);
    prefix = sel.x;
  } else {
    sel = walk<kBins2>(img_scratch + kBins1, state[1]);
    prefix = (state[0] << (kShift1 - kShift2)) | sel.x;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    state[kPass == 2 ? 0 : 2] = prefix;
    state[kPass == 2 ? 1 : 3] = sel.y;
  }
  for (int i = threadIdx.x; i < kBins; i += kThreads) hist[i] = 0;
  __syncthreads();
  const int n = a.H * a.W;
  const float* edge = edge_values(a, b);
  const int shift = kPass == 2 ? kShift1 : kShift2;
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < n;
       i += gridDim.x * kThreads) {
    const unsigned key = __float_as_uint(edge[i]);
    if ((key >> shift) == prefix) {
      atomicAdd(&hist[kPass == 2 ? (key >> kShift2) & (kBins2 - 1)
                                 : key & (kBins3 - 1)],
                1u);
    }
  }
  __syncthreads();
  unsigned* ghist = img_scratch + (kPass == 2 ? kBins1 : kBins1 + kBins2);
  for (int i = threadIdx.x; i < kBins; i += kThreads) {
    if (hist[i]) atomicAdd(&ghist[i], hist[i]);
  }
}

// Launch 4: the threshold's key from histogram 3, then the outputs.
__global__ void __launch_bounds__(kThreads) output_kernel(FilterArgs a) {
  const int b = blockIdx.y;
  unsigned* img_scratch = a.scratch + b * kScratch;
  unsigned* state = img_scratch + kStateAt;
  const uint2 sel = walk<kBins3>(img_scratch + kBins1 + kBins2, state[3]);
  const unsigned thres = (state[2] << kShift2) | sel.x;
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    a.threshold[b] = __uint_as_float(thres);
  }
  const int n = a.H * a.W;
  const size_t base = static_cast<size_t>(b) * n;
  const float* edge = edge_values(a, b);
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < n;
       i += gridDim.x * kThreads) {
    const bool drop = __float_as_uint(edge[i]) > thres;
    a.mask[base + i] = drop;
    a.fdepth[base + i] = drop ? 0.0f : a.depth[base + i];
    if (a.conf) a.fconf[base + i] = drop ? 0.0f : a.conf[base + i];
  }
}

dim3 select_grid(int B, int H, int W) {
  return dim3((W + kBx - 1) / kBx, (H + kTileRows - 1) / kTileRows, B);
}

}  // namespace

// depth, out: (B, H, W) float32, contiguous, on the current device: the
// edge values alone (launch 1 without its histogram). Launches on
// ``stream`` without synchronising; returns cudaGetLastError().
extern "C" int tandem_edge_kth(const float* depth, float* out, int B, int H,
                               int W, cudaStream_t stream) {
  select_kernel<false><<<select_grid(B, H, W), dim3(kBx, kBy), 0, stream>>>(
      depth, out, nullptr, H, W);
  return static_cast<int>(cudaGetLastError());
}

// The whole filter: a memset of the histograms and four launches on
// ``stream``, no synchronisation, no host read. All arrays contiguous.
// ``*launched`` counts the kernels launched. Returns the first launch
// error, or cudaErrorInvalidValue for sizes it does not take.
extern "C" int tandem_edge_filter(const FilterArgs* a, int* launched,
                                  cudaStream_t stream) {
  *launched = 0;
  const int64_t n = static_cast<int64_t>(a->H) * a->W;
  if (a->B < 1 || a->B > kMaxBatch || a->H < 1 || a->W < 1 ||
      n >= (int64_t{1} << 31) ||
      (a->conf == nullptr) != (a->fconf == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int b = 0; b < a->B; ++b) {
    if (a->rank[b] >= n) return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaMemsetAsync(
      a->scratch, 0, sizeof(unsigned) * kScratch * a->B, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  select_kernel<true><<<select_grid(a->B, a->H, a->W), dim3(kBx, kBy), 0,
                        stream>>>(a->depth, edge_values(*a, 0), a->scratch,
                                  a->H, a->W);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  ++*launched;
  const int64_t per_block = int64_t{kThreads} * kItemsPerThread;
  const int blocks = static_cast<int>(
      n / per_block + 1 < kMaxBlocks ? n / per_block + 1 : kMaxBlocks);
  const dim3 grid(blocks, a->B);
  refine_kernel<2><<<grid, kThreads, 0, stream>>>(*a);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  ++*launched;
  refine_kernel<3><<<grid, kThreads, 0, stream>>>(*a);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  ++*launched;
  output_kernel<<<grid, kThreads, 0, stream>>>(*a);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  ++*launched;
  return 0;
}

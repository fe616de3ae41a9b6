// Row gather: out[i, :] = table[idx[i], :] for rows of any width in bytes.
//
// Replaces three TPU kernels that compute this one function and differ
// only in how Mosaic could lower it: experiments/pallas_gather_probe.py
// make_pallas_sublane (take_along_axis) and make_pallas_take (jnp.take),
// and experiments/pallas_shuffle_probe.py make_shuffle (table-shaped
// chunks). All three hold the table in VMEM; on this card the table stays
// in device memory behind the 50 MB L2 (the probes' 77,361-row tables are
// 2.5-19.8 MB) and the kernel is a plain vectorised copy.
//
// Bound: memory. Each row is moved as row_bytes / vec_bytes vector words;
// neighbouring threads copy neighbouring words of one row, so a warp reads
// whole rows (16-byte words where the row width and the pointers allow).
// A row outside [0, m) reads as zeros.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename W>
__global__ void row_gather_kernel(const W* __restrict__ table,
                                  const int* __restrict__ idx, int64_t n,
                                  int64_t m, int64_t words,
                                  W* __restrict__ out) {
  const int64_t total = n * words;
  for (int64_t t = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                   threadIdx.x;
       t < total; t += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t i = t / words;
    const int64_t j = t - i * words;
    const int r = idx[i];
    W v{};
    if (r >= 0 && r < m) v = table[static_cast<int64_t>(r) * words + j];
    out[t] = v;
  }
}

template <typename W>
int launch(const void* table, const int* idx, int64_t n, int64_t m,
           int64_t row_bytes, void* out, cudaStream_t stream) {
  constexpr int kThreads = 256;
  const int64_t words = row_bytes / static_cast<int64_t>(sizeof(W));
  const int64_t want = (n * words + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < 65535 * 16 ? want : 65535 * 16);
  row_gather_kernel<W><<<blocks, kThreads, 0, stream>>>(
      static_cast<const W*>(table), idx, n, m, words, static_cast<W*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// table: (m, row_bytes) bytes, contiguous; idx: n int32; out: (n,
// row_bytes). vec_bytes in {16, 8, 4, 2, 1} divides row_bytes and the
// alignment of both pointers (chosen by the wrapper).
// Launches on ``stream`` without synchronising; returns cudaGetLastError().
extern "C" int tandem_row_gather(const void* table, const int* idx,
                                 int64_t n, int64_t m, int64_t row_bytes,
                                 int vec_bytes, void* out,
                                 cudaStream_t stream) {
  if (n <= 0 || row_bytes <= 0) return 0;
  switch (vec_bytes) {
    case 16:
      return launch<uint4>(table, idx, n, m, row_bytes, out, stream);
    case 8:
      return launch<uint2>(table, idx, n, m, row_bytes, out, stream);
    case 4:
      return launch<uint32_t>(table, idx, n, m, row_bytes, out, stream);
    case 2:
      return launch<uint16_t>(table, idx, n, m, row_bytes, out, stream);
    case 1:
      return launch<uint8_t>(table, idx, n, m, row_bytes, out, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Kernel M4 — the BELL reduction forest max-fold over int32 neg-distance
// lanes, with the async drive's candidate step fused into it.
//
// Replaces the XLA chains of the JAX package's 2D mesh async drive:
// parallel/partition2d.py:1116 forest_max (ops/bell.py forest_hits with a
// max over each bucket's width, then :1070 _async_cand on the gathered
// maxima) and the streamed residency's ops/streamed.py:117
// _segment_fold(..., fold="max").  One launch folds one forest level, or
// one uploaded slot segment of it, over (rows, W) int32 planes (W lanes a
// row, one query a lane, 0 = unreached):
//
//   out[row_base_b + r, w] = MAX_{j < W_b} f(prev[cols[off_b + r*W_b + j], w])
//
// a slot equal to prev_rows reading 0.  ``cand`` applies
//   f(x) = y >= floor ? y : 0,  y = max(x - 1, 0)
// to every value read (forest level 0, whose prev is the gathered col
// block), else f(x) = x.  f is monotone and f(0) = 0, so applying it
// before the max equals JAX's _async_cand after the forest (one more hop
// is one level further; the horizon ``floor`` = NEG_BASE - max_levels
// zeroes a candidate beyond it).  The final take by final_slot is K1s's
// forest_gather (forest_or.cu), which copies rows of any int32 lanes.
//
// Design (a first, simple kernel): a thread a (row, lane), grid-stride;
// each block keeps the level's bucket table (slot offset, rows, width,
// first row; as the segment tables of ops/cuda_bell.py cut it) in shared
// memory and finds its row's bucket by binary search.  The lanes of a row
// are consecutive threads, so a slot's row read coalesces (W = 32 lanes:
// one 128-byte line) and its cols entry is one broadcast load.
//
// Bound: bytes — the level's cols once (4 bytes a slot), each slot's
// source row (4 W bytes), the output rows written.
#include "msbfs_common.cuh"

namespace {

constexpr int kMaxBuckets = 64;
constexpr int kTab = 6;  // off, rows, width, row_base, (first run, rows per chunk: unused)

template <bool kCand>
__global__ void __launch_bounds__(msbfs::kThreads)
forest_max_kernel(const int* __restrict__ prev, long long prev_rows,
                  const int* __restrict__ cols, const long long* __restrict__ table, int nb,
                  long long rows, int* __restrict__ out, int W, int floor) {
  __shared__ long long s_tab[kMaxBuckets * kTab];
  for (int i = threadIdx.x; i < nb * kTab; i += blockDim.x) s_tab[i] = table[i];
  __syncthreads();
  const long long items = rows * W;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long t = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; t < items;
       t += stride) {
    const long long r = t / W;
    const int w = static_cast<int>(t - r * W);
    // The last bucket whose first row is <= r.
    int lo = 0, hi = nb - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (s_tab[mid * kTab + 3] <= r) lo = mid; else hi = mid - 1;
    }
    const long long* b = s_tab + lo * kTab;
    const int width = static_cast<int>(b[2]);
    const int* c = cols + b[0] + (r - b[3]) * width;
    int acc = 0;
    for (int j = 0; j < width; ++j) {
      const long long src = __ldg(c + j);
      int v = src < prev_rows ? __ldcg(prev + src * W + w) : 0;
      if constexpr (kCand) {
        v = v > 1 ? v - 1 : 0;
        if (v < floor) v = 0;
      }
      acc = max(acc, v);
    }
    out[t] = acc;
  }
}

}  // namespace

// One forest level or segment: table (buckets, 6) int64 on the device
// (slot offsets relative to ``cols``, first rows relative to ``out``),
// ``rows`` output rows of W int32 lanes; prev: (prev_rows, W) int32.
// cand: 1 applies the candidate step with ``floor`` to every value read.
extern "C" int msbfs_forest_max(int device, const void* prev, long long prev_rows,
                                const void* cols, const void* table, int buckets,
                                long long rows, void* out, int W, int cand, int floor,
                                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (W < 1 || prev_rows < 0 || prev_rows >= (1LL << 31) || buckets < 1 ||
      buckets > kMaxBuckets || rows < 0 || (cand != 0 && cand != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rows == 0) return static_cast<int>(cudaSuccess);
  const int grid = msbfs::grid_for(rows * W, msbfs::kThreads);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* p = static_cast<const int*>(prev);
  const auto* c = static_cast<const int*>(cols);
  const auto* t = static_cast<const long long*>(table);
  auto* o = static_cast<int*>(out);
  if (cand) {
    forest_max_kernel<true><<<grid, msbfs::kThreads, 0, s>>>(p, prev_rows, c, t, buckets, rows,
                                                             o, W, floor);
  } else {
    forest_max_kernel<false><<<grid, msbfs::kThreads, 0, s>>>(p, prev_rows, c, t, buckets, rows,
                                                              o, W, floor);
  }
  return static_cast<int>(cudaGetLastError());
}

// Kernel K4 — source packing, at any lane stride.
//
// Replaces the JAX package's ops/bitbell.py:93 pack_queries (stride 1: query
// q at bit q, 32 queries a word) and ops/lowk.py:66 lowk_pack (stride 8:
// query q in byte q of a row of 0/1 bytes, which the port views as words:
// bit 8q, since host and card are little-endian).  For (K, S) int32
// queries padded with -1:
//
//   for every q < K, s < S with 0 <= v = queries[q, s] < n:
//     plane[v, bit / 32] |= 1 << (bit % 32)       with bit = q * stride
//     counts[bit] = the distinct v of query q
//
// Sources outside [0, n), the -1 padding among them, are dropped: the
// reference's bounds check (main.cu:46-51).  The plane and the counts must
// be zero before the launch.
//
// Design: one thread per (q, s) in a grid-stride loop.  The old value of
// the atomicOr says whether this thread set the bit first, so exactly one
// thread of each distinct (v, q) pair counts it: exact distinct counts with
// no sort and no host read (the plain torch version sorts the pairs, and
// its unique() reads its output size back to the host).  counts is
// indexed by lane, as the level apply's per-lane counters are.
//
// Bound: bytes.  The launch reads the queries (4 bytes each) and writes
// the words it reaches and the counts: a few KB on every route of the
// port.  What a batch start really pays is the launch itself, plus the
// wrapper's upload of the queries and its zeroing of the plane.
#include "msbfs_common.cuh"

namespace {

__global__ void __launch_bounds__(msbfs::kThreads)
pack_sources_kernel(const int* __restrict__ queries, long long total, long long s,
                    long long n, uint32_t* __restrict__ plane, int w, int stride,
                    int* __restrict__ counts) {
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       i < total; i += step) {
    const int v = __ldg(queries + i);
    if (v < 0 || v >= n) continue;
    const int bit = static_cast<int>(i / s) * stride;
    const uint32_t mask = 1u << (bit & 31);
    const uint32_t old =
        atomicOr(plane + static_cast<size_t>(v) * w + (bit >> 5), mask);
    if (!(old & mask)) atomicAdd(counts + bit, 1);
  }
}

}  // namespace

// queries: (k, s) int32, row-major; plane: (n, w) words, zero; counts:
// (32 w,) int32, zero; stride: the lanes between two queries' bits, with
// k * stride <= 32 w.  An empty batch (k * s == 0) launches nothing.
extern "C" int msbfs_pack_sources(int device, const void* queries, long long k,
                                  long long s, long long n, void* plane, int w,
                                  int stride, void* counts, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (k < 0 || s < 0 || n < 0 || w < 1 || stride < 1 ||
      k * stride > 32LL * w) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long total = k * s;
  if (total == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  pack_sources_kernel<<<msbfs::grid_for(total, msbfs::kThreads), msbfs::kThreads,
                        0, st>>>(
      static_cast<const int*>(queries), total, s, n,
      static_cast<uint32_t*>(plane), w, stride, static_cast<int*>(counts));
  return static_cast<int>(cudaGetLastError());
}

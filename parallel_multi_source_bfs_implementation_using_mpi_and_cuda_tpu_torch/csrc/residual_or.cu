// Kernel B — the stencil residual segment-OR.
//
// Replaces the XLA ops of the JAX package's ops/stencil.py:319-340 (the
// residual half of stencil_hits): a row gather of the residual sources'
// frontier words, an unpack to 0/1 bytes, a sorted segment_max over the
// destinations, a re-pack, and one row merge into the hit plane.  torch has
// no OR reduction, so that chain has no single-op counterpart; here it is
//
//   for every residual edge r and word w:
//     hits[res_dst_unique[res_seg[r]], w] |= frontier[res_src[r], w]
//
// with atomicOr resolving edges that share a destination.  It runs on the
// same stream after the sweep (kernel A) has written the hit plane and
// before the level apply (kernel C) reads it.
//
// Bound: bytes, and small — per level R * (8 + 4W) bytes of edge lists and
// gathered source words plus U * 8W bytes of destination read-modify-write,
// against the sweep's rows * (4 + 8W).  Design: one thread per (edge, word);
// zero source words issue no atomic, so levels where the residual sources
// are idle cost little more than reading the edge lists.
#include "msbfs_common.cuh"

namespace {

__global__ void __launch_bounds__(msbfs::kThreads)
residual_or_kernel(const uint32_t* __restrict__ frontier,
                   const int* __restrict__ res_src,
                   const int* __restrict__ res_seg,
                   const int* __restrict__ res_dst_unique,
                   uint32_t* __restrict__ hits, long long R, int W,
                   const int* __restrict__ ctrl, int max_levels) {
  if (!msbfs::level_go(ctrl, max_levels)) return;
  const long long total = R * W;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < total; i += stride) {
    const long long r = i / W;
    const int w = static_cast<int>(i - r * W);
    const uint32_t x =
        __ldg(frontier + static_cast<long long>(__ldg(res_src + r)) * W + w);
    if (x) {
      const long long dst = __ldg(res_dst_unique + __ldg(res_seg + r));
      atomicOr(hits + dst * W + w, x);
    }
  }
}

}  // namespace

extern "C" int msbfs_residual_or(int device, const void* frontier,
                                 const void* res_src, const void* res_seg,
                                 const void* res_dst_unique, void* hits,
                                 long long R, int W, const void* ctrl,
                                 int max_levels, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (W < 1 || R < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = msbfs::grid_for(R * W, msbfs::kThreads);
  residual_or_kernel<<<grid, msbfs::kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(frontier),
      static_cast<const int*>(res_src), static_cast<const int*>(res_seg),
      static_cast<const int*>(res_dst_unique), static_cast<uint32_t*>(hits),
      R, W, static_cast<const int*>(ctrl), max_levels);
  return static_cast<int>(cudaGetLastError());
}

// Kernel A — the stencil masked-shift sweep.
//
// Replaces the TPU kernel ops/pallas_stencil.py:75 make_kernel (the gridless
// pallas_call chain entered through pallas_hits, :126) and its XLA twin
// ops/stencil.py:285 _xla_shift_hits, both in the JAX package.  For every
// vertex v and word w of a (rows, W) plane:
//
//   hits[v, w] = OR over offsets i of  frontier[v - d_i, w]
//                where 0 <= v - d_i < rows and bit i of mask[v - d_i] is set
//
// i.e. the frontier of every source u whose edge (u, u + d_i) exists is
// shifted onto u + d_i, with zero fill past either end of the plane (a
// window of rows is zero-filled at its own ends, exactly as the JAX window
// slices it).
//
// Bound: bytes.  Per level it must read the frontier plane (4W bytes per
// vertex) and the mask word (4 bytes) once and write the hit plane (4W),
// so rows * (4 + 8W) bytes; at most 16 offsets cost a few integer
// operations each.  Design: one thread per (vertex, word), row-major so a
// warp reads consecutive words; the shifted neighbour reads of all offsets
// hit rows within max|d| of each other and are served from L1/L2, so device
// memory sees each plane about once.  The TPU version's (4096, 128) row
// chunks with a stitched halo existed only to fit one VMEM block; a grid-
// stride loop over the whole plane needs no halo.  Offsets travel by value
// in the launch (at most 32, one mask bit each).
#include "msbfs_common.cuh"

namespace {

struct Offsets {
  int count;
  int d[32];
};

__global__ void __launch_bounds__(msbfs::kThreads)
stencil_sweep_kernel(const uint32_t* __restrict__ frontier,
                     const uint32_t* __restrict__ mask,
                     uint32_t* __restrict__ hits, long long rows, int W,
                     Offsets off, const int* __restrict__ ctrl,
                     int max_levels) {
  if (!msbfs::level_go(ctrl, max_levels)) return;
  const long long total = rows * W;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < total; i += stride) {
    const long long v = i / W;
    const int w = static_cast<int>(i - v * W);
    uint32_t acc = 0;
    for (int k = 0; k < off.count; ++k) {
      const long long u = v - off.d[k];
      if (u >= 0 && u < rows && ((__ldg(mask + u) >> k) & 1u)) {
        acc |= __ldg(frontier + u * W + w);
      }
    }
    hits[i] = acc;
  }
}

}  // namespace

extern "C" int msbfs_stencil_sweep(int device, const void* frontier,
                                   const void* mask, void* hits,
                                   long long rows, int W,
                                   const int* offsets, int num_offsets,
                                   const void* ctrl, int max_levels,
                                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (num_offsets < 0 || num_offsets > 32 || W < 1 || rows < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Offsets off;
  off.count = num_offsets;
  for (int k = 0; k < 32; ++k) off.d[k] = k < num_offsets ? offsets[k] : 0;
  const int grid = msbfs::grid_for(rows * W, msbfs::kThreads);
  stencil_sweep_kernel<<<grid, msbfs::kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(frontier),
      static_cast<const uint32_t*>(mask), static_cast<uint32_t*>(hits), rows,
      W, off, static_cast<const int*>(ctrl), max_levels);
  return static_cast<int>(cudaGetLastError());
}

// Kernel K3 — the thin-frontier push scatter-OR.
//
// Replaces the XLA chain of the JAX package's ops/bitbell.py:225
// sparse_hits_or (budget compaction of the active rows, dedup-CSR edge
// expansion, byte-lane scatter-max, re-pack).  For a (rows, W) frontier
// plane and the dedup CSR (start, count, vals):
//
//   hits = 0
//   for every vertex u and word w with frontier[u, w] != 0:
//     for every dedup neighbour v of u:  hits[v, w] |= frontier[u, w]
//
// atomicOr on 32-bit words is the OR the JAX chain builds from byte lanes
// and scatter-max, so no compaction buffer is needed: the result is exact
// for any frontier, and in particular on every level the direction switch
// routes here.  The residual kernel (residual_or.cu) ORs along an edge
// list; here each active vertex expands its own CSR row, so the two share
// only the gate.
//
// Bound: bytes.  A level must read the frontier plane (4W bytes per row),
// the CSR row bounds and neighbour lists of the active rows, and write the
// hit plane: rows * 8W + active * 8 + edges * 4 bytes.  Design: two
// launches on one stream, both gated on the device control (level_go and
// ctrl[3] == kDirPush), so a level the switch sends to the matmul costs two
// empty launches: a grid-stride zeroing of the hit plane, then the scatter,
// in which each warp scans 32 consecutive rows (one per lane), ballots the
// active ones, and expands each active row with all 32 lanes striding over
// its neighbours — a thin frontier costs little more than the scan.
#include "msbfs_common.cuh"

namespace {

__global__ void __launch_bounds__(msbfs::kThreads)
push_zero_kernel(uint32_t* __restrict__ hits, long long total,
                 const int* __restrict__ ctrl, int max_levels) {
  if (!msbfs::direction_go(ctrl, max_levels, msbfs::kDirPush)) return;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < total; i += stride) {
    hits[i] = 0u;
  }
}

__global__ void __launch_bounds__(msbfs::kThreads)
push_or_kernel(const uint32_t* __restrict__ frontier,
               const int* __restrict__ start, const int* __restrict__ count,
               const int* __restrict__ vals, uint32_t* __restrict__ hits,
               long long rows, int W, const int* __restrict__ ctrl,
               int max_levels) {
  if (!msbfs::direction_go(ctrl, max_levels, msbfs::kDirPush)) return;
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const long long groups = (rows + 31) / 32;
  for (long long g = static_cast<long long>(blockIdx.x) * warps +
                     (threadIdx.x >> 5);
       g < groups; g += static_cast<long long>(gridDim.x) * warps) {
    // g is uniform across the warp, so every lane reaches the ballot.
    const long long base = g * 32;
    const long long mine = base + lane;
    bool active = false;
    if (mine < rows) {
      for (int w = 0; w < W && !active; ++w) {
        active = __ldg(frontier + mine * W + w) != 0u;
      }
    }
    unsigned todo = __ballot_sync(0xffffffffu, active);
    while (todo) {
      const long long u = base + (__ffs(todo) - 1);
      todo &= todo - 1;
      const int s = __ldg(start + u);
      const int c = __ldg(count + u);
      for (int w = 0; w < W; ++w) {
        const uint32_t x = __ldg(frontier + u * W + w);
        if (!x) continue;
        for (int e = lane; e < c; e += 32) {
          const long long v = __ldg(vals + s + e);
          atomicOr(hits + v * W + w, x);
        }
      }
    }
  }
}

}  // namespace

extern "C" int msbfs_push_or(int device, const void* frontier,
                             const void* start, const void* count,
                             const void* vals, void* hits, long long rows,
                             int W, const void* ctrl, int max_levels,
                             void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (W < 1 || rows < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* c = static_cast<const int*>(ctrl);
  push_zero_kernel<<<msbfs::grid_for(rows * W, msbfs::kThreads),
                     msbfs::kThreads, 0, s>>>(static_cast<uint32_t*>(hits),
                                              rows * W, c, max_levels);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long groups = (rows + 31) / 32;
  push_or_kernel<<<msbfs::grid_for(groups, msbfs::kThreads / 32),
                   msbfs::kThreads, 0, s>>>(
      static_cast<const uint32_t*>(frontier), static_cast<const int*>(start),
      static_cast<const int*>(count), static_cast<const int*>(vals),
      static_cast<uint32_t*>(hits), rows, W, c, max_levels);
  return static_cast<int>(cudaGetLastError());
}

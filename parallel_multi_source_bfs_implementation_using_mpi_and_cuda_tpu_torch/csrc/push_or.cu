// Kernel K3 — the thin-frontier push scatter-OR.
//
// Replaces the XLA chain of the JAX package's ops/bitbell.py:225
// sparse_hits_or (budget compaction of the active rows, dedup-CSR edge
// expansion, byte-lane scatter-max, re-pack) and, with the level apply's
// switch epilogue (level_apply.cu), the frontier-density estimate and the
// predicate that route a level to it.  For a (rows, W) frontier plane and
// the dedup CSR (start, vals):
//
//   for every row u of the worklist and every dedup neighbour v of u:
//     hits[v] |= frontier[u]
//
// into a hit plane that is all zero on entry (the apply clears every hit
// word it consumes).  The worklist (msbfs_common.cuh) is what the previous
// level's apply left: the active rows that have out-edges, each with its
// exclusive prefix of out-degrees, so the level's edges form one edge
// space [0, T).  atomicOr on 32-bit words is the OR the JAX chain builds
// from byte lanes and scatter-max, so no compaction buffer is needed: the
// result is exact for any frontier the predicate routes here.
//
// Bound: bytes.  A level must read the worklist (8 bytes an entry), each
// listed row's W words and CSR start, its neighbour list (4 bytes an
// edge), and write the hit words it reaches (4W bytes a reached row).
// Design: one launch, gated on the device control (level_go and ctrl[3] ==
// kDirPush), so a pull level costs one empty launch; its walk is
// push_walk.cuh's (equal shares of whole 32-edge steps a warp, a ballot
// search for a warp's first entry, a shuffle search a lane a step).
#include "push_walk.cuh"

namespace {

template <int W>
__global__ void __launch_bounds__(msbfs::kPushThreads)
push_or_kernel(const uint32_t* __restrict__ frontier,
               const int* __restrict__ start, const int* __restrict__ vals,
               uint32_t* __restrict__ hits, int w_any,
               const int* __restrict__ wl_rows,
               const int* __restrict__ wl_offs,
               const long long* __restrict__ state,
               const int* __restrict__ ctrl, int max_levels) {
  if (!msbfs::direction_go(ctrl, max_levels, msbfs::kDirPush)) return;
  msbfs::push_walk<W>(frontier, start, vals, hits, w_any, wl_rows, wl_offs, state,
                      gridDim.x, blockIdx.x);
}

}  // namespace

// worklist: the (2, cap) int32 buffer and state the (kSwitchWords,) int64
// vector of msbfs_common.cuh; edge_cap: the most edges a push level can
// have (the predicate's edge limit, at most the CSR's length), which sizes
// the grid.  vec: the frontier's base is 16-byte aligned, so W in 2, 4, 8
// take vector loads.
extern "C" int msbfs_push_or(int device, const void* frontier,
                             const void* start, const void* vals, void* hits,
                             long long rows, int W, const void* worklist,
                             long long cap, const void* state,
                             long long edge_cap, int vec, const void* ctrl,
                             int max_levels, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (W < 1 || rows < 0 || rows * W >= (1LL << 31) || cap < 0 || edge_cap < 0 ||
      state == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* wl = static_cast<const int*>(worklist);
  const int* offs = wl ? wl + cap : nullptr;
  int grid = 0;
  err = msbfs::push_blocks(device, edge_cap, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto args = [&](auto kernel) {
    kernel<<<grid, msbfs::kPushThreads, 0, s>>>(
        static_cast<const uint32_t*>(frontier), static_cast<const int*>(start),
        static_cast<const int*>(vals), static_cast<uint32_t*>(hits), W, wl,
        offs, static_cast<const long long*>(state),
        static_cast<const int*>(ctrl), max_levels);
  };
  if (W == 1) {
    args(push_or_kernel<1>);
  } else if (vec && W == 2) {
    args(push_or_kernel<2>);
  } else if (vec && W == 4) {
    args(push_or_kernel<4>);
  } else if (vec && W == 8) {
    args(push_or_kernel<8>);
  } else {
    args(push_or_kernel<0>);
  }
  return static_cast<int>(cudaGetLastError());
}

// Kernel K9 — one level of the CSR pull of the vmap and packed routes.
//
// Replaces two XLA chains of the JAX package: ops/bfs.py:65
// frontier_expand (one query's (n,) distances, vmapped over the batch) and
// ops/packed.py:111 _packed_expand (the query-minor (n, K) matrix), each
// with the level update of its loop (ops/bfs.py:173 distance_chunk).  For
// distances dist (K, n) int32 and the CSR (offsets (n+1,), cols (E,)):
//
//   new[q, v]  = dist[q, v] == -1 and some cols[s] of v's slots has
//                dist[q, cols[s]] == level[q]          (queries that may run)
//   dist       = level + 1 where new
//   updated[q] = any(new[q]);  level[q] += 1           (running queries only)
//
// A query "may run" while updated[q] and level[q] < stop[q] (the chunk's
// bound, ops/bfs.py arm_chunk); ctrl[0] = some query may run, every launch
// returns at once when it is 0, and the last block of a level recomputes it
// (ctrl[2] is its ticket, found[q] the level's per-query flag, both zero
// between levels).  No host read.
//
// The XLA chains gather a frontier flag for every slot and reduce it per
// row with a sorted segment_max: an (E,) byte intermediate a query, and an
// (E, K) one for the packed matrix (2.15 GB at RMAT-20, K = 64), which the
// JAX package cuts into MSBFS_EDGE_CHUNKS slices.  Here a thread walks the
// slots of one unreached (query, vertex) pair and stops at the first
// neighbour at the level, writing the new distance in place: nothing is
// materialised, so the edge chunks bound nothing.  The in-place write is
// safe within the level: a label goes from -1 to level + 1, and the walk
// only tests for level, which no thread writes.
//
// One source, two layouts, told apart by the distance view's strides:
//   rows  (vmap: dist[q, v] at q * sq + v): a block's threads stride over
//         the vertices of one query (blockIdx.y), so the unreached test
//         reads neighbouring words; a block ORs its labels into found[q];
//   minor (packed: dist[q, v] at v * sv + q, the (n, K) matrix seen as
//         (K, n)): a warp a vertex, its lanes over the queries, so a slot's
//         neighbour row is read by the warp in one coalesced sweep and the
//         slot ids are one broadcast load; per-query levels and found flags
//         sit in shared memory.
//
// Bound: bytes.  A level must read the offsets of the unreached rows, the
// cols of the slots it walks and the distance word each slot names, and
// write the new labels (chip_smoke.py counts them on a real level).
// Early exit saves the cols of a row after its first hit, as the JAX
// package's pull cannot.
#include "msbfs_common.cuh"

namespace {

__device__ __forceinline__ bool may_run(const int* updated, const int* level,
                                        const int* stop, int q) {
  return __ldcg(updated + q) != 0 && __ldcg(level + q) < __ldcg(stop + q);
}

// The level's tail, run by every block after its walk: the block that
// takes the last ticket folds found into updated/level and rewrites the
// go flag.
__device__ __forceinline__ void finish_level(int* level, int* updated,
                                             const int* stop, int* found,
                                             int* ctrl, int K) {
  __shared__ bool s_last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const int blocks = static_cast<int>(gridDim.x * gridDim.y);
    s_last = atomicAdd(ctrl + 2, 1) == blocks - 1;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  int go = 0;
  for (int q = threadIdx.x; q < K; q += blockDim.x) {
    int up = __ldcg(updated + q);
    int lv = __ldcg(level + q);
    const int st = __ldcg(stop + q);
    if (up != 0 && lv < st) {
      up = __ldcg(found + q) != 0;
      lv += 1;
      updated[q] = up;
      level[q] = lv;
    }
    found[q] = 0;
    go |= up != 0 && lv < st;
  }
  go = __syncthreads_or(go);
  if (threadIdx.x == 0) {
    ctrl[0] = go;
    ctrl[2] = 0;
  }
}

__global__ void __launch_bounds__(msbfs::kThreads)
csr_pull_rows(const int* __restrict__ offs, const int* __restrict__ cols,
              int* dist, long long n, long long sq, int* level, int* updated,
              const int* stop, int* found, int* ctrl, int K) {
  if (__ldcg(ctrl) == 0) return;
  const int q = blockIdx.y;
  bool any = false;
  if (may_run(updated, level, stop, q)) {
    const int lv = __ldcg(level + q);
    int* d = dist + q * sq;
    const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
    for (long long v = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
         v < n; v += step) {
      if (d[v] != -1) continue;
      const int b = __ldg(offs + v + 1);
      for (int s = __ldg(offs + v); s < b; ++s) {
        if (d[__ldg(cols + s)] == lv) {
          d[v] = lv + 1;
          any = true;
          break;
        }
      }
    }
  }
  if (__syncthreads_or(any) && threadIdx.x == 0) found[q] = 1;
  finish_level(level, updated, stop, found, ctrl, K);
}

__global__ void __launch_bounds__(msbfs::kThreads)
csr_pull_minor(const int* __restrict__ offs, const int* __restrict__ cols,
               int* dist, long long n, long long sv, int* level, int* updated,
               const int* stop, int* found, int* ctrl, int K) {
  if (__ldcg(ctrl) == 0) return;
  extern __shared__ int s_mem[];
  int* s_level = s_mem;      // the query's level, or -1 when it does not run
  int* s_found = s_mem + K;
  for (int q = threadIdx.x; q < K; q += blockDim.x) {
    s_level[q] = may_run(updated, level, stop, q) ? __ldcg(level + q) : -1;
    s_found[q] = 0;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const long long warps = static_cast<long long>(gridDim.x) * (blockDim.x >> 5);
  for (long long v = static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) +
                     (threadIdx.x >> 5);
       v < n; v += warps) {
    const int a = __ldg(offs + v);
    const int b = __ldg(offs + v + 1);
    int* row = dist + v * sv;
    for (int q = lane; q < K; q += 32) {
      const int lv = s_level[q];
      if (lv < 0 || row[q] != -1) continue;
      for (int s = a; s < b; ++s) {
        if (dist[static_cast<long long>(__ldg(cols + s)) * sv + q] == lv) {
          row[q] = lv + 1;
          s_found[q] = 1;
          break;
        }
      }
    }
  }
  __syncthreads();
  for (int q = threadIdx.x; q < K; q += blockDim.x) {
    if (s_found[q]) found[q] = 1;
  }
  finish_level(level, updated, stop, found, ctrl, K);
}

// Blocks of a level: enough to stream the card, few enough that the
// ticket tail stays cheap.
constexpr long long kLevelBlocks = 2048;

}  // namespace

// dist[q, v] is at q * sq + v * sv: sv == 1 takes the row layout, else the
// query-minor one (sq == 1, K <= 4096: 8K bytes of shared memory a block).
extern "C" int msbfs_csr_pull(int device, const void* offsets, const void* cols,
                              void* dist, long long n, int K, long long sq,
                              long long sv, void* level, void* updated,
                              const void* stop, void* found, void* ctrl,
                              void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool minor = sv != 1;
  if (n < 0 || n >= (1LL << 31) || K < 1 || K > 65535 ||
      (minor && (sq != 1 || K > 4096))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* o = static_cast<const int*>(offsets);
  const int* c = static_cast<const int*>(cols);
  int* d = static_cast<int*>(dist);
  int* lv = static_cast<int*>(level);
  int* up = static_cast<int*>(updated);
  const int* st = static_cast<const int*>(stop);
  int* fd = static_cast<int*>(found);
  int* ct = static_cast<int*>(ctrl);
  if (minor) {
    const long long warps = msbfs::kThreads / 32;
    long long blocks = (n + warps - 1) / warps;
    blocks = blocks < 1 ? 1 : blocks > kLevelBlocks ? kLevelBlocks : blocks;
    csr_pull_minor<<<static_cast<int>(blocks), msbfs::kThreads,
                     2 * K * sizeof(int), s>>>(o, c, d, n, sv, lv, up, st, fd, ct, K);
  } else {
    long long bx = (n + msbfs::kThreads - 1) / msbfs::kThreads;
    const long long most = kLevelBlocks / K > 1 ? kLevelBlocks / K : 1;
    bx = bx < 1 ? 1 : bx > most ? most : bx;
    csr_pull_rows<<<dim3(static_cast<unsigned>(bx), K), msbfs::kThreads, 0, s>>>(
        o, c, d, n, sq, lv, up, st, fd, ct, K);
  }
  return static_cast<int>(cudaGetLastError());
}

// Kernel K8 — one level of the ELL route for all K queries, with its consumer.
//
// Replaces the TPU kernel ops/pallas_bfs.py:44 _ell_hits_kernel (its
// pallas_call at :72, entered through ell_hits :52) together with its
// consumer ops/pallas_bfs.py:86 ell_expand and the level update of the
// vmapped distance loop (ops/bfs.py:173 distance_chunk), all in the JAX
// package.  For distances dist (K, n) int32 and the ELL slab (cols (width,
// R), sorted vrow_vertex (R,), sentinel n in both):
//
//   frontier_q   = dist[q] == level[q]                 (queries that may run)
//   hits[r]      = OR over j of frontier[cols[j, r]]   (sentinel n reads 0)
//   reached[v]   = OR over the virtual rows r of v     (sentinel owner dropped)
//   new          = dist == -1 & reached;  dist = level + 1 where new
//   updated[q]   = any(new[q]);  level[q] += 1         (running queries only)
//
// A query "may run" while updated[q] and level[q] < stop[q]: stop is the
// chunk's per-query level bound (ops/bfs.py arm_chunk), so a converged
// query's row is a fixed point and the host can enqueue a whole chunk.
// ctrl[0] = some query may run; every launch returns at once when it is 0,
// and the last launch of a level recomputes it.
//
// The TPU kernel kept one query's whole int8 frontier in VMEM and streamed
// (width, 512) cols tiles past it; Mosaic could not lower its gather, so it
// only ever ran in interpret mode.  Here the K per-query frontiers are
// packed first into one (n, W) bit plane, W = ceil(K / 32) words per
// vertex (query 32w+b in bit b of word w): 8 MB at n = 2^20, K = 64, small
// enough to stay in the 50 MB L2 while the gather reads it at random,
// against 64 MB for K int8 frontiers.  Each virtual row then reads its
// cols once for all K queries (column-major: neighbouring threads read
// neighbouring addresses for a fixed slot) and ORs whole words.
//
// Bound: bytes.  A level must read the distances of all K queries (4Kn
// bytes, 268 MB at n = 2^20, K = 64), write those that change, and read
// cols and vrow_vertex once (4(width + 1)R bytes, 163 MB at RMAT-20).  The
// design reads dist twice (once to pack the frontier, once in the apply):
// keeping the frontier as bits instead of rereading dist in the gather is
// what keeps the random reads in L2.  Four launches per level:
//   1. pack:   one thread per (vertex, word), vertex fastest, so the 32
//              dist reads of a word are each coalesced across the warp;
//              also zeroes the hit plane;
//   2. gather: one thread per virtual row, ORing up to 8 words per pass
//              over its slots, then atomicOr of the nonzero words into
//              the owner's hit row (only a vertex's consecutive virtual
//              rows collide, and every writer only sets bits);
//   3. apply:  one block row per query (blockIdx.y), threads over
//              vertices; a block that labelled a vertex sets found[q];
//   4. advance: one block folds found into updated/level and rewrites
//              ctrl[0].
#include "msbfs_common.cuh"

namespace {

constexpr int kWordsPerPass = 8;

__device__ __forceinline__ bool may_run(const int* updated, const int* level,
                                        const int* stop, int q) {
  return __ldcg(updated + q) != 0 && __ldcg(level + q) < __ldcg(stop + q);
}

__global__ void __launch_bounds__(msbfs::kThreads)
ell_pack_kernel(const int* __restrict__ dist, const int* __restrict__ level,
                const int* __restrict__ updated, const int* __restrict__ stop,
                uint32_t* __restrict__ frontier, uint32_t* __restrict__ hits,
                long long n, int K, int W, const int* __restrict__ ctrl) {
  if (__ldcg(ctrl) == 0) return;
  extern __shared__ int s_level[];  // level of a running query, else -2
  for (int q = threadIdx.x; q < K; q += blockDim.x) {
    s_level[q] = may_run(updated, level, stop, q) ? __ldcg(level + q) : -2;
  }
  __syncthreads();
  const long long total = n * W;
  for (long long t = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       t < total; t += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int w = static_cast<int>(t / n);
    const long long v = t - static_cast<long long>(w) * n;
    const int q0 = w * 32;
    const int nb = min(32, K - q0);
    uint32_t word = 0u;
    for (int b = 0; b < nb; ++b) {
      const int q = q0 + b;
      if (__ldg(dist + static_cast<long long>(q) * n + v) == s_level[q]) {
        word |= 1u << b;
      }
    }
    frontier[v * W + w] = word;
    hits[v * W + w] = 0u;
  }
}

__global__ void __launch_bounds__(msbfs::kThreads)
ell_gather_kernel(const int* __restrict__ cols,
                  const int* __restrict__ vrow_vertex,
                  const uint32_t* __restrict__ frontier,
                  uint32_t* __restrict__ hits, long long n, long long R,
                  int width, int W, const int* __restrict__ ctrl) {
  if (__ldcg(ctrl) == 0) return;
  for (long long r = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       r < R; r += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long u = __ldg(vrow_vertex + r);
    if (u >= n) continue;  // padding row: sentinel owner, dropped
    for (int w0 = 0; w0 < W; w0 += kWordsPerPass) {
      const int nw = min(kWordsPerPass, W - w0);
      uint32_t acc[kWordsPerPass];
#pragma unroll
      for (int i = 0; i < kWordsPerPass; ++i) acc[i] = 0u;
      for (int j = 0; j < width; ++j) {
        const long long c = __ldg(cols + j * R + r);
        if (c >= n) continue;  // sentinel slot reads 0
        const uint32_t* row = frontier + c * W + w0;
#pragma unroll
        for (int i = 0; i < kWordsPerPass; ++i) {
          if (i < nw) acc[i] |= __ldg(row + i);
        }
      }
#pragma unroll
      for (int i = 0; i < kWordsPerPass; ++i) {
        if (i < nw && acc[i]) atomicOr(hits + u * W + w0 + i, acc[i]);
      }
    }
  }
}

__global__ void __launch_bounds__(msbfs::kThreads)
ell_apply_kernel(int* __restrict__ dist, const int* __restrict__ level,
                 const int* __restrict__ updated, const int* __restrict__ stop,
                 const uint32_t* __restrict__ hits, int* __restrict__ found,
                 long long n, int W, const int* __restrict__ ctrl) {
  if (__ldcg(ctrl) == 0) return;
  const int q = blockIdx.y;
  // Uniform across the block: the __syncthreads_or below sees every thread.
  if (!may_run(updated, level, stop, q)) return;
  const int next = __ldcg(level + q) + 1;
  const int w = q >> 5;
  const uint32_t bit = 1u << (q & 31);
  int* const row = dist + static_cast<long long>(q) * n;
  int mine = 0;
  for (long long v = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       v < n; v += static_cast<long long>(gridDim.x) * blockDim.x) {
    if ((__ldcg(hits + v * W + w) & bit) && row[v] == -1) {
      row[v] = next;
      mine = 1;
    }
  }
  if (__syncthreads_or(mine) && threadIdx.x == 0) found[q] = 1;
}

__global__ void __launch_bounds__(msbfs::kThreads)
ell_advance_kernel(int* __restrict__ level, int* __restrict__ updated,
                   const int* __restrict__ stop, int* __restrict__ found,
                   int K, int* __restrict__ ctrl) {
  if (__ldcg(ctrl) == 0) return;
  int go = 0;
  for (int q = threadIdx.x; q < K; q += blockDim.x) {
    int up = __ldcg(updated + q);
    int lv = __ldcg(level + q);
    const int st = __ldcg(stop + q);
    if (up != 0 && lv < st) {
      up = __ldcg(found + q);
      lv += 1;
      found[q] = 0;
      updated[q] = up;
      level[q] = lv;
    }
    go |= up != 0 && lv < st;
  }
  go = __syncthreads_or(go);
  if (threadIdx.x == 0) ctrl[0] = go;
}

}  // namespace

extern "C" int msbfs_ell_hits(int device, const void* cols,
                              const void* vrow_vertex, void* dist, void* level,
                              void* updated, const void* stop, void* found,
                              void* frontier, void* hits, long long n,
                              long long R, int width, int K, int W, void* ctrl,
                              void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  // K is bounded by the pack kernel's shared per-query levels (32 KB).
  if (K < 1 || W != (K + 31) / 32 || width < 1 || n < 0 || R < 0 ||
      K > 8192) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* const c = static_cast<int*>(ctrl);
  const int* const lv = static_cast<const int*>(level);
  const int* const up = static_cast<const int*>(updated);
  const int* const st = static_cast<const int*>(stop);
  uint32_t* const fr = static_cast<uint32_t*>(frontier);
  uint32_t* const h = static_cast<uint32_t*>(hits);

  ell_pack_kernel<<<msbfs::grid_for(n * W, msbfs::kThreads), msbfs::kThreads,
                    K * sizeof(int), s>>>(static_cast<const int*>(dist), lv,
                                          up, st, fr, h, n, K, W, c);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ell_gather_kernel<<<msbfs::grid_for(R, msbfs::kThreads), msbfs::kThreads, 0,
                      s>>>(static_cast<const int*>(cols),
                           static_cast<const int*>(vrow_vertex), fr, h, n, R,
                           width, W, c);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // About 4096 blocks in all, whatever K: each block strides over n / x
  // vertices of its query.
  long long x = (n + msbfs::kThreads - 1) / msbfs::kThreads;
  const long long cap = 4096 / K > 0 ? 4096 / K : 1;
  if (x > cap) x = cap;
  if (x < 1) x = 1;
  ell_apply_kernel<<<dim3(static_cast<unsigned>(x), static_cast<unsigned>(K)),
                     msbfs::kThreads, 0, s>>>(
      static_cast<int*>(dist), lv, up, st, h, static_cast<int*>(found), n, W,
      c);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ell_advance_kernel<<<1, msbfs::kThreads, 0, s>>>(
      static_cast<int*>(level), static_cast<int*>(updated), st,
      static_cast<int*>(found), K, c);
  return static_cast<int>(cudaGetLastError());
}

// The push's edge walk, shared by the bit-plane push (push_or.cu, K3) and
// the byte expansion's first launch (flag_pull.cu, K5's push).
//
// For a (rows, W) frontier plane, the dedup CSR (start, vals) and the
// worklist the level apply (or the batch start) left (msbfs_common.cuh):
//
//   for every row u of the worklist and every dedup neighbour v of u:
//     hits[v] |= frontier[u]
//
// The edge space [0, T) of the listed rows is cut into equal shares of
// whole 32-edge steps, one per warp of the walk's blocks, so a hub row's
// edges spread over as many warps as its degree needs and a run of thin
// rows shares a warp.  A warp finds the entry holding its first edge by a
// 32-way search of the prefix column (one ballot a step), then each step
// loads the 32 entries from the entry of its first edge — row, prefix,
// CSR start and the row's words in one 4-, 8- or 16-byte load per lane —
// and each lane finds its edge's entry among them by a 5-step shuffle
// search (every entry holds an edge, so 32 entries cover 32 edges), reads
// the neighbour and ORs the row's nonzero words into it.
#pragma once

#include <climits>

#include "msbfs_common.cuh"

namespace msbfs {

// Block size of a push walk, and most blocks it takes per SM: enough warps
// for a push level at the edge budget, and few blocks, since a launch
// costs more the more blocks it has (an empty one 6.0 us at 264 blocks of
// 256 threads, 8.8 us at 1,056, on an H100; wider blocks were no faster).
constexpr int kPushThreads = 256;
constexpr int kPushBlocksPerSm = 2;

// The walk's blocks for a level of at most ``edge_cap`` edges.
inline cudaError_t push_blocks(int device, long long edge_cap, int* out) {
  int sms = 0;
  const cudaError_t err = sm_count(device, &sms);
  if (err != cudaSuccess) return err;
  long long grid = (edge_cap + kPushThreads - 1) / kPushThreads;
  const long long most = static_cast<long long>(kPushBlocksPerSm) * sms;
  grid = grid < 1 ? 1 : grid > most ? most : grid;
  *out = static_cast<int>(grid);
  return cudaSuccess;
}

namespace push {

constexpr unsigned kFull = 0xffffffffu;

// Warp-wide: the largest i in [0, len) with offs[i] <= e (offs is
// nondecreasing and offs[0] = 0 <= e).
__device__ __forceinline__ int find_entry(const int* __restrict__ offs,
                                          int len, int e, int lane) {
  int lo = 0, hi = len;  // offs[lo] <= e, the answer is below hi
  while (hi - lo > 32) {
    const long long span = hi - lo;
    const int p = lo + static_cast<int>(span * lane / 32);
    const unsigned m = __ballot_sync(kFull, __ldg(offs + p) <= e);
    const int k = 31 - __clz(m);
    hi = k == 31 ? hi : lo + static_cast<int>(span * (k + 1) / 32);
    lo += static_cast<int>(span * k / 32);
  }
  const int i = lo + lane;
  const unsigned m = __ballot_sync(kFull, i < hi && __ldg(offs + i) <= e);
  return lo + 31 - __clz(m);
}

// A row's W words (W in 1, 2, 4, 8; the base 16-byte aligned for W > 1).
template <int W>
struct RowWords {
  uint32_t x[W];

  __device__ __forceinline__ void load(const uint32_t* __restrict__ frontier,
                                       int r) {
    const uint32_t* p = frontier + static_cast<size_t>(r) * W;
    if constexpr (W == 1) {
      x[0] = __ldg(p);
    } else if constexpr (W == 2) {
      const uint2 a = __ldg(reinterpret_cast<const uint2*>(p));
      x[0] = a.x; x[1] = a.y;
    } else {
#pragma unroll
      for (int k = 0; k < W / 4; ++k) {
        const uint4 a = __ldg(reinterpret_cast<const uint4*>(p) + k);
        x[4 * k] = a.x; x[4 * k + 1] = a.y; x[4 * k + 2] = a.z; x[4 * k + 3] = a.w;
      }
    }
  }
};

}  // namespace push

// The walk of one block, ``block`` of ``blocks`` (kPushThreads threads
// each).  W in 1, 2, 4, 8: each lane loads its entry's words, and a lane
// takes the words of its edge's entry by shuffles.  W = 0: any width
// w_any, the words read per edge (lanes of one row read the same
// addresses).  The caller has checked the level's gate.
template <int W>
__device__ __forceinline__ void push_walk(
    const uint32_t* __restrict__ frontier, const int* __restrict__ start,
    const int* __restrict__ vals, uint32_t* __restrict__ hits, int w_any,
    const int* __restrict__ wl_rows, const int* __restrict__ wl_offs,
    const long long* __restrict__ state, int blocks, int block) {
  using push::kFull;
  const int len = static_cast<int>(__ldcg(state + kListed));
  const long long total = __ldcg(state + kListedEdges);
  const int lane = threadIdx.x & 31;
  const long long warps = static_cast<long long>(blocks) * (blockDim.x >> 5);
  const long long warp =
      static_cast<long long>(block) * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const long long share = ((total + warps - 1) / warps + 31) / 32 * 32;
  const long long a = warp * share;
  if (len == 0 || a >= total) return;  // warp-uniform
  const int b = static_cast<int>(a + share < total ? a + share : total);
  int i0 = push::find_entry(wl_offs, len, static_cast<int>(a), lane);
  for (int e0 = static_cast<int>(a); e0 < b; e0 += 32) {
    const int i = i0 + lane;
    const bool listed = i < len;
    const int o = listed ? __ldg(wl_offs + i) : INT_MAX;
    const int r = listed ? __ldg(wl_rows + i) : 0;
    const int s = listed ? __ldg(start + r) : 0;
    push::RowWords<W == 0 ? 1 : W> words{};
    if constexpr (W != 0) {
      if (listed) words.load(frontier, r);
    }
    // The entry of edge e: the last of the 32 whose prefix is <= e.
    const int e = e0 + lane;
    int j = 0;
#pragma unroll
    for (int step = 16; step > 0; step >>= 1) {
      if (__shfl_sync(kFull, o, j + step) <= e) j += step;
    }
    const int first = __shfl_sync(kFull, s, j) - __shfl_sync(kFull, o, j);
    if constexpr (W != 0) {
      uint32_t x[W];
#pragma unroll
      for (int w = 0; w < W; ++w) x[w] = __shfl_sync(kFull, words.x[w], j);
      if (e < b) {
        const size_t v = static_cast<size_t>(__ldg(vals + first + e)) * W;
#pragma unroll
        for (int w = 0; w < W; ++w) {
          if (x[w]) atomicOr(hits + v + w, x[w]);
        }
      }
    } else {
      const int u = __shfl_sync(kFull, r, j);
      if (e < b) {
        const size_t v = static_cast<size_t>(__ldg(vals + first + e)) * w_any;
        const uint32_t* p = frontier + static_cast<size_t>(u) * w_any;
        for (int w = 0; w < w_any; ++w) {
          const uint32_t x = __ldg(p + w);
          if (x) atomicOr(hits + v + w, x);
        }
      }
    }
    // The next step's 32 entries start at the entry of edge e0 + 32: the
    // last of these 32 whose prefix is <= e0 + 32, or the one after them
    // when they end exactly there.  (Starting at lane 31's entry instead
    // leaves the step one entry short when that entry ends at e0 + 31 and
    // the next 32 hold one edge each.)
    const long long next = static_cast<long long>(e0) + 32;
    int k = 31 - __clz(__ballot_sync(kFull, o <= next));
    if (k == 31 && i0 + 32 < len && __ldg(wl_offs + i0 + 32) <= next) k = 32;
    i0 += k;
  }
}

}  // namespace msbfs

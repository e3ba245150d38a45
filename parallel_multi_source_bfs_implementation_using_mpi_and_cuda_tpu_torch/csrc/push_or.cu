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
// kDirPush), so a pull level costs one empty launch.  The edge space is
// cut into equal shares of whole 32-edge steps, one per warp, so a hub
// row's edges spread over as many warps as its degree needs and a run of
// thin rows shares a warp.  A warp finds the entry holding its first edge
// by a 32-way search of the prefix column (one ballot a step), then each
// step loads the 32 entries from the entry of its first edge — row,
// prefix, CSR start and the row's words in one 4-, 8- or 16-byte load per
// lane — and each lane finds its edge's entry among them by a 5-step
// shuffle search (every entry holds an edge, so 32 entries cover 32
// edges), reads the neighbour and ORs the row's nonzero words into it.
#include "msbfs_common.cuh"

#include <climits>

namespace {

constexpr unsigned kFull = 0xffffffffu;
// Block size, and most blocks a launch has per SM: enough warps for a
// push level at the edge budget, and few blocks, since a launch costs more
// the more blocks it has (an empty one 6.0 us at 264 blocks of 256
// threads, 8.8 us at 1,056, on an H100; wider blocks were no faster).
constexpr int kPushThreads = 256;
constexpr int kPushBlocksPerSm = 2;

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

// W in 1, 2, 4, 8: each lane loads its entry's words, and a lane takes the
// words of its edge's entry by shuffles.  W = 0: any width w_any, the
// words read per edge (lanes of one row read the same addresses).
template <int W>
__global__ void __launch_bounds__(kPushThreads)
push_or_kernel(const uint32_t* __restrict__ frontier,
               const int* __restrict__ start, const int* __restrict__ vals,
               uint32_t* __restrict__ hits, int w_any,
               const int* __restrict__ wl_rows,
               const int* __restrict__ wl_offs,
               const long long* __restrict__ state,
               const int* __restrict__ ctrl, int max_levels) {
  if (!msbfs::direction_go(ctrl, max_levels, msbfs::kDirPush)) return;
  const int len = static_cast<int>(__ldcg(state + msbfs::kListed));
  const long long total = __ldcg(state + msbfs::kListedEdges);
  const int lane = threadIdx.x & 31;
  const long long warps = static_cast<long long>(gridDim.x) * (blockDim.x >> 5);
  const long long warp = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const long long share = ((total + warps - 1) / warps + 31) / 32 * 32;
  const long long a = warp * share;
  if (len == 0 || a >= total) return;  // warp-uniform
  const int b = static_cast<int>(a + share < total ? a + share : total);
  int i0 = find_entry(wl_offs, len, static_cast<int>(a), lane);
  for (int e0 = static_cast<int>(a); e0 < b; e0 += 32) {
    const int i = i0 + lane;
    const bool listed = i < len;
    const int o = listed ? __ldg(wl_offs + i) : INT_MAX;
    const int r = listed ? __ldg(wl_rows + i) : 0;
    const int s = listed ? __ldg(start + r) : 0;
    RowWords<W == 0 ? 1 : W> words{};
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
  int sms = 0;
  err = msbfs::sm_count(device, &sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  long long grid = (edge_cap + kPushThreads - 1) / kPushThreads;
  const long long most = static_cast<long long>(kPushBlocksPerSm) * sms;
  grid = grid < 1 ? 1 : grid > most ? most : grid;
  auto args = [&](auto kernel) {
    kernel<<<static_cast<int>(grid), kPushThreads, 0, s>>>(
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

// Kernel K1 — the BELL reduction forest over bit planes (the pull direction).
//
// Replaces the XLA chain of the JAX package's ops/bell.py:75 forest_hits as
// ops/bitbell.py:131 bell_hits_or runs it (a take of every padded slot's
// frontier row, then an OR-fold over each bucket's width, per forest level,
// then a take by final_slot).  For a (n, W) frontier plane (query 32w+b in
// bit b of word w) and the forest's buckets (R_b rows of W_b slots each):
//
//   level 0:   out[row_base_b + r, w] = OR_{j < W_b} frontier[cols[off_b + r*W_b + j], w]
//   level l:   the same over level l-1's output rows instead of the frontier
//   hits[v, w] = v_cat[final_slot[v], w]
//
// A slot index equal to the previous value array's row count is the zero
// sentinel (index n at level 0); final_slot == total_rows names the zero
// row of the scratch, so an isolated vertex reads 0.
//
// All level outputs live in one (total_rows + 1, W) scratch whose last row
// is zero (the wrapper allocates it; no launch writes that row), so JAX's
// per-level concatenations cost nothing and the final gather is a plain
// indexed read.  XLA materialised the (slots, W) gather before folding
// it; here each slot's words are ORed into registers as they are read, so
// the gather never exists and the wrapper's slot budget has nothing to
// bound.
//
// Bound: bytes.  A level must read its cols once (4 bytes per padded slot:
// 35M slots at RMAT-20 level 0), the frontier or previous output plane,
// and write its output rows; the final gather reads final_slot and writes
// the hit plane.  The frontier reads are random (8 MB at n = 2^20, W = 2:
// it stays in the 50 MB L2), one 32-byte L2 sector per slot at W <= 8, so
// at RMAT-20 they, and not device memory, set the floor: about 1 GB of
// sectors a level.
//
// Design: a warp walks a run of consecutive slots of one bucket, aligned to
// its rows, from a small host-built bucket table (slot offset, rows, width,
// first output row, first run, rows per 32-slot chunk; at most kMaxBuckets
// a level) that each block keeps in shared memory and searches once per
// warp and run:
//   - narrow buckets (W_b <= 32): a chunk is 32 / W_b whole rows, lane l
//     on slot l of the chunk, so one warp load of cols is 128 consecutive
//     bytes; a run is S chunks (S = 4, or 2 at 8 words a row), all their
//     cols loads, then all their frontier rows (each one vector load:
//     uint2 at W = 2, two uint4 at W = 8), in flight together; the lanes of
//     a row are ORed by a segmented shuffle toward the row's first lane,
//     which writes the row;
//   - wide buckets (W_b > 32, the hub chunk rows up to 256, and the second
//     forest level): a warp per row, lanes striding over the slots S at a
//     time, an xor-shuffle OR, lane 0 writes the row.
// The cols and frontier reads go through L2 only (__ldcg): neither is
// reused from L1.  Every slot reads its source row, zero or not: pull
// levels are the dense ones (the push takes the thin), and on them a
// one-bit-per-vertex map of the nonzero rows, looked up before each slot,
// cost more in divergent L1 lookups than the sectors it saved (PERF.md).
// Every launch is gated on the device control: it returns at once unless
// the level may run and ctrl[3] is the pull direction.
//
// K1's segment form (msbfs_forest_map, msbfs_forest_segment,
// msbfs_forest_gather) replaces the XLA chain of the host-streamed engine,
// the JAX package's ops/streamed.py:117 _segment_fold / :139 _segment_or /
// :146 _final_hits: there the forest never enters device memory, and each
// BFS level streams its cols through a small ring of device buffers, one
// slot segment (a run of whole bucket rows, at most the slot budget) at a
// time.  msbfs_forest_segment runs the level kernel over one segment (the
// cols of the buffer just uploaded, a per-segment bucket table with
// offsets relative to the segment and output rows relative to its first
// row, the segment's first output row in the scratch), and
// msbfs_forest_gather is the final take by final_slot as its own launch.
//
// The streamed engine has no push: every BFS level is a forest pull, the
// thinnest included (its first level's frontier is only the sources).  So
// the segment form does not keep K1's rule that every slot reads its
// source row.  Bound: bytes — the segment's cols (4 bytes a slot), the
// 32-byte sectors of the slots whose source row is nonzero (each such row
// read once at the least), the frontier map, and the output rows written;
// on a thin level the cols alone.  The instances, picked on the host by
// ops/cuda_bell.py segment_plan (a pure function of n, the forest level
// and the alignment; never after a failure):
//   - ``map`` (forest level 0, n up to 1,802,240): msbfs_forest_map, one
//     launch a BFS level for all of level 0's segments, writes the union
//     frontier as a bitmap (bit b: some word of a frontier row v with
//     v >> shift == b is nonzero) and sums on the device the nonzero rows
//     and their weight, the level-0 slots that name them (a per-vertex
//     count the engine builds once).  Each block of a segment launch copies
//     the map into shared memory; a slot whose bit is 0 costs a
//     shared-memory lookup and no L2 sector, and a 32-slot chunk that
//     reads no source row skips its shuffles and writes zero rows.  A set
//     bit only means "read the row", so a bit may cover two vertices
//     (shift 1) and stay exact.  The host takes the finest resolution at
//     which two blocks fit an SM (228 KB): at n = 2^20 a bit per two
//     vertices, 64 KB, so two 1024-thread blocks an SM hold the occupancy
//     of ``nomap`` (one 128 KB block an SM, as flag_pull.cu's map takes,
//     held 32 warps an SM: its dense walk ran 2-8 % behind ``nomap``).
//     The grid is persistent (one block a resident slot, each walking
//     many runs): the copy is paid once a block, not once a run.
//   - ``gmap`` (forest level 0, n above that): the same walk with the map
//     read from device memory through L2.  At n = 2^25 it is 4 MB and
//     stays in L2, where the frontier plane (268 MB at W = 2) cannot.
//   - ``nomap``: K1's body, every slot reads its row.  The instance for
//     forest levels >= 1, whose previous rows are the level-0 output,
//     already in L2.
// Dense frontiers stay as fast as without the map: every map launch reads
// the pre-pass's weight first and, above the host's ``dense_slots`` (a
// share of all level-0 slots, measured: PERF.md), reads every slot's row
// without the map and without copying it (a block-uniform branch; no host
// read).  The weight, not the count of rows, decides: on RMAT-20 a level
// with 59 % of its rows nonzero names them from 99.9 % of the slots, the
// next level with 61 % from 60 %.
// The gather: a warp takes four runs of 32 consecutive vertices, a lane
// one vertex of each, so the slot loads and the row stores coalesce and
// rows that neighbouring vertices share a sector with are read once a
// load instruction; all four row loads are in flight before the first
// store; a vertex whose slot is the zero row (an isolated vertex) is
// written 0 without reading it.  Bound: final_slot read and hits written
// once, plus the gathered rows; its random row sectors run at L2's rate.
#include "msbfs_common.cuh"

namespace {

constexpr int kMaxBuckets = 64;
constexpr int kTab = 6;   // off, rows, width, row_base, first run, rows per chunk
constexpr int kMeta = 6;  // cols ptr, prev rows, out row offset, bucket
                          // begin, bucket count, runs
constexpr unsigned kFull = 0xffffffffu;
constexpr int kPass = 8;  // words a pass of the generic width

// The frontier map a level launch reads: none, staged in shared memory,
// or read from device memory (msbfs_forest_segment's ``map``).
constexpr int kNoMap = 0;
constexpr int kSharedMap = 1;
constexpr int kGlobalMap = 2;
// The map pre-pass's device counters (64-bit): its running sums and
// finished blocks (zero between launches), and what it published: the
// frontier's nonzero rows and their weight (the level-0 slots naming them).
constexpr int kAccRows = 0;
constexpr int kAccSlots = 1;
constexpr int kDone = 2;
constexpr int kRows = 3;
constexpr int kSlots = 4;
// Map words a warp of the pre-pass reads at once, and its blocks an SM.
constexpr int kMapUnroll = 8;
constexpr int kPrepassBlocksPerSm = 4;
// Vertices a thread of the final gather takes (a warp: 32 consecutive
// vertices each time).
constexpr int kGatherVertices = 4;

// Chunks of 32 slots a warp has in flight, for rows read ``words`` words
// at a time: fewer at 8.
__host__ __device__ constexpr int run_chunks(int words) { return words >= 8 ? 2 : 4; }

// Threads a block of a level launch, and its blocks an SM: the
// shared-map instance holds kMapBlocksPerSm blocks an SM (the host sizes
// the map to fit them), so its blocks are large: at one or two words a row
// two 1024-thread blocks, 32 registers a thread, the occupancy of kNoMap.
constexpr int kMapBlocksPerSm = 2;
__host__ __device__ constexpr int level_threads(int w, int map) {
  return map != kSharedMap ? msbfs::kThreads : (w == 1 || w == 2 ? 1024 : 512);
}
__host__ __device__ constexpr int level_blocks(int map) {
  return map == kSharedMap ? kMapBlocksPerSm : 1;
}

// P words at p through L2 only: one vector load where the row is 8 or 16
// bytes wide and the plane 16-byte aligned.
template <int P, bool kVec>
__device__ __forceinline__ void ldcg_words(uint32_t (&out)[P],
                                           const uint32_t* p) {
  if constexpr (kVec && P % 4 == 0) {
#pragma unroll
    for (int i = 0; i < P; i += 4) {
      const uint4 x = __ldcg(reinterpret_cast<const uint4*>(p + i));
      out[i] = x.x; out[i + 1] = x.y; out[i + 2] = x.z; out[i + 3] = x.w;
    }
  } else if constexpr (kVec && P == 2) {
    const uint2 x = __ldcg(reinterpret_cast<const uint2*>(p));
    out[0] = x.x; out[1] = x.y;
  } else {
#pragma unroll
    for (int i = 0; i < P; ++i) out[i] = __ldcg(p + i);
  }
}

template <int P, bool kVec>
__device__ __forceinline__ void store_words(uint32_t* p,
                                            const uint32_t (&in)[P]) {
  if constexpr (kVec && P % 4 == 0) {
#pragma unroll
    for (int i = 0; i < P; i += 4) {
      *reinterpret_cast<uint4*>(p + i) =
          make_uint4(in[i], in[i + 1], in[i + 2], in[i + 3]);
    }
  } else if constexpr (kVec && P == 2) {
    *reinterpret_cast<uint2*>(p) = make_uint2(in[0], in[1]);
  } else {
#pragma unroll
    for (int i = 0; i < P; ++i) p[i] = in[i];
  }
}

// Words [w0, w0 + nw) of row c (Wd words a row) into x: the whole row as
// vectors at a template width (w0 == 0, nw == W), else nw <= P scalars.
template <int W, bool kVec, int P>
__device__ __forceinline__ void load_row(uint32_t (&x)[P],
                                         const uint32_t* __restrict__ prev,
                                         int c, int Wd, int w0, int nw) {
  if constexpr (W != 0) {
    ldcg_words<W, kVec>(x, prev + static_cast<long long>(c) * W);
  } else {
    const uint32_t* row = prev + static_cast<long long>(c) * Wd + w0;
#pragma unroll
    for (int i = 0; i < P; ++i) x[i] = i < nw ? __ldcg(row + i) : 0u;
  }
}

template <int W, bool kVec, int P>
__device__ __forceinline__ void store_row(uint32_t* __restrict__ out,
                                          long long row, const uint32_t (&x)[P],
                                          int Wd, int w0, int nw) {
  if constexpr (W != 0) {
    store_words<W, kVec>(out + row * W, x);
  } else {
    uint32_t* p = out + row * Wd + w0;
#pragma unroll
    for (int i = 0; i < P; ++i) {
      if (i < nw) p[i] = x[i];
    }
  }
}

// The frontier map: bit b of word b / 32 is set iff some word of a
// frontier row v with v >> kShift == b is nonzero (bits past n are 0), a
// warp kMapUnroll map words at a time; and two sums, the nonzero rows and
// their weights (weights[v]: the level-0 slots naming v).  The last block
// to finish publishes both and clears the running sums for the next
// launch.
template <int W, bool kVec, int kShift>
__global__ void __launch_bounds__(msbfs::kThreads)
forest_map_kernel(const uint32_t* __restrict__ frontier, long long n, int w_rt,
                  uint32_t* __restrict__ fmap, long long map_words,
                  const int* __restrict__ weights,
                  unsigned long long* __restrict__ counts,
                  const int* __restrict__ ctrl, int max_levels) {
  if (!msbfs::direction_go(ctrl, max_levels, msbfs::kDirPull)) return;
  __shared__ unsigned long long s_sum[2];
  if (threadIdx.x < 2) s_sum[threadIdx.x] = 0;
  __syncthreads();
  constexpr int P = W ? W : kPass;
  constexpr int U = kMapUnroll;
  constexpr int R = 1 << kShift;  // rows a bit
  const int Wd = W ? W : w_rt;
  const int lane = threadIdx.x & 31;
  const long long warps = static_cast<long long>(gridDim.x) * (blockDim.x >> 5);
  unsigned long long rows = 0, slots = 0;
  for (long long u0 = (blockIdx.x * static_cast<long long>(blockDim.x >> 5) + (threadIdx.x >> 5)) * U;
       u0 < map_words; u0 += warps * U) {
    bool on[U][R];
    int weight[U][R];
#pragma unroll
    for (int k = 0; k < U; ++k) {
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const long long v = (((u0 + k) * 32 + lane) << kShift) + j;
        on[k][j] = false;
        weight[k][j] = 0;
        if (v < n) {
          weight[k][j] = __ldg(weights + v);
          for (int w0 = 0; w0 < Wd && !on[k][j]; w0 += P) {
            uint32_t x[P];
            load_row<W, kVec, P>(x, frontier, static_cast<int>(v), Wd, w0, min(P, Wd - w0));
#pragma unroll
            for (int i = 0; i < P; ++i) on[k][j] |= x[i] != 0u;
          }
        }
      }
    }
#pragma unroll
    for (int k = 0; k < U; ++k) {
      bool any = false;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        any |= on[k][j];
        if (on[k][j]) {
          rows += 1;
          slots += weight[k][j];
        }
      }
      const unsigned word = __ballot_sync(kFull, any);
      if (lane == 0 && u0 + k < map_words) fmap[u0 + k] = word;
    }
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    rows += __shfl_xor_sync(kFull, rows, d);
    slots += __shfl_xor_sync(kFull, slots, d);
  }
  if (lane == 0 && (rows | slots)) {
    atomicAdd(s_sum, rows);
    atomicAdd(s_sum + 1, slots);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    if (s_sum[0]) atomicAdd(counts + kAccRows, s_sum[0]);
    if (s_sum[1]) atomicAdd(counts + kAccSlots, s_sum[1]);
    __threadfence();
    if (atomicAdd(counts + kDone, 1ull) == gridDim.x - 1ull) {
      counts[kRows] = atomicExch(counts + kAccRows, 0ull);
      counts[kSlots] = atomicExch(counts + kAccSlots, 0ull);
      counts[kDone] = 0;
    }
  }
}

// One forest level: runs of the buckets in table[0 .. nb), runs in all.
// kMap != kNoMap (forest level 0 of the segment form): while the map
// launch's weight of nonzero rows (the slots naming them) is at most
// dense_slots, a slot whose map bit is 0 reads no row, and a chunk that
// read none skips its shuffles; above it the walk reads every slot's row
// as kNoMap does (a block-uniform branch).  Bit b of the map covers the
// sources c with c >> shift == b.
template <int W, bool kVec, int kMap>
__global__ void __launch_bounds__(level_threads(W, kMap), level_blocks(kMap))
forest_level_kernel(const uint32_t* __restrict__ prev, int prev_rows,
                    const int* __restrict__ cols,
                    const long long* __restrict__ table, int nb,
                    uint32_t* __restrict__ out, int w_rt, long long runs,
                    const uint32_t* __restrict__ fmap, int map_words, int shift,
                    const unsigned long long* __restrict__ counts,
                    long long dense_slots,
                    const int* __restrict__ ctrl, int max_levels) {
  if (!msbfs::direction_go(ctrl, max_levels, msbfs::kDirPull)) return;
  __shared__ long long s_tab[kMaxBuckets * kTab];
  extern __shared__ uint4 s_map4[];
  bool use_map = false;
  if constexpr (kMap != kNoMap) {
    use_map = static_cast<long long>(__ldcg(counts + kSlots)) <= dense_slots;
  }
  for (int i = threadIdx.x; i < nb * kTab; i += blockDim.x) s_tab[i] = table[i];
  if constexpr (kMap == kSharedMap) {
    if (use_map) {
      const uint4* src = reinterpret_cast<const uint4*>(fmap);
      for (int i = threadIdx.x; i < map_words / 4; i += blockDim.x) s_map4[i] = __ldcg(src + i);
    }
  }
  __syncthreads();
  const uint32_t* const s_map = reinterpret_cast<const uint32_t*>(s_map4);
  // A slot's source, or prev_rows (the zero row) where the map says the
  // source row is zero.
  auto source = [&](int c) {
    const int bit = c >> shift;
    if constexpr (kMap == kSharedMap) {
      if (c < prev_rows && !((s_map[bit >> 5] >> (bit & 31)) & 1u)) return prev_rows;
    } else if constexpr (kMap == kGlobalMap) {
      if (c < prev_rows && !((__ldg(fmap + (bit >> 5)) >> (bit & 31)) & 1u)) return prev_rows;
    }
    return c;
  };
  constexpr int P = W ? W : kPass;
  constexpr int S = run_chunks(P);
  constexpr int kWarps = level_threads(W, kMap) / 32;
  const int Wd = W ? W : w_rt;
  const int lane = threadIdx.x & 31;
  const long long warps = static_cast<long long>(gridDim.x) * kWarps;
  for (long long run = blockIdx.x * static_cast<long long>(kWarps) + (threadIdx.x >> 5);
       run < runs; run += warps) {
    // The last bucket whose first run is <= run (warp-uniform).
    int lo = 0, hi = nb - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (s_tab[mid * kTab + 4] <= run) lo = mid; else hi = mid - 1;
    }
    const long long* b = s_tab + lo * kTab;
    const long long rows = b[1];
    const int width = static_cast<int>(b[2]);
    const int rpc = static_cast<int>(b[5]);
    const long long local = run - b[4];
    uint32_t* const out_b = out + b[3] * Wd;  // the bucket's first output row
    if (rpc > 0) {
      // Narrow: S chunks of rpc rows from row0; lane l takes slot l of a
      // chunk (row lrow, position lpos), the lanes past rpc * width none.
      const int* const rc = cols + b[0];
      const int lrow = lane / width;
      const int lpos = lane - lrow * width;
      const bool in_chunk = lrow < rpc;
      const long long row0 = local * S * rpc;
      int c[S];
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const long long first = row0 + s * rpc;
        c[s] = in_chunk && first + lrow < rows
                   ? __ldcg(rc + first * width + lane) : prev_rows;
      }
      // Bit s: some lane of chunk s has a source row to read.
      uint32_t gathered = (1u << S) - 1;
      if constexpr (kMap != kNoMap) {
        if (use_map) {
          gathered = 0;
#pragma unroll
          for (int s = 0; s < S; ++s) {
            c[s] = source(c[s]);
            if (__any_sync(kFull, c[s] < prev_rows)) gathered |= 1u << s;
          }
        }
      }
      for (int w0 = 0; w0 < Wd; w0 += P) {
        const int nw = min(P, Wd - w0);
        uint32_t x[S][P];
#pragma unroll
        for (int s = 0; s < S; ++s) {
          if (c[s] < prev_rows) {
            load_row<W, kVec, P>(x[s], prev, c[s], Wd, w0, nw);
          } else {
#pragma unroll
            for (int i = 0; i < P; ++i) x[s][i] = 0u;
          }
        }
#pragma unroll
        for (int s = 0; s < S; ++s) {
          // Segmented OR toward each row's first lane: after the step of
          // distance d a lane holds its row's slots [lpos, lpos + 2d).  A
          // chunk that read no source row is zero already.
          for (int d = 1; (gathered >> s) & 1u && d < width; d <<= 1) {
#pragma unroll
            for (int i = 0; i < P; ++i) {
              const uint32_t y = __shfl_down_sync(kFull, x[s][i], d);
              if (lpos + d < width) x[s][i] |= y;
            }
          }
          const long long row = row0 + s * rpc + lrow;
          if (lpos == 0 && in_chunk && row < rows) {
            store_row<W, kVec, P>(out_b, row, x[s], Wd, w0, nw);
          }
        }
      }
    } else {
      // Wide: one row a run, lanes striding over its slots.
      const int* const rc = cols + b[0] + local * width;
      for (int w0 = 0; w0 < Wd; w0 += P) {
        const int nw = min(P, Wd - w0);
        uint32_t acc[P];
#pragma unroll
        for (int i = 0; i < P; ++i) acc[i] = 0u;
        for (int j0 = 0; j0 < width; j0 += 32 * S) {
          int c[S];
#pragma unroll
          for (int s = 0; s < S; ++s) {
            const int j = j0 + s * 32 + lane;
            c[s] = j < width ? __ldcg(rc + j) : prev_rows;
            if (use_map) c[s] = source(c[s]);
          }
#pragma unroll
          for (int s = 0; s < S; ++s) {
            if (c[s] < prev_rows) {
              uint32_t x[P];
              load_row<W, kVec, P>(x, prev, c[s], Wd, w0, nw);
#pragma unroll
              for (int i = 0; i < P; ++i) acc[i] |= x[i];
            }
          }
        }
#pragma unroll
        for (int i = 0; i < P; ++i) {
#pragma unroll
          for (int d = 16; d > 0; d >>= 1) acc[i] |= __shfl_xor_sync(kFull, acc[i], d);
        }
        if (lane == 0) store_row<W, kVec, P>(out_b, local, acc, Wd, w0, nw);
      }
    }
  }
}

// hits[v] = v_cat[final_slot[v]]; 0 without a read where the slot is the
// zero row.  A warp takes kGatherVertices runs of 32 consecutive
// vertices, a lane one vertex of each: its slot loads coalesce, the rows
// of neighbouring vertices (often neighbouring rows: a bucket's rows are
// in vertex order) share sectors within one load instruction, every row
// load is in flight before the first store, and the stores coalesce.
template <int W, bool kVec>
__global__ void __launch_bounds__(msbfs::kThreads)
forest_gather_kernel(const uint32_t* __restrict__ v_cat,
                     const int* __restrict__ final_slot,
                     uint32_t* __restrict__ hits, long long n,
                     long long zero_row, int w_rt,
                     const int* __restrict__ ctrl, int max_levels) {
  if (!msbfs::direction_go(ctrl, max_levels, msbfs::kDirPull)) return;
  constexpr int V = kGatherVertices;
  constexpr int P = W ? W : 1;
  const int Wd = W ? W : w_rt;
  const int lane = threadIdx.x & 31;
  const long long warps = static_cast<long long>(gridDim.x) * (blockDim.x >> 5);
  for (long long base = (blockIdx.x * static_cast<long long>(blockDim.x >> 5) + (threadIdx.x >> 5)) * V * 32;
       base < n; base += warps * V * 32) {
    long long slot[V];
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const long long v = base + i * 32 + lane;
      slot[i] = v < n ? __ldcs(final_slot + v) : zero_row;
    }
    if constexpr (W != 0) {
      uint32_t x[V][P];
#pragma unroll
      for (int i = 0; i < V; ++i) {
        if (slot[i] != zero_row) {
          ldcg_words<W, kVec>(x[i], v_cat + slot[i] * W);
        } else {
#pragma unroll
          for (int j = 0; j < P; ++j) x[i][j] = 0u;
        }
      }
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const long long v = base + i * 32 + lane;
        if (v < n) store_words<W, kVec>(hits + v * W, x[i]);
      }
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const long long v = base + i * 32 + lane;
        if (v >= n) continue;
        for (int w = 0; w < Wd; ++w) {
          hits[v * Wd + w] = slot[i] == zero_row ? 0u : __ldcg(v_cat + slot[i] * Wd + w);
        }
      }
    }
  }
}

// One level launch: the level kernel over ``runs`` runs of table[0 .. nb).
struct Level {
  const uint32_t* prev;
  int prev_rows;
  const int* cols;
  const long long* table;
  int nb;
  uint32_t* out;
  int W;
  long long runs;
  int map;
  const uint32_t* fmap;
  int map_words;
  int shift;
  const unsigned long long* counts;
  long long dense_slots;
  const int* ctrl;
  int max_levels;
  int device;
  cudaStream_t stream;
};

// Per-device launch settings of one shared-map instance.
struct MapLaunch {
  int allowed[msbfs::kMaxDevices] = {};
  int blocks_per_sm[msbfs::kMaxDevices] = {};
  int blocks_smem[msbfs::kMaxDevices] = {};
};

template <int W, bool kVec, int kMap>
cudaError_t launch_level(const Level& a) {
  constexpr int kT = level_threads(W, kMap);
  int grid = msbfs::grid_for(a.runs * 32, kT);
  int smem = 0;
  if constexpr (kMap == kSharedMap) {
    static MapLaunch cfg;
    smem = a.map_words * 4;
    cudaError_t err = msbfs::allow_smem(forest_level_kernel<W, kVec, kMap>, smem,
                                        cfg.allowed, a.device);
    if (err != cudaSuccess) return err;
    int occ = 0, sms = 0;
    const bool cached = a.device >= 0 && a.device < msbfs::kMaxDevices;
    if (cached && cfg.blocks_smem[a.device] == smem && cfg.blocks_per_sm[a.device] > 0) {
      occ = cfg.blocks_per_sm[a.device];
    } else {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &occ, forest_level_kernel<W, kVec, kMap>, kT, smem);
      if (err != cudaSuccess) return err;
      if (occ < 1) return cudaErrorInvalidConfiguration;
      if (cached) {
        cfg.blocks_per_sm[a.device] = occ;
        cfg.blocks_smem[a.device] = smem;
      }
    }
    err = msbfs::sm_count(a.device, &sms);
    if (err != cudaSuccess) return err;
    // Persistent blocks: as many as are resident, at most a warp a run.
    const long long resident = static_cast<long long>(sms) * occ;
    const long long wanted = (a.runs + kT / 32 - 1) / (kT / 32);
    grid = static_cast<int>(resident < wanted ? resident : wanted);
    if (grid < 1) grid = 1;
  }
  forest_level_kernel<W, kVec, kMap><<<grid, kT, smem, a.stream>>>(
      a.prev, a.prev_rows, a.cols, a.table, a.nb, a.out, a.W, a.runs, a.fmap,
      a.map_words, a.shift, a.counts, a.dense_slots, a.ctrl, a.max_levels);
  return cudaGetLastError();
}

template <int W, bool kVec>
cudaError_t launch_segment(const Level& a) {
  switch (a.map) {
    case kSharedMap: return launch_level<W, kVec, kSharedMap>(a);
    case kGlobalMap: return launch_level<W, kVec, kGlobalMap>(a);
    default: return launch_level<W, kVec, kNoMap>(a);
  }
}

// The gather at the plane width W; vec16: v_cat and hits are aligned to a
// row's vector (8 bytes at two words, 16 at four or eight).
inline cudaError_t gather(const uint32_t* v_cat, const int* final_slot, uint32_t* hits,
                          long long n, long long zero_row, int W, bool vec16,
                          const int* ctrl, int max_levels, cudaStream_t s) {
  const int grid = msbfs::grid_for((n + kGatherVertices - 1) / kGatherVertices,
                                   msbfs::kThreads);
#define MSBFS_GATHER(WW, VEC)                                                 \
  forest_gather_kernel<WW, VEC><<<grid, msbfs::kThreads, 0, s>>>(             \
      v_cat, final_slot, hits, n, zero_row, W, ctrl, max_levels)
  switch (vec16 ? W : -W) {
    case 2: MSBFS_GATHER(2, true); break;
    case 4: MSBFS_GATHER(4, true); break;
    case 8: MSBFS_GATHER(8, true); break;
    case 1: case -1: MSBFS_GATHER(1, false); break;
    case -2: MSBFS_GATHER(2, false); break;
    case -4: MSBFS_GATHER(4, false); break;
    case -8: MSBFS_GATHER(8, false); break;
    default: MSBFS_GATHER(0, false); break;
  }
#undef MSBFS_GATHER
  return cudaGetLastError();
}

struct Args {
  const uint32_t* frontier;
  const long long* table;
  const long long* meta;
  int levels;
  uint32_t* v_cat;
  const int* final_slot;
  uint32_t* hits;
  long long n;
  long long total_rows;
  int W;
  bool vec16;
  const int* ctrl;
  int max_levels;
  int device;
  cudaStream_t stream;
};

template <int W, bool kVec>
cudaError_t run(const Args& a) {
  for (int li = 0; li < a.levels; ++li) {
    const long long* m = a.meta + li * kMeta;
    if (m[5] == 0) continue;  // a level without rows
    Level l{};
    l.prev = li == 0 ? a.frontier : a.v_cat + a.meta[(li - 1) * kMeta + 2] * a.W;
    l.prev_rows = static_cast<int>(m[1]);
    l.cols = reinterpret_cast<const int*>(m[0]);
    l.table = a.table + m[3] * kTab;
    l.nb = static_cast<int>(m[4]);
    l.out = a.v_cat + m[2] * a.W;
    l.W = a.W;
    l.runs = m[5];
    l.map = kNoMap;
    l.ctrl = a.ctrl;
    l.max_levels = a.max_levels;
    l.device = a.device;
    l.stream = a.stream;
    const cudaError_t err = launch_level<W, kVec, kNoMap>(l);
    if (err != cudaSuccess) return err;
  }
  return gather(a.v_cat, a.final_slot, a.hits, a.n, a.total_rows, a.W, a.vec16,
                a.ctrl, a.max_levels, a.stream);
}

template <bool kVec>
cudaError_t dispatch(const Args& a) {
  switch (a.W) {
    case 1: return run<1, kVec>(a);
    case 2: return run<2, kVec>(a);
    case 4: return run<4, kVec>(a);
    case 8: return run<8, kVec>(a);
    default: return run<0, kVec>(a);
  }
}

}  // namespace

// The frontier map of forest level 0 (n, W) planes -> fmap (map_words
// uint32, a multiple of 4 and at least ceil(n / 2^shift / 32); bit b: a
// frontier row v with v >> shift == b is nonzero; shift 0 or 1) and counts
// (5 uint64 on the device, zero when allocated; counts[3] the nonzero
// rows, counts[4] their weights' sum).  weights: n int32 (the level-0
// slots naming each vertex).  vec16: the frontier is 16-byte aligned.
extern "C" int msbfs_forest_map(int device, const void* frontier, long long n,
                                int W, int vec16, void* fmap, int map_words,
                                int shift, const void* weights, void* counts,
                                const void* ctrl, int max_levels, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (W < 1 || n < 0 || n >= (1LL << 31) || map_words % 4 || shift < 0 || shift > 1 ||
      (static_cast<long long>(map_words) * 32 << shift) < n || weights == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int sms = 0;
  err = msbfs::sm_count(device, &sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto* f = static_cast<const uint32_t*>(frontier);
  auto* m = static_cast<uint32_t*>(fmap);
  const auto* wt = static_cast<const int*>(weights);
  auto* c = static_cast<unsigned long long*>(counts);
  const auto* g = static_cast<const int*>(ctrl);
  // Few blocks, each warp kMapUnroll words at a time: the last-block
  // count takes one atomic a block.
  int grid = msbfs::grid_for(static_cast<long long>(map_words) * 32 / kMapUnroll,
                             msbfs::kThreads);
  if (grid > sms * kPrepassBlocksPerSm) grid = sms * kPrepassBlocksPerSm;
  const auto s = static_cast<cudaStream_t>(stream);
#define MSBFS_MAP(WW, VEC)                                                    \
  (shift ? forest_map_kernel<WW, VEC, 1><<<grid, msbfs::kThreads, 0, s>>>(    \
               f, n, W, m, map_words, wt, c, g, max_levels)                   \
         : forest_map_kernel<WW, VEC, 0><<<grid, msbfs::kThreads, 0, s>>>(    \
               f, n, W, m, map_words, wt, c, g, max_levels))
  switch (vec16 ? W : -W) {
    case 2: MSBFS_MAP(2, true); break;
    case 4: MSBFS_MAP(4, true); break;
    case 8: MSBFS_MAP(8, true); break;
    case 1: case -1: MSBFS_MAP(1, false); break;
    case -2: MSBFS_MAP(2, false); break;
    case -4: MSBFS_MAP(4, false); break;
    case -8: MSBFS_MAP(8, false); break;
    default: MSBFS_MAP(0, false); break;
  }
#undef MSBFS_MAP
  return static_cast<int>(cudaGetLastError());
}

// One streamed segment: the level kernel over ``runs`` runs of the
// segment's ``buckets`` bucket pieces (table: (buckets, kTab) int64 on the
// device, slot offsets relative to ``cols``, first rows relative to
// ``out``).  prev: the previous level's (prev_rows, W) value rows (the
// frontier at forest level 0); a slot equal to prev_rows reads zero.
// map: 0 none, 1 the map in shared memory, 2 read from device memory —
// then fmap (map_words, its bits at ``shift``) and counts are
// msbfs_forest_map's outputs for prev, and the map is read while
// counts[4] <= dense_slots.
extern "C" int msbfs_forest_segment(int device, const void* prev,
                                    long long prev_rows, const void* cols,
                                    const void* table, int buckets,
                                    long long runs, void* out, int W,
                                    int chunks, int vec16, int map,
                                    const void* fmap, int map_words, int shift,
                                    const void* counts, long long dense_slots,
                                    const void* ctrl, int max_levels, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int P = W == 1 || W == 2 || W == 4 || W == 8 ? W : kPass;
  if (W < 1 || prev_rows < 0 || prev_rows >= (1LL << 31) || buckets < 1 ||
      buckets > kMaxBuckets || runs < 1 || map < kNoMap || map > kGlobalMap ||
      chunks != run_chunks(P) ||
      (map != kNoMap && (fmap == nullptr || counts == nullptr || map_words % 4 ||
                         shift < 0 || shift > 1 ||
                         (static_cast<long long>(map_words) * 32 << shift) < prev_rows))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Level l{};
  l.prev = static_cast<const uint32_t*>(prev);
  l.prev_rows = static_cast<int>(prev_rows);
  l.cols = static_cast<const int*>(cols);
  l.table = static_cast<const long long*>(table);
  l.nb = buckets;
  l.out = static_cast<uint32_t*>(out);
  l.W = W;
  l.runs = runs;
  l.map = map;
  l.fmap = static_cast<const uint32_t*>(fmap);
  l.map_words = map_words;
  l.shift = shift;
  l.counts = static_cast<const unsigned long long*>(counts);
  l.dense_slots = dense_slots;
  l.ctrl = static_cast<const int*>(ctrl);
  l.max_levels = max_levels;
  l.device = device;
  l.stream = static_cast<cudaStream_t>(stream);
  switch (vec16 ? W : -W) {
    case 2: err = launch_segment<2, true>(l); break;
    case 4: err = launch_segment<4, true>(l); break;
    case 8: err = launch_segment<8, true>(l); break;
    case 1: case -1: err = launch_segment<1, false>(l); break;
    case -2: err = launch_segment<2, false>(l); break;
    case -4: err = launch_segment<4, false>(l); break;
    case -8: err = launch_segment<8, false>(l); break;
    default: err = launch_segment<0, false>(l); break;
  }
  return static_cast<int>(err);
}

// The final take of the segment form: hits[v] = v_cat[final_slot[v]] over
// the (zero_row + 1, W) scratch of all forest levels, row zero_row zero
// (never read).  vec16: v_cat and hits are aligned to a row's vector.
extern "C" int msbfs_forest_gather(int device, const void* v_cat,
                                   const void* final_slot, void* hits,
                                   long long n, long long zero_row, int W,
                                   int vec16, const void* ctrl, int max_levels,
                                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (W < 1 || n < 1 || n >= (1LL << 31) || zero_row < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(gather(
      static_cast<const uint32_t*>(v_cat), static_cast<const int*>(final_slot),
      static_cast<uint32_t*>(hits), n, zero_row, W, vec16 != 0,
      static_cast<const int*>(ctrl), max_levels, static_cast<cudaStream_t>(stream)));
}

// table: (buckets, kTab) int64 over all levels; meta: kMeta int64 per
// level (host memory).  chunks: the 32-slot chunks of a narrow run the
// host's table was cut for (it must be this file's).  vec16: frontier,
// scratch and hits are 16-byte aligned.
extern "C" int msbfs_forest_or(int device, const void* frontier,
                               const void* table, const long long* meta,
                               int levels, void* scratch,
                               const void* final_slot, void* hits, long long n,
                               int W, long long total_rows, int chunks,
                               int vec16, const void* ctrl,
                               int max_levels, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  const int P = W == 1 || W == 2 || W == 4 || W == 8 ? W : kPass;
  if (W < 1 || n < 0 || n >= (1LL << 31) || levels < 0 || total_rows < 0 ||
      chunks != run_chunks(P)) {
    return invalid;
  }
  for (int li = 0; li < levels; ++li) {
    if (meta[li * kMeta + 4] > kMaxBuckets || meta[li * kMeta + 1] >= (1LL << 31)) {
      return invalid;
    }
  }
  Args a;
  a.frontier = static_cast<const uint32_t*>(frontier);
  a.table = static_cast<const long long*>(table);
  a.meta = meta;
  a.levels = levels;
  a.v_cat = static_cast<uint32_t*>(scratch);
  a.final_slot = static_cast<const int*>(final_slot);
  a.hits = static_cast<uint32_t*>(hits);
  a.n = n;
  a.total_rows = total_rows;
  a.W = W;
  a.vec16 = vec16 != 0;
  a.ctrl = static_cast<const int*>(ctrl);
  a.max_levels = max_levels;
  a.device = device;
  a.stream = static_cast<cudaStream_t>(stream);
  err = vec16 ? dispatch<true>(a) : dispatch<false>(a);
  return static_cast<int>(err);
}

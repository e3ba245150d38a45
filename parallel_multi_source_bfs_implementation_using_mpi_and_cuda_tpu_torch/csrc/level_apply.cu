// Kernel C — the bit-plane level apply with per-query popcount.
//
// Replaces the XLA ops of the JAX package's ops/bitbell.py:333
// bit_level_apply and :123 unpack_counts (one BFS level's accounting over
// the 7-tuple carry).  For a (rows, W) plane and K = 32W queries:
//
//   new      = hits & ~visited
//   visited |= new;  frontier = new
//   count[q] = number of vertices with bit q of new set   (popcount per query)
//   then, in the last block to finish:
//     f[q] += count[q] * (level + 1)      (int64, reference main.cu:75-89)
//     levels[q] = level + 2 where count[q] > 0
//     reached[q] += count[q]
//     updated = any(count > 0);  level += 1
//
// torch has no popcount; the JAX version unpacks every word into 32 lanes.
//
// Bound: bytes.  Per level it must read hits and write frontier (8W bytes
// per vertex), and read visited only where a hit word is nonzero and write
// it only where something is new: on a thin road frontier almost every hit
// word is 0, so the bound is close to 8W bytes per vertex.
//
// Design, variants picked on the host by ops/bitbell.py apply_plan (a
// pure function of rows, W, whether every base pointer is 16-byte aligned
// and whether the direction switch runs):
//
// * vector (W = 1, 2, 4, 8, a template parameter) — the plane is a flat
//   run of rows * W words; a warp takes 32 * 16 consecutive words a step,
//   a lane four units of 4 words (two of 8 at W = 8) strided so that each
//   16-byte access of the warp is coalesced, and word c of a unit belongs
//   to query word c % W for every lane and every step.  Loads and stores
//   are 16 bytes (uint4) when the plan says every base is aligned, else 4
//   bytes at the same addresses; a lane's four hit loads are all in flight
//   before it uses one, and visited is read only for a 16-byte group whose
//   hit words are not all 0.  Each lane adds its new words into W bit-sliced (vertical)
//   counters of D bits — bit b of counter level i is bit i of the count of
//   query bit b — a ripple add per nonzero word.  A warp unpacks its
//   counters (a 32 x 32 bit transpose by shuffles and a popcount per level
//   in use) only when they could overflow and once at the end of its walk,
//   instead of 32 ballots for every 32 words.
// * column (every other W) — a warp owns one word
//   column w for its whole walk (the grid's warp count is a multiple of W)
//   and 32 consecutive rows a step: 4-byte loads strided by W, one vertical
//   counter.
//
// The direction switch (optional; absent on the stencil route and on a
// bitbell route that only pulls): on a direction-switched route the apply
// also decides the next level's direction, so a level enqueues no host
// op.  Every row whose new frontier row is nonzero is counted with its
// dedup out-degree, and a row with out-edges is appended to the worklist
// (msbfs_common.cuh) while it has room: one 64-bit atomic per warp step
// takes the rows' list slots and their edge prefix together, and a warp
// that sees the list full counts in registers from then on.  The last
// block writes ctrl[3] = kDirPush when rows <= row_limit and edges <=
// edge_limit (the JAX predicates: bitbell's `cnt <= budget & edges <=
// budget`, mxu's `cnt <= switch & edges <= budget`), else kDirPull.  The
// push writes a hit plane of its own (the switch's), all zero between
// levels: on a level that ctrl[3] sent to the push the apply reads that
// plane and writes 0 back over every nonzero word it consumed, so the push
// needs no zeroing launch; on a pulled level it reads the pull's plane,
// which the pull rewrites whole, and clears nothing.  The vector variant
// carries the switch as a template parameter (its instance without the
// switch compiles to the code it had before the switch existed).  The
// column variant's warps own one word column each, so no warp sees a
// whole row: with a switch, widths outside 1, 2, 4, 8 take the third
// variant, rows — a lane per row walking its W words, each word column's
// counts taken by a warp transpose.
//
// Indices are 32-bit (the wrapper refuses rows * W >= 2^31 words).  Block
// counts meet in shared memory and are added once per query to a (K,)
// device vector; the block that takes the last ticket folds those counts
// into the per-query counters and advances the device-side level control,
// so a level costs one launch and no host round trip.
#include "msbfs_common.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;

// Adds the 32 bits of x (one count per bit position) into a D-level
// vertical counter.
template <int D>
__device__ __forceinline__ void vadd(uint32_t (&cnt)[D], uint32_t x) {
#pragma unroll
  for (int i = 0; i < D; ++i) {
    const uint32_t carry = cnt[i] & x;
    cnt[i] ^= x;
    x = carry;
  }
}

// The warp's 32 x 32 bit matrix (lane L holds row L) transposed: lane b
// receives bit b of every lane, lane L's bit in position L.
__device__ __forceinline__ uint32_t transpose32(uint32_t x, int lane) {
  uint32_t m = 0x0000ffffu;
#pragma unroll
  for (int j = 16; j > 0; j >>= 1, m ^= m << j) {
    const uint32_t y = __shfl_xor_sync(kFull, x, j);
    x = (lane & j) ? (x & ~m) | ((y >> j) & m) : (x & m) | ((y & m) << j);
  }
  return x;
}

// Warp-wide: lane b receives the count of query bit b summed over the
// warp's vertical counters (a transpose and a popcount per counter level
// in use); the counters are cleared.
template <int D>
__device__ __forceinline__ int vflush(uint32_t (&cnt)[D], int lane) {
  int mine = 0;
#pragma unroll
  for (int i = 0; i < D; ++i) {
    if (!__any_sync(kFull, cnt[i] != 0)) continue;
    mine += __popc(transpose32(cnt[i], lane)) << i;
    cnt[i] = 0;
  }
  return mine;
}

// The direction switch's state (msbfs_common.cuh).
struct Switch {
  uint32_t* push_hits;  // the push's (rows, W) plane, zero between levels
  const int* count;   // (rows,) dedup out-degree
  int* wl_rows;       // worklist row 0: appended rows
  int* wl_offs;       // worklist row 1: their first edge
  long long cap;      // worklist capacity
  long long* state;   // (kSwitchWords,)
  long long row_limit;
  long long edge_limit;
};

// A warp's switch accounting: active rows and their edges counted without
// an append (per lane), and whether the worklist is full (warp-uniform).
struct Tally {
  unsigned long long rows;
  unsigned long long edges;
  bool full;
};

using u64 = unsigned long long;

// Warp-wide, with a warp-uniform t.full: the lane's active rows are the
// set bits of act, row_of(slot) their indices.  Rows with out-edges are
// appended, one atomic per warp for their list slots and edge prefix
// together; rows without, and every row once the list is full, go to the
// tally.
template <int kSlots, typename RowOf>
__device__ __forceinline__ void tally_rows(uint32_t act, RowOf row_of,
                                           const Switch& sw, Tally& t,
                                           int lane) {
  if (!__any_sync(kFull, act)) return;
  int d[kSlots];  // every out-degree load in flight before any use
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    d[s] = ((act >> s) & 1u) ? __ldg(sw.count + row_of(s)) : 0;
  }
  uint32_t app = 0;
  u64 mine = 0;  // (rows << 32) | edges this lane appends
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    if ((act >> s) & 1u) {
      if (d[s] > 0 && !t.full) {
        app |= 1u << s;
        mine += (u64{1} << 32) + static_cast<u64>(d[s]);
      } else {
        t.rows += 1;
        t.edges += static_cast<u64>(d[s]);
      }
    }
  }
  if (t.full) return;
  u64 incl = mine;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const u64 y = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += y;
  }
  const u64 total = __shfl_sync(kFull, incl, 31);
  if (total == 0) return;
  u64 base = 0;
  if (lane == 0) {
    base = atomicAdd(reinterpret_cast<u64*>(sw.state + msbfs::kAppend), total);
  }
  base = __shfl_sync(kFull, base, 0);
  // Edges of all appended rows stay below 2^32 (the dedup CSR's length
  // fits an int32), so the low halves never carry.
  const u64 excl = incl - mine;
  long long idx = static_cast<long long>((base >> 32) + (excl >> 32));
  uint32_t off = static_cast<uint32_t>(base) + static_cast<uint32_t>(excl);
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    if ((app >> s) & 1u) {
      if (idx < sw.cap) {
        sw.wl_rows[idx] = row_of(s);
        sw.wl_offs[idx] = static_cast<int>(off);
      }
      off += static_cast<uint32_t>(d[s]);
      ++idx;
    }
  }
  if (static_cast<long long>((base + total) >> 32) >= sw.cap) t.full = true;
}

// Warp-wide: the warp's tally into the block's two shared counters.
__device__ __forceinline__ void tally_flush(const Tally& t, u64* s_other,
                                            int lane) {
  u64 rows = t.rows, edges = t.edges;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    rows += __shfl_xor_sync(kFull, rows, o);
    edges += __shfl_xor_sync(kFull, edges, o);
  }
  if (lane == 0 && rows) {
    atomicAdd(s_other, rows);
    atomicAdd(s_other + 1, edges);
  }
}

// Block tail: this block's counts into the (K,) vector, then the last block
// folds them into the per-query counters and advances the control; with a
// switch, the block's tally goes to the state first and the last block
// decides the next level's direction.
template <bool kSwitch>
__device__ void finish_level(const int* s_counts, int K, int level,
                             int* __restrict__ counts,
                             long long* __restrict__ f,
                             int* __restrict__ levels,
                             int* __restrict__ reached,
                             int* __restrict__ ctrl, const Switch& sw,
                             const u64* s_other) {
  __shared__ int s_last;
  __syncthreads();
  for (int q = threadIdx.x; q < K; q += blockDim.x) {
    const int c = s_counts[q];
    if (c) atomicAdd(counts + q, c);
  }
  if constexpr (kSwitch) {
    if (threadIdx.x == 0 && s_other[0]) {
      u64* st = reinterpret_cast<u64*>(sw.state);
      atomicAdd(st + msbfs::kOtherRows, s_other[0]);
      atomicAdd(st + msbfs::kOtherEdges, s_other[1]);
    }
  }
  // Last-block tail: make this block's count atomics visible before it
  // takes a ticket; the block that takes the last ticket sees them all.
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    s_last = atomicAdd(ctrl + 2, 1) == static_cast<int>(gridDim.x) - 1;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const long long dist = static_cast<long long>(level) + 1;
  int found = 0;
  for (int q = threadIdx.x; q < K; q += blockDim.x) {
    const int c = atomicExch(counts + q, 0);
    if (c > 0) {
      found = 1;
      f[q] += static_cast<long long>(c) * dist;
      levels[q] = level + 2;
      reached[q] += c;
    }
  }
  found = __syncthreads_or(found);
  if (threadIdx.x == 0) {
    if constexpr (kSwitch) {
      u64* st = reinterpret_cast<u64*>(sw.state);
      const u64 app = atomicExch(st + msbfs::kAppend, u64{0});
      const long long listed = static_cast<long long>(app >> 32);
      const long long listed_edges = static_cast<long long>(app & 0xffffffffull);
      const long long rows =
          listed + static_cast<long long>(atomicExch(st + msbfs::kOtherRows, u64{0}));
      const long long edges =
          listed_edges +
          static_cast<long long>(atomicExch(st + msbfs::kOtherEdges, u64{0}));
      sw.state[msbfs::kListed] = listed < sw.cap ? listed : sw.cap;
      sw.state[msbfs::kListedEdges] = listed_edges;
      sw.state[msbfs::kActiveRows] = rows;
      sw.state[msbfs::kActiveEdges] = edges;
      ctrl[3] = rows <= sw.row_limit && edges <= sw.edge_limit ? msbfs::kDirPush
                                                               : msbfs::kDirPull;
    }
    ctrl[0] = found;
    ctrl[1] = level + 1;
    ctrl[2] = 0;
  }
}

// The 4-word group of hits at word i (through the read-only path unless
// the kernel also clears the plane: kClear).
template <bool kVec16, bool kClear>
__device__ __forceinline__ void load4(const uint32_t* __restrict__ hits,
                                      unsigned i, uint32_t (&x)[4]) {
  if constexpr (kVec16) {
    const uint4* p = reinterpret_cast<const uint4*>(hits + i);
    const uint4 h = kClear ? *p : __ldg(p);
    x[0] = h.x; x[1] = h.y; x[2] = h.z; x[3] = h.w;
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c) x[c] = kClear ? hits[i + c] : __ldg(hits + i + c);
  }
}

// Zero the group's nonzero hit words (x holds them).
template <bool kVec16>
__device__ __forceinline__ void clear4(uint32_t* __restrict__ hits, unsigned i,
                                       const uint32_t (&x)[4]) {
  if constexpr (kVec16) {
    if (x[0] | x[1] | x[2] | x[3]) {
      *reinterpret_cast<uint4*>(hits + i) = make_uint4(0u, 0u, 0u, 0u);
    }
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (x[c]) hits[i + c] = 0u;
    }
  }
}

// The 4-word group at word i, its hit words in x: visited read only where
// a hit word is nonzero, frontier written; leaves the new words in x.
template <bool kVec16>
__device__ __forceinline__ void apply4(uint32_t* __restrict__ visited,
                                       uint32_t* __restrict__ frontier,
                                       unsigned i, uint32_t (&x)[4]) {
  if constexpr (kVec16) {
    if (x[0] | x[1] | x[2] | x[3]) {
      uint4 v = *reinterpret_cast<const uint4*>(visited + i);
      x[0] &= ~v.x; x[1] &= ~v.y; x[2] &= ~v.z; x[3] &= ~v.w;
      if (x[0] | x[1] | x[2] | x[3]) {
        v.x |= x[0]; v.y |= x[1]; v.z |= x[2]; v.w |= x[3];
        *reinterpret_cast<uint4*>(visited + i) = v;
      }
    }
    *reinterpret_cast<uint4*>(frontier + i) = make_uint4(x[0], x[1], x[2], x[3]);
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (x[c]) {
        const uint32_t v = visited[i + c];
        x[c] &= ~v;
        if (x[c]) visited[i + c] = v | x[c];
      }
      frontier[i + c] = x[c];
    }
  }
}

template <int W, bool kVec16, bool kSwitch>
__global__ void __launch_bounds__(msbfs::kThreads)
level_apply_vector_kernel(uint32_t* __restrict__ hits,
                          uint32_t* __restrict__ visited,
                          uint32_t* __restrict__ frontier, int rows,
                          int* __restrict__ counts, long long* __restrict__ f,
                          int* __restrict__ levels, int* __restrict__ reached,
                          int* __restrict__ ctrl, int max_levels, Switch sw) {
  constexpr int V = 16;                // words per lane a step
  constexpr int C = W == 8 ? 8 : 4;    // consecutive words of a lane's unit
  constexpr int U = V / C;             // units per lane a step
  constexpr int D = W == 8 ? 5 : 8;    // bits per vertical counter
  constexpr int kFlushEvery = ((1 << D) - 1) / (V / W);  // steps per flush
  constexpr int K = 32 * W;
  __shared__ int s_counts[K];
  __shared__ u64 s_other[2];  // the switch's block tally
  if (!msbfs::level_go(ctrl, max_levels)) return;
  const int level = __ldcg(ctrl + 1);
  for (int q = threadIdx.x; q < K; q += blockDim.x) s_counts[q] = 0;
  if (kSwitch && threadIdx.x < 2) s_other[threadIdx.x] = 0;
  bool clear = false;  // a pushed level: read and clear the push's plane
  if constexpr (kSwitch) {
    if (__ldcg(ctrl + 3) == msbfs::kDirPush) {
      hits = sw.push_hits;
      clear = true;
    }
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const unsigned total = static_cast<unsigned>(rows) * W;
  const unsigned warps = gridDim.x * (blockDim.x >> 5);
  uint32_t cnt[W][D] = {};
  int pending = 0;
  Tally tally{0, 0, sw.cap == 0};
  // base is warp-uniform, so every lane takes part in each flush's shuffles.
  for (unsigned base = (blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5)) *
                       (32u * V);
       base < total; base += warps * (32u * V)) {
    // Unit u of the lane: words [i_u, i_u + C), i_u = base + (32u + lane) C,
    // so each 16-byte access of the warp covers 512 contiguous bytes (W <=
    // 4) or 32-byte sectors in pairs (W = 8), and word c of a unit belongs
    // to query word c % W.  The lane's 16 words are whole rows: slot s (of
    // 16 / W) is the row holding its words [sW, sW + W).
    uint32_t act = 0;  // the lane's slots with a nonzero new row
    if (base + 32u * V <= total) {
      unsigned at[V / 4];    // the word index of each 4-word group
      uint32_t x[V / 4][4];  // every hit load in flight before any use
#pragma unroll
      for (int g = 0; g < V / 4; ++g) {
        at[g] = base + ((g / (C / 4)) * 32u + lane) * C + 4 * (g % (C / 4));
        load4<kVec16, kSwitch>(hits, at[g], x[g]);
      }
#pragma unroll
      for (int g = 0; g < V / 4; ++g) {
        if (kSwitch && clear) clear4<kVec16>(hits, at[g], x[g]);
        apply4<kVec16>(visited, frontier, at[g], x[g]);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if (x[g][c]) {
            vadd<D>(cnt[(4 * (g % (C / 4)) + c) % W], x[g][c]);
            if constexpr (kSwitch) act |= 1u << ((4 * g + c) / W);
          }
        }
      }
    } else {  // the ragged end of the plane
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const unsigned i = base + (u * 32u + lane) * C;
#pragma unroll
        for (int c = 0; c < C; ++c) {  // unrolled: cnt stays in registers
          if (i + c < total) {
            uint32_t h = kSwitch ? hits[i + c] : __ldg(hits + i + c);
            if (h) {
              if (kSwitch && clear) hits[i + c] = 0u;
              const uint32_t v = visited[i + c];
              h &= ~v;
              if (h) visited[i + c] = v | h;
            }
            frontier[i + c] = h;
            if (h) {
              vadd<D>(cnt[c % W], h);
              if constexpr (kSwitch) act |= 1u << ((u * C + c) / W);
            }
          }
        }
      }
    }
    if constexpr (kSwitch) {
      tally_rows<V / W>(
          act,
          [&](int slot) {
            const unsigned lw = static_cast<unsigned>(slot) * W;
            return static_cast<int>(
                (base + ((lw / C) * 32u + lane) * C + lw % C) / W);
          },
          sw, tally, lane);
    }
    if (++pending == kFlushEvery) {
#pragma unroll
      for (int w = 0; w < W; ++w) {
        const int c = vflush<D>(cnt[w], lane);
        if (c) atomicAdd(s_counts + w * 32 + lane, c);
      }
      pending = 0;
    }
  }
  if (pending) {
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const int c = vflush<D>(cnt[w], lane);
      if (c) atomicAdd(s_counts + w * 32 + lane, c);
    }
  }
  if constexpr (kSwitch) tally_flush(tally, s_other, lane);
  finish_level<kSwitch>(s_counts, K, level, counts, f, levels, reached, ctrl,
                        sw, s_other);
}

__global__ void __launch_bounds__(msbfs::kThreads)
level_apply_column_kernel(const uint32_t* __restrict__ hits,
                          uint32_t* __restrict__ visited,
                          uint32_t* __restrict__ frontier, int rows, int W,
                          int* __restrict__ counts, long long* __restrict__ f,
                          int* __restrict__ levels, int* __restrict__ reached,
                          int* __restrict__ ctrl, int max_levels) {
  constexpr int D = 8;
  constexpr int kFlushEvery = (1 << D) - 1;
  extern __shared__ int s_counts[];  // K = 32 * W per-query partials
  if (!msbfs::level_go(ctrl, max_levels)) return;
  const int level = __ldcg(ctrl + 1);
  const int K = 32 * W;
  for (int q = threadIdx.x; q < K; q += blockDim.x) s_counts[q] = 0;
  __syncthreads();

  const int lane = threadIdx.x & 31;
  // The grid's warp count is a multiple of W (host), so a warp keeps its
  // word column for its whole walk.
  const unsigned warp = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const unsigned step = gridDim.x * (blockDim.x >> 5) / W;
  const int w = static_cast<int>(warp % W);
  uint32_t cnt[D] = {};
  int pending = 0;
  for (unsigned g = warp / W; g * 32u < static_cast<unsigned>(rows); g += step) {
    const unsigned v = g * 32u + lane;
    if (v < static_cast<unsigned>(rows)) {
      const unsigned i = v * W + w;
      uint32_t h = __ldg(hits + i);
      if (h) {
        const uint32_t vis = visited[i];
        h &= ~vis;
        if (h) visited[i] = vis | h;
      }
      frontier[i] = h;
      if (h) vadd<D>(cnt, h);
    }
    if (++pending == kFlushEvery) {
      const int c = vflush<D>(cnt, lane);
      if (c) atomicAdd(s_counts + w * 32 + lane, c);
      pending = 0;
    }
  }
  if (pending) {
    const int c = vflush<D>(cnt, lane);
    if (c) atomicAdd(s_counts + w * 32 + lane, c);
  }
  finish_level<false>(s_counts, K, level, counts, f, levels, reached, ctrl,
                      Switch{}, nullptr);
}

// The switched apply at any W: a lane owns a row of 32 consecutive ones a
// step and walks its W words (4-byte accesses strided by W across the
// warp; the sectors serve the next words from L1).  Each word column's
// counts are the popcounts of a warp transpose of the warp's 32 new words,
// taken only when one of them is nonzero.
__global__ void __launch_bounds__(msbfs::kThreads)
level_apply_rows_kernel(uint32_t* __restrict__ hits,
                        uint32_t* __restrict__ visited,
                        uint32_t* __restrict__ frontier, int rows, int W,
                        int* __restrict__ counts, long long* __restrict__ f,
                        int* __restrict__ levels, int* __restrict__ reached,
                        int* __restrict__ ctrl, int max_levels, Switch sw) {
  extern __shared__ int s_counts[];  // K = 32 * W per-query partials
  __shared__ u64 s_other[2];
  if (!msbfs::level_go(ctrl, max_levels)) return;
  const int level = __ldcg(ctrl + 1);
  const int K = 32 * W;
  for (int q = threadIdx.x; q < K; q += blockDim.x) s_counts[q] = 0;
  if (threadIdx.x < 2) s_other[threadIdx.x] = 0;
  const bool clear = __ldcg(ctrl + 3) == msbfs::kDirPush;
  if (clear) hits = sw.push_hits;
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const unsigned warps = gridDim.x * (blockDim.x >> 5);
  Tally tally{0, 0, sw.cap == 0};
  // g is warp-uniform: every lane reaches the shuffles.
  for (unsigned g = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
       g * 32u < static_cast<unsigned>(rows); g += warps) {
    const unsigned v = g * 32u + lane;
    const bool mine = v < static_cast<unsigned>(rows);
    bool active = false;
    for (int w = 0; w < W; ++w) {
      uint32_t h = 0;
      if (mine) {
        const unsigned i = v * W + w;
        h = hits[i];
        if (h) {
          if (clear) hits[i] = 0u;
          const uint32_t vis = visited[i];
          h &= ~vis;
          if (h) visited[i] = vis | h;
        }
        frontier[i] = h;
        active |= h != 0u;
      }
      if (__any_sync(kFull, h != 0u)) {
        const int c = __popc(transpose32(h, lane));
        if (c) atomicAdd(s_counts + w * 32 + lane, c);
      }
    }
    tally_rows<1>(active ? 1u : 0u, [&](int) { return static_cast<int>(v); },
                  sw, tally, lane);
  }
  tally_flush(tally, s_other, lane);
  finish_level<true>(s_counts, K, level, counts, f, levels, reached, ctrl, sw,
                     s_other);
}

struct Args {
  int device;
  uint32_t* hits;
  uint32_t* visited;
  uint32_t* frontier;
  int rows;
  int* counts;
  long long* f;
  int* levels;
  int* reached;
  int* ctrl;
  int max_levels;
  Switch sw;
  cudaStream_t stream;
};

template <int W, bool kVec16, bool kSwitch>
cudaError_t launch_vector(const Args& a) {
  constexpr int V = 16;
  static int wave[msbfs::kMaxDevices] = {};  // blocks resident at once
  auto kernel = level_apply_vector_kernel<W, kVec16, kSwitch>;
  const bool cached = a.device >= 0 && a.device < msbfs::kMaxDevices;
  int resident = cached ? wave[a.device] : 0;
  if (!resident) {
    int sms = 0, per_sm = 0;
    cudaError_t err = msbfs::sm_count(a.device, &sms);
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                          msbfs::kThreads, 0);
    }
    if (err != cudaSuccess) return err;
    resident = sms * (per_sm > 0 ? per_sm : 1);
    if (cached) wave[a.device] = resident;
  }
  // One wave of blocks: a warp walks several steps, and no second, ragged
  // wave of blocks repeats the per-block tail.
  const long long steps =
      (static_cast<long long>(a.rows) * W + 32 * V - 1) / (32 * V);
  long long grid = msbfs::grid_for(steps, msbfs::kThreads / 32);
  if (grid > resident) grid = resident;
  kernel<<<static_cast<int>(grid), msbfs::kThreads, 0, a.stream>>>(
      a.hits, a.visited, a.frontier, a.rows, a.counts, a.f, a.levels,
      a.reached, a.ctrl, a.max_levels, a.sw);
  return cudaGetLastError();
}

template <bool kVec16, bool kSwitch>
cudaError_t dispatch_vector(const Args& a, int W) {
  switch (W) {
    case 1: return launch_vector<1, kVec16, kSwitch>(a);
    case 2: return launch_vector<2, kVec16, kSwitch>(a);
    case 4: return launch_vector<4, kVec16, kSwitch>(a);
    case 8: return launch_vector<8, kVec16, kSwitch>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <bool kSwitch>
cudaError_t dispatch_vector_access(const Args& a, int W, bool vec16) {
  return vec16 ? dispatch_vector<true, kSwitch>(a, W)
               : dispatch_vector<false, kSwitch>(a, W);
}

cudaError_t launch_column(const Args& a, int W) {
  constexpr int kWarps = msbfs::kThreads / 32;
  // Blocks in multiples of W / gcd(W, 8), so the warp count divides by W.
  int g = W, b = kWarps;
  while (b) { const int t = g % b; g = b; b = t; }
  const long long unit = W / g;
  const long long warps = ((static_cast<long long>(a.rows) + 31) / 32) * W;
  long long grid = msbfs::grid_for(warps, kWarps);
  grid = (grid + unit - 1) / unit * unit;
  if (grid > msbfs::kMaxBlocks) grid = msbfs::kMaxBlocks / unit * unit;
  if (grid < unit) grid = unit;
  const size_t shmem = static_cast<size_t>(32) * W * sizeof(int);
  level_apply_column_kernel<<<static_cast<int>(grid), msbfs::kThreads, shmem,
                              a.stream>>>(
      a.hits, a.visited, a.frontier, a.rows, W, a.counts, a.f, a.levels,
      a.reached, a.ctrl, a.max_levels);
  return cudaGetLastError();
}

cudaError_t launch_rows(const Args& a, int W) {
  const long long warps = (static_cast<long long>(a.rows) + 31) / 32;
  const size_t shmem = static_cast<size_t>(32) * W * sizeof(int);
  level_apply_rows_kernel<<<msbfs::grid_for(warps, msbfs::kThreads / 32),
                            msbfs::kThreads, shmem, a.stream>>>(
      a.hits, a.visited, a.frontier, a.rows, W, a.counts, a.f, a.levels,
      a.reached, a.ctrl, a.max_levels, a.sw);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// variant: 0 = vector (W in 1, 2, 4, 8), 1 = column (any W, no switch),
// 2 = rows (any W, with a switch).  vec16: every plane's base pointer is
// 16-byte aligned (vector variant only).  The switch is present when
// state is not null: sw_count the (rows,) out-degrees, worklist a (2, cap)
// int32 buffer, state the (kSwitchWords,) int64 vector of
// msbfs_common.cuh, push_hits the push's (rows, W) plane, and the two
// limits of the push predicate.
extern "C" int msbfs_level_apply(int device, void* hits, void* visited,
                                 void* frontier, long long rows, int W,
                                 void* counts, void* f, void* levels,
                                 void* reached, void* ctrl, int max_levels,
                                 int variant, int vec16, const void* sw_count,
                                 void* worklist, long long cap, void* state,
                                 void* push_hits, long long row_limit,
                                 long long edge_limit, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  if (W < 1 || W > 1024 || rows < 0 || rows * W >= (1LL << 31)) return invalid;
  if (vec16 && !(aligned16(hits) && aligned16(visited) && aligned16(frontier))) {
    return invalid;
  }
  const bool switched = state != nullptr;
  if (switched && (sw_count == nullptr || push_hits == nullptr || cap < 0 ||
                   cap > rows || (cap > 0 && worklist == nullptr) ||
                   (vec16 && !aligned16(push_hits)))) {
    return invalid;
  }
  int* wl = static_cast<int*>(worklist);
  const Switch sw{static_cast<uint32_t*>(push_hits),
                  static_cast<const int*>(sw_count), wl,
                  wl ? wl + cap : nullptr, cap,
                  static_cast<long long*>(state), row_limit, edge_limit};
  Args a{device, static_cast<uint32_t*>(hits),
         static_cast<uint32_t*>(visited), static_cast<uint32_t*>(frontier),
         static_cast<int>(rows),
         static_cast<int*>(counts), static_cast<long long*>(f),
         static_cast<int*>(levels), static_cast<int*>(reached),
         static_cast<int*>(ctrl), max_levels, sw,
         static_cast<cudaStream_t>(stream)};
  if (variant == 0) {
    err = switched ? dispatch_vector_access<true>(a, W, vec16)
                   : dispatch_vector_access<false>(a, W, vec16);
  } else if (variant == 1 && !vec16 && !switched) {
    err = launch_column(a, W);
  } else if (variant == 2 && !vec16 && switched) {
    err = launch_rows(a, W);
  } else {
    return invalid;
  }
  return static_cast<int>(err);
}

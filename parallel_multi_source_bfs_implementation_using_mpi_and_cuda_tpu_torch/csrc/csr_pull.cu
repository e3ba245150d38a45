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
// returns at once when it is 0, and the last block of the apply recomputes
// it (ctrl[2] is its ticket).  No host read.
//
// The XLA chains gather a frontier flag for every slot and reduce it per
// row with a sorted segment_max: an (E,) byte intermediate a query, and an
// (E, K) one for the packed matrix (2.15 GB at RMAT-20, K = 64).  RMAT-20
// is skewed: its largest row has 139,579 slots, and a thread that walks a
// row alone turns a level into that row's chain of dependent loads.
//
// Design.  The per-query state is carried as bit planes beside dist
// (ops/cuda_csr.py CsrPlanes), W = ceil(K / 32) words a vertex, query
// 32w+b in bit b of word w: frontier (what the previous level labelled),
// visited (dist != -1) and hits (zero between levels), the running-query
// mask and found words (aux), and a union map, one bit a vertex, set where
// the vertex is in some query's frontier (128 KB at n = 2^20).  The work
// is the graph's virtual rows (models/csr.py virtual_rows): every row of
// at most 32 slots whole, then the longer rows cut into pieces of at most
// 256 slots, each (start, end, owner).  A level is up to three launches,
// one a call (phase):
//   pack   (only when the planes are stale: the first level of a chunk, or
//          after anyone else wrote the carry): the planes, the mask and the
//          union map from dist; a warp takes 32 consecutive vertices, its
//          lanes over the vertices (rows layout: a word's 32 dist loads in
//          flight, each coalesced across the warp) or over the queries of
//          one vertex (minor layout: 8 vertices' words in flight, each one
//          coalesced load, two ballots a word);
//   walk:  persistent blocks, the union map in shared memory (folded to a
//          bit per 2^shift vertices where n/8 bytes do not fit two blocks
//          an SM: a false bit costs one frontier read, never a wrong bit).
//          A row first loads its owner's visited words and skips its cols
//          when no running query leaves the owner unreached.  A warp takes
//          32 short rows, a thread each, 4 slots in flight; or 8 pieces of
//          long rows, a lane each testing its piece's owner (dropping the
//          queries the row's other pieces already hit: the hit words so
//          far), then the warp walks the live pieces one by one, its lanes
//          over the slots, all 256 cols loads in flight, then the frontier
//          rows 32 slots at a time, with a coverage check after each round
//          that read one.  A slot reads its neighbour's W frontier
//          words only when the map bit is set, and a row stops once its hits
//          cover the queries that can still reach it.  A short row stores
//          its hit words, a long piece ORs its warp's words in with one
//          atomicOr a word;
//   apply: one thread a vertex over its W words: new = hits & ~visited &
//          running; visited |= new; frontier = new; hits = 0; the next
//          union map word from a ballot; dist[q * sq + v * sv] = level + 1
//          for each new bit (rows layout: a query at a time over the warp's
//          32 vertices, so the stores are neighbours; minor: a vertex at a
//          time, the lanes over its queries).  The block that takes the last
//          ticket folds the found words into updated/level, rewrites the
//          mask and ctrl[0].
// A steady level is two launches (walk, apply), a stale one three.
//
// Bound: bytes.  A level on carried bits must read the frontier and
// visited planes once, the virtual rows and the cols of the rows that
// some running query has not reached, and write the planes and the new
// labels (chip_smoke.py counts them on a real level).  The walk reads the
// frontier rows it needs at random: they stay in the 50 MB L2 (8 MB at
// RMAT-20, K = 64).
#include "msbfs_common.cuh"

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
// The launches of a level: the entry's ``phase``.
constexpr int kPhasePack = 1;
constexpr int kPhaseWalk = 2;
constexpr int kPhaseApply = 4;
// Words a pass of the generic width (W not 1, 2, 4 or 8).
constexpr int kPassWords = 8;
// The walk: threads a block (ops/cuda_csr.py map_shift sizes the shared
// map so that at least two blocks fit an SM).
constexpr int kWalkThreads = 512;
// Slots in flight: a short row's thread, a long piece's lane (all its
// cols, then kRoundSlots frontier rows between coverage checks); pieces of
// long rows a warp takes at once.
constexpr int kShortSlots = 4;
constexpr int kLongSlots = 8;
constexpr int kRoundSlots = 1;
constexpr int kLongChunk = 8;
// Queries whose level the pack keeps in shared memory, and the vertices
// a warp of the minor pack has in flight.
constexpr int kPackLevels = 8192;
constexpr int kPackRows = 8;

__device__ __forceinline__ bool may_run(const int* updated, const int* level,
                                        const int* stop, int q) {
  return __ldcg(updated + q) != 0 && __ldcg(level + q) < __ldcg(stop + q);
}

// P words at p through the read-only path: one vector load where the row
// is 8 or 16 bytes wide (rows of the torch-allocated planes are aligned).
template <int P>
__device__ __forceinline__ void ldg_words(uint32_t (&out)[P],
                                          const uint32_t* p) {
  if constexpr (P % 4 == 0) {
#pragma unroll
    for (int i = 0; i < P; i += 4) {
      const uint4 x = __ldg(reinterpret_cast<const uint4*>(p + i));
      out[i] = x.x; out[i + 1] = x.y; out[i + 2] = x.z; out[i + 3] = x.w;
    }
  } else if constexpr (P == 2) {
    const uint2 x = __ldg(reinterpret_cast<const uint2*>(p));
    out[0] = x.x; out[1] = x.y;
  } else {
#pragma unroll
    for (int i = 0; i < P; ++i) out[i] = __ldg(p + i);
  }
}

// Bit k of the result: the OR of bits [k << shift, (k + 1) << shift) of x.
__device__ __forceinline__ uint32_t fold_bits(uint32_t x, int shift) {
  for (int t = 0; t < shift; ++t) {
    x = (x | (x >> 1)) & 0x55555555u;
    x = (x | (x >> 1)) & 0x33333333u;
    x = (x | (x >> 2)) & 0x0f0f0f0fu;
    x = (x | (x >> 4)) & 0x00ff00ffu;
    x = (x | (x >> 8)) & 0x0000ffffu;
  }
  return x;
}

// ---- pack -------------------------------------------------------------------

// A running query's level, else -2 (never a distance).
__device__ __forceinline__ int pack_level(const int* s_level, int cached,
                                          const int* level, const int* updated,
                                          const int* stop, int q) {
  if (q < cached) return s_level[q];
  return may_run(updated, level, stop, q) ? __ldcg(level + q) : -2;
}

__global__ void __launch_bounds__(msbfs::kThreads)
csr_pack_kernel(const int* __restrict__ dist, long long sq, long long sv,
                const int* __restrict__ level, const int* __restrict__ updated,
                const int* __restrict__ stop, uint32_t* __restrict__ frontier,
                uint32_t* __restrict__ visited, uint32_t* __restrict__ hits,
                uint32_t* __restrict__ aux, uint32_t* __restrict__ umap,
                long long n, int K, int W, const int* __restrict__ ctrl) {
  if (__ldcg(ctrl) == 0) return;
  extern __shared__ int s_level[];
  const int cached = min(K, kPackLevels);
  for (int q = threadIdx.x; q < cached; q += blockDim.x) {
    s_level[q] = may_run(updated, level, stop, q) ? __ldcg(level + q) : -2;
  }
  __syncthreads();
  if (blockIdx.x == 0) {
    for (int w = threadIdx.x; w < W; w += blockDim.x) {
      uint32_t word = 0u;
      for (int b = 0; b < 32 && w * 32 + b < K; ++b) {
        word |= static_cast<uint32_t>(
                    pack_level(s_level, cached, level, updated, stop, w * 32 + b) != -2)
                << b;
      }
      aux[w] = word;
      aux[W + w] = 0u;
    }
  }
  const int lane = threadIdx.x & 31;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long base = blockIdx.x * static_cast<long long>(blockDim.x) +
                        (threadIdx.x & ~31);
       base < n; base += stride) {
    uint32_t ubits;
    if (sv == 1) {
      // Rows: a lane a vertex; bit b of word w is query 32w+b, whose row
      // the warp reads at 32 neighbouring vertices.
      const long long v = base + lane;
      bool any = false;
      if (v < n) {
        for (int w = 0; w < W; ++w) {
          const int q0 = w * 32;
          const int nb = min(32, K - q0);
          uint32_t fr = 0u, vis = 0u;
          const int* const col = dist + static_cast<long long>(q0) * sq + v;
          if (nb == 32) {
            // A whole word: the 32 loads are issued together.
            int d[32];
#pragma unroll
            for (int b = 0; b < 32; ++b) d[b] = __ldg(col + b * sq);
#pragma unroll
            for (int b = 0; b < 32; ++b) {
              fr |= static_cast<uint32_t>(
                        d[b] == pack_level(s_level, cached, level, updated, stop, q0 + b))
                    << b;
              vis |= static_cast<uint32_t>(d[b] != -1) << b;
            }
          } else {
            for (int b = 0; b < nb; ++b) {
              const int d = __ldg(col + b * sq);
              fr |= static_cast<uint32_t>(
                        d == pack_level(s_level, cached, level, updated, stop, q0 + b))
                    << b;
              vis |= static_cast<uint32_t>(d != -1) << b;
            }
          }
          frontier[v * W + w] = fr;
          visited[v * W + w] = vis;
          hits[v * W + w] = 0u;
          any |= fr != 0u;
        }
      }
      ubits = __ballot_sync(kFullMask, any);
    } else {
      // Minor: the warp takes its 32 vertices kPackRows at a time, a lane a
      // query: each vertex's word is one coalesced load, all kPackRows in
      // flight together.
      ubits = 0u;
      const int count = static_cast<int>(min(32LL, n - base));
      for (int w = 0; w < W; ++w) {
        const int q = w * 32 + lane;
        const int lv = q < K ? pack_level(s_level, cached, level, updated, stop, q) : -2;
        for (int j0 = 0; j0 < count; j0 += kPackRows) {
          int d[kPackRows];
#pragma unroll
          for (int t = 0; t < kPackRows; ++t) {
            d[t] = q < K && j0 + t < count ? __ldg(dist + (base + j0 + t) * sv + q) : -1;
          }
#pragma unroll
          for (int t = 0; t < kPackRows; ++t) {
            const uint32_t fr = __ballot_sync(kFullMask, d[t] == lv);
            const uint32_t vis = __ballot_sync(kFullMask, d[t] != -1);
            const long long v = base + j0 + t;
            if (lane == 0 && j0 + t < count) {
              frontier[v * W + w] = fr;
              visited[v * W + w] = vis;
              hits[v * W + w] = 0u;
            }
            if (fr) ubits |= 1u << (j0 + t);
          }
        }
      }
    }
    if (lane == 0) umap[base >> 5] = ubits;
  }
}

// ---- walk -------------------------------------------------------------------

template <int W, int P>
__device__ __forceinline__ void or_frontier(uint32_t (&acc)[P],
                                            const uint32_t* frontier,
                                            long long c, int Wd, int w0,
                                            int nw) {
  if constexpr (W != 0) {
    uint32_t x[P];
    ldg_words<P>(x, frontier + c * W);
#pragma unroll
    for (int i = 0; i < P; ++i) acc[i] |= x[i];
  } else {
    const uint32_t* row = frontier + c * Wd + w0;
#pragma unroll
    for (int i = 0; i < P; ++i) {
      if (i < nw) acc[i] |= __ldg(row + i);
    }
  }
}

struct WalkArgs {
  const int* vrows;
  const int* cols;
  const uint32_t* frontier;
  const uint32_t* visited;
  uint32_t* hits;
  const uint32_t* s_mask;
  const uint32_t* map;  // the shared map, or the device map when shift < 0
  int shift;
  int Wd;
};

__device__ __forceinline__ bool in_map(const WalkArgs& a, int c) {
  if (a.shift < 0) return (__ldg(a.map + (c >> 5)) >> (c & 31)) & 1u;
  return (a.map[c >> (a.shift + 5)] >> ((c >> a.shift) & 31)) & 1u;
}

// One thread walks one whole short row, kShortSlots slots a step.
template <int W>
__device__ __forceinline__ void walk_short(const WalkArgs& a, long long r) {
  constexpr int P = W ? W : kPassWords;
  const int start = __ldg(a.vrows + 3 * r);
  const int end = __ldg(a.vrows + 3 * r + 1);
  const long long v = __ldg(a.vrows + 3 * r + 2);
  for (int w0 = 0; w0 < a.Wd; w0 += P) {
    const int nw = min(P, a.Wd - w0);
    uint32_t need[P], acc[P];
    if constexpr (W != 0) {
      ldg_words<P>(need, a.visited + v * W);
    } else {
#pragma unroll
      for (int i = 0; i < P; ++i) need[i] = i < nw ? __ldg(a.visited + v * a.Wd + w0 + i) : ~0u;
    }
    bool live = false;
#pragma unroll
    for (int i = 0; i < P; ++i) {
      need[i] = i < nw ? ~need[i] & a.s_mask[w0 + i] : 0u;
      acc[i] = 0u;
      live |= need[i] != 0u;
    }
    if (!live) continue;
    for (int s = start; s < end; s += kShortSlots) {
      int c[kShortSlots];
#pragma unroll
      for (int j = 0; j < kShortSlots; ++j) c[j] = s + j < end ? __ldg(a.cols + s + j) : -1;
#pragma unroll
      for (int j = 0; j < kShortSlots; ++j) {
        if (c[j] >= 0 && in_map(a, c[j])) or_frontier<W, P>(acc, a.frontier, c[j], a.Wd, w0, nw);
      }
      bool covered = true;
#pragma unroll
      for (int i = 0; i < P; ++i) covered &= (acc[i] & need[i]) == need[i];
      if (covered) break;
    }
#pragma unroll
    for (int i = 0; i < P; ++i) {
      const uint32_t out = acc[i] & need[i];
      if (out) a.hits[v * a.Wd + w0 + i] = out;
    }
  }
}

// One warp walks one piece [start, end) of row v, its lanes over the
// slots: every lane's kLongSlots cols loads go out together, then the
// frontier rows are read kRoundSlots a lane at a time, and the warp stops
// once its hits cover what the row can still gain (tested after a round
// that read something).
template <int W>
__device__ __forceinline__ void walk_piece(const WalkArgs& a, int start, int end,
                                           long long v, int lane) {
  constexpr int P = W ? W : kPassWords;
  for (int w0 = 0; w0 < a.Wd; w0 += P) {
    const int nw = min(P, a.Wd - w0);
    // What the row can still gain: unreached running queries that the
    // row's other pieces have not hit yet, one value for the warp (another
    // piece may OR into hits meanwhile).
    uint32_t need[P], acc[P];
    bool live = false;
#pragma unroll
    for (int i = 0; i < P; ++i) {
      need[i] = 0u;
      acc[i] = 0u;
      if (i < nw && lane == 0) {
        const long long at = v * a.Wd + w0 + i;
        need[i] = ~__ldg(a.visited + at) & a.s_mask[w0 + i] & ~__ldcg(a.hits + at);
      }
      need[i] = __shfl_sync(kFullMask, need[i], 0);
      live |= need[i] != 0u;
    }
    if (!live) continue;
    bool covered = false;
    for (int s = start; s < end && !covered; s += 32 * kLongSlots) {
      int c[kLongSlots];
#pragma unroll
      for (int j = 0; j < kLongSlots; ++j) {
        const int at = s + j * 32 + lane;
        c[j] = at < end ? __ldg(a.cols + at) : -1;
      }
#pragma unroll
      for (int j0 = 0; j0 < kLongSlots; j0 += kRoundSlots) {
        bool read = false;
#pragma unroll
        for (int j = j0; j < j0 + kRoundSlots; ++j) {
          if (c[j] >= 0 && in_map(a, c[j])) {
            or_frontier<W, P>(acc, a.frontier, c[j], a.Wd, w0, nw);
            read = true;
          }
        }
        if (s + (j0 + kRoundSlots) * 32 >= end) break;  // the piece's last slot is read
        if (!__any_sync(kFullMask, read)) continue;  // nothing new to test
        covered = true;
#pragma unroll
        for (int i = 0; i < P; ++i) {
          covered &= (__reduce_or_sync(kFullMask, acc[i]) & need[i]) == need[i];
        }
        if (covered) break;
      }
    }
#pragma unroll
    for (int i = 0; i < P; ++i) {
      const uint32_t out = __reduce_or_sync(kFullMask, acc[i]) & need[i];
      if (lane == 0 && out) atomicOr(a.hits + v * a.Wd + w0 + i, out);
    }
  }
}

// One warp takes up to kLongChunk pieces of long rows: a lane each reads a
// piece's range and tests its owner, then the warp walks the live ones.
template <int W>
__device__ __forceinline__ void walk_long(const WalkArgs& a, long long first,
                                          int count, int lane) {
  int start = 0, end = 0, v = 0;
  bool live = false;
  if (lane < count) {
    const long long r = first + lane;
    start = __ldg(a.vrows + 3 * r);
    end = __ldg(a.vrows + 3 * r + 1);
    v = __ldg(a.vrows + 3 * r + 2);
    for (int w = 0; w < a.Wd && !live; ++w) {
      const long long at = static_cast<long long>(v) * a.Wd + w;
      live = (~__ldg(a.visited + at) & a.s_mask[w] & ~__ldcg(a.hits + at)) != 0u;
    }
  }
  uint32_t todo = __ballot_sync(kFullMask, live);
  while (todo) {
    const int i = __ffs(todo) - 1;
    todo &= todo - 1u;
    walk_piece<W>(a, __shfl_sync(kFullMask, start, i), __shfl_sync(kFullMask, end, i),
                  __shfl_sync(kFullMask, v, i), lane);
  }
}

__host__ __device__ __forceinline__ long long walk_units(long long num_vrows,
                                                       long long num_short) {
  return ((num_short + 31) >> 5) + (num_vrows - num_short + kLongChunk - 1) / kLongChunk;
}

// Work units: a warp takes 32 short rows (a lane each) or kLongChunk long
// pieces.
template <int W>
__global__ void __launch_bounds__(kWalkThreads)
csr_walk_kernel(const int* __restrict__ vrows, long long num_vrows,
                long long num_short, const int* __restrict__ cols,
                const uint32_t* __restrict__ frontier,
                const uint32_t* __restrict__ visited,
                uint32_t* __restrict__ hits, const uint32_t* __restrict__ aux,
                const uint32_t* __restrict__ umap, long long n, int w_rt,
                int shift, const int* __restrict__ ctrl) {
  if (__ldcg(ctrl) == 0) return;
  const int Wd = W ? W : w_rt;
  extern __shared__ uint32_t s_walk[];
  uint32_t* const s_mask = s_walk;
  uint32_t* const s_map = s_walk + Wd;
  for (int w = threadIdx.x; w < Wd; w += blockDim.x) s_mask[w] = __ldcg(aux + w);
  if (shift >= 0) {
    // The device map folded: shared word i covers device words
    // [i << shift, (i + 1) << shift), 32 >> shift bits each.
    const long long words = (n + 31) >> 5;
    const long long folded = (words + (1LL << shift) - 1) >> shift;
    const int per = 1 << shift;
    for (long long i = threadIdx.x; i < folded; i += blockDim.x) {
      uint32_t word = 0u;
      if (shift == 1 && 2 * i + 1 < words) {  // a bit per two vertices: one load
        const uint2 x = __ldg(reinterpret_cast<const uint2*>(umap + 2 * i));
        word = fold_bits(x.x, 1) | fold_bits(x.y, 1) << 16;
      } else {
        for (int j = 0; j < per; ++j) {
          const long long g = (i << shift) + j;
          if (g < words) word |= fold_bits(__ldg(umap + g), shift) << (j * (32 >> shift));
        }
      }
      s_map[i] = word;
    }
  }
  __syncthreads();
  const WalkArgs a{vrows, cols, frontier, visited, hits, s_mask,
                   shift >= 0 ? s_map : umap, shift, Wd};
  const int lane = threadIdx.x & 31;
  const long long short_units = (num_short + 31) >> 5;
  const long long units = walk_units(num_vrows, num_short);
  const long long warps = static_cast<long long>(gridDim.x) * (blockDim.x >> 5);
  for (long long u = blockIdx.x * static_cast<long long>(blockDim.x >> 5) +
                     (threadIdx.x >> 5);
       u < units; u += warps) {
    if (u < short_units) {
      const long long r = (u << 5) + lane;
      if (r < num_short) walk_short<W>(a, r);
    } else {
      const long long first = num_short + (u - short_units) * kLongChunk;
      const long long left = num_vrows - first;
      walk_long<W>(a, first, left < kLongChunk ? static_cast<int>(left) : kLongChunk, lane);
    }
  }
}

// ---- apply ------------------------------------------------------------------

// The apply's tail, run by every block after its vertices: the block's
// found words go out, and the block that takes the last ticket (ctrl[2])
// folds them into updated/level, rewrites the mask and ctrl[0].
__device__ __forceinline__ void finish_apply(const uint32_t* s_found, int Wd, int K,
                                             int* level, int* updated, const int* stop,
                                             uint32_t* aux, int* ctrl) {
  __shared__ int s_last;
  const int lane = threadIdx.x & 31;
  __syncthreads();
  for (int w = threadIdx.x; w < Wd; w += blockDim.x) {
    if (s_found[w]) atomicOr(aux + Wd + w, s_found[w]);
  }
  // Last-block tail: this block's found bits are visible before it takes a
  // ticket; the block that takes the last one sees them all.
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    s_last = atomicAdd(ctrl + 2, 1) == static_cast<int>(gridDim.x) - 1;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  // Advance: every running query moves to the next level and keeps running
  // if it found something and its bound allows; the mask follows.
  int go = 0;
  for (int qb = 0; qb < 32 * Wd; qb += blockDim.x) {
    const int q = qb + threadIdx.x;
    bool run_next = false;
    if (q < K) {
      int up = __ldcg(updated + q);
      int lv = __ldcg(level + q);
      const int st = __ldcg(stop + q);
      if (up != 0 && lv < st) {
        up = static_cast<int>((__ldcg(aux + Wd + (q >> 5)) >> (q & 31)) & 1u);
        lv += 1;
        updated[q] = up;
        level[q] = lv;
      }
      run_next = up != 0 && lv < st;
    }
    const uint32_t word = __ballot_sync(kFullMask, run_next);
    if (lane == 0 && q < 32 * Wd) aux[q >> 5] = word;
    go |= run_next;
  }
  go = __syncthreads_or(go);  // also: every found word has been read
  for (int w = threadIdx.x; w < Wd; w += blockDim.x) aux[Wd + w] = 0u;
  if (threadIdx.x == 0) {
    ctrl[0] = go;
    ctrl[2] = 0;
  }
}

template <int W>
__global__ void __launch_bounds__(msbfs::kThreads)
csr_apply_kernel(int* __restrict__ dist, long long sq, long long sv,
                 int* __restrict__ level, int* __restrict__ updated,
                 const int* __restrict__ stop, uint32_t* __restrict__ frontier,
                 uint32_t* __restrict__ visited, uint32_t* __restrict__ hits,
                 uint32_t* __restrict__ aux, uint32_t* __restrict__ umap,
                 long long n, int K, int w_rt, int* __restrict__ ctrl) {
  if (__ldcg(ctrl) == 0) return;
  constexpr int P = W ? W : 1;
  const int Wd = W ? W : w_rt;
  extern __shared__ uint32_t s_apply[];
  uint32_t* const s_mask = s_apply;
  uint32_t* const s_found = s_apply + Wd;
  // level + 1 of each query (fixed widths; the generic one reads level).
  __shared__ int s_next[32 * P];
  if constexpr (W != 0) {
    for (int q = threadIdx.x; q < 32 * W; q += blockDim.x) {
      s_next[q] = q < K ? __ldcg(level + q) + 1 : 0;
    }
  }
  for (int w = threadIdx.x; w < Wd; w += blockDim.x) {
    s_mask[w] = __ldcg(aux + w);
    s_found[w] = 0u;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const bool rows = sv == 1;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long base = blockIdx.x * static_cast<long long>(blockDim.x) +
                        (threadIdx.x & ~31);
       base < n; base += stride) {
    const long long v = base + lane;
    const bool valid = v < n;
    bool any = false;
    for (int w0 = 0; w0 < Wd; w0 += P) {
      uint32_t h[P];
#pragma unroll
      for (int i = 0; i < P; ++i) h[i] = 0u;
      if (valid) {
        const uint32_t* src = hits + v * Wd + w0;
        if constexpr (P % 4 == 0) {
#pragma unroll
          for (int i = 0; i < P; i += 4) {
            const uint4 x = *reinterpret_cast<const uint4*>(src + i);
            h[i] = x.x; h[i + 1] = x.y; h[i + 2] = x.z; h[i + 3] = x.w;
          }
        } else if constexpr (P == 2) {
          const uint2 x = *reinterpret_cast<const uint2*>(src);
          h[0] = x.x; h[1] = x.y;
        } else {
          h[0] = src[0];
        }
      }
      uint32_t fresh[P];
#pragma unroll
      for (int i = 0; i < P; ++i) {
        fresh[i] = 0u;
        if (h[i]) {
          const long long at = v * Wd + w0 + i;
          hits[at] = 0u;  // the plane is zero again for the next level
          const uint32_t vis = visited[at];
          fresh[i] = h[i] & ~vis & s_mask[w0 + i];
          if (fresh[i]) visited[at] = vis | fresh[i];
        }
        any |= fresh[i] != 0u;
      }
      if (valid) {
        uint32_t* dst = frontier + v * Wd + w0;
        if constexpr (P % 4 == 0) {
#pragma unroll
          for (int i = 0; i < P; i += 4) {
            *reinterpret_cast<uint4*>(dst + i) =
                make_uint4(fresh[i], fresh[i + 1], fresh[i + 2], fresh[i + 3]);
          }
        } else if constexpr (P == 2) {
          *reinterpret_cast<uint2*>(dst) = make_uint2(fresh[0], fresh[1]);
        } else {
          dst[0] = fresh[0];
        }
      }
#pragma unroll
      for (int i = 0; i < P; ++i) {
        uint32_t bits = __reduce_or_sync(kFullMask, fresh[i]);
        if (bits == 0u) continue;
        if (lane == 0) atomicOr(s_found + w0 + i, bits);
        const int q0 = (w0 + i) * 32;
        if (rows) {
          // A query at a time over the warp: its lanes' stores side by side.
          while (bits) {
            const int b = __ffs(bits) - 1;
            bits &= bits - 1u;
            if ((fresh[i] >> b) & 1u) {
              const int q = q0 + b;
              const int next = W ? s_next[q] : __ldcg(level + q) + 1;
              dist[static_cast<long long>(q) * sq + v] = next;
            }
          }
        } else {
          // A vertex at a time over the warp: lane b stores query q0 + b
          // of that vertex's row, one coalesced store a word.
          const int q = q0 + lane;
          uint32_t who = __ballot_sync(kFullMask, fresh[i] != 0u);
          while (who) {
            const int j = __ffs(who) - 1;
            who &= who - 1u;
            const uint32_t word = __shfl_sync(kFullMask, fresh[i], j);
            if ((word >> lane) & 1u) {
              const int next = W ? s_next[q] : __ldcg(level + q) + 1;
              dist[(base + j) * sv + q] = next;
            }
          }
        }
      }
    }
    const uint32_t ubits = __ballot_sync(kFullMask, any);
    if (lane == 0) umap[base >> 5] = ubits;
  }
  finish_apply(s_found, Wd, K, level, updated, stop, aux, ctrl);
}

struct Level {
  const int* vrows;
  long long num_vrows;
  long long num_short;
  const int* cols;
  int* dist;
  long long n;
  int K;
  long long sq;
  long long sv;
  int* level;
  int* updated;
  const int* stop;
  uint32_t* frontier;
  uint32_t* visited;
  uint32_t* hits;
  uint32_t* aux;
  uint32_t* umap;
  int W;
  int shift;
  int* ctrl;
};

template <int W>
cudaError_t launch_phase(int device, int phase, const Level& L,
                         cudaStream_t s) {
  if (phase == kPhaseWalk) {
    static int allowed[msbfs::kMaxDevices] = {};
    long long folded = 0;
    if (L.shift >= 0) {
      folded = (((L.n + 31) >> 5) + (1LL << L.shift) - 1) >> L.shift;
    }
    const int smem = static_cast<int>((L.W + folded) * sizeof(uint32_t));
    cudaError_t err = msbfs::allow_smem(csr_walk_kernel<W>, smem, allowed, device);
    if (err != cudaSuccess) return err;
    // Persistent blocks: as many as fit the card at once (at least
    // kWalkBlocksPerSm an SM by the map's size), so that the static
    // grid-stride share of every warp runs together.
    int sms = 0, per_sm = 0;
    err = msbfs::sm_count(device, &sms);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, csr_walk_kernel<W>, kWalkThreads, smem);
    if (err != cudaSuccess) return err;
    const long long units = walk_units(L.num_vrows, L.num_short);
    const long long warps = kWalkThreads / 32;
    long long blocks = (units + warps - 1) / warps;
    const long long most = static_cast<long long>(sms) * (per_sm > 1 ? per_sm : 1);
    blocks = blocks < 1 ? 1 : blocks > most ? most : blocks;
    csr_walk_kernel<W><<<static_cast<int>(blocks), kWalkThreads, smem, s>>>(
        L.vrows, L.num_vrows, L.num_short, L.cols, L.frontier, L.visited,
        L.hits, L.aux, L.umap, L.n, L.W, L.shift, L.ctrl);
  } else {
    const size_t smem = 2 * static_cast<size_t>(L.W) * sizeof(uint32_t);
    csr_apply_kernel<W><<<msbfs::grid_for(L.n, msbfs::kThreads),
                          msbfs::kThreads, smem, s>>>(
        L.dist, L.sq, L.sv, L.level, L.updated, L.stop, L.frontier, L.visited,
        L.hits, L.aux, L.umap, L.n, L.K, L.W, L.ctrl);
  }
  return cudaGetLastError();
}

}  // namespace

// One launch of a level on the carry's planes (frontier, visited, hits:
// (n, W) words; aux: 2W words; umap: ceil(n / 32) words).  phase: 1 pack
// (rebuild the planes from dist, for a stale carry), 2 walk, 4 apply.
// dist[q, v] is at q * sq + v * sv: sv == 1 the row layout, else the
// query-minor one (sq == 1, K <= 4096).  shift: the walk's shared map
// holds a bit per 2^shift vertices (0..5), or -1: it reads umap itself.
extern "C" int msbfs_csr_pull(int device, int phase, const void* vrows,
                              long long num_vrows, long long num_short,
                              const void* cols, void* dist, long long n, int K,
                              long long sq, long long sv, void* level,
                              void* updated, const void* stop, void* frontier,
                              void* visited, void* hits, void* aux, void* umap,
                              int W, int shift, void* ctrl, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool minor = sv != 1;
  if (n < 0 || n >= (1LL << 31) || K < 1 || K > 65535 || W != (K + 31) / 32 ||
      (minor && (sq != 1 || K > 4096)) || shift < -1 || shift > 5 ||
      num_short < 0 || num_vrows < num_short ||
      (phase != kPhasePack && phase != kPhaseWalk && phase != kPhaseApply)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Level L{static_cast<const int*>(vrows), num_vrows, num_short,
                static_cast<const int*>(cols), static_cast<int*>(dist), n, K,
                sq, sv, static_cast<int*>(level), static_cast<int*>(updated),
                static_cast<const int*>(stop), static_cast<uint32_t*>(frontier),
                static_cast<uint32_t*>(visited), static_cast<uint32_t*>(hits),
                static_cast<uint32_t*>(aux), static_cast<uint32_t*>(umap), W,
                shift, static_cast<int*>(ctrl)};
  if (phase == kPhasePack) {
    const size_t smem = static_cast<size_t>(K < kPackLevels ? K : kPackLevels) * sizeof(int);
    csr_pack_kernel<<<msbfs::grid_for(n, msbfs::kThreads), msbfs::kThreads, smem, s>>>(
        L.dist, sq, sv, L.level, L.updated, L.stop, L.frontier, L.visited, L.hits,
        L.aux, L.umap, n, K, W, L.ctrl);
    return static_cast<int>(cudaGetLastError());
  }
  switch (W) {
    case 1: err = launch_phase<1>(device, phase, L, s); break;
    case 2: err = launch_phase<2>(device, phase, L, s); break;
    case 4: err = launch_phase<4>(device, phase, L, s); break;
    case 8: err = launch_phase<8>(device, phase, L, s); break;
    default: err = launch_phase<0>(device, phase, L, s);
  }
  return static_cast<int>(err);
}

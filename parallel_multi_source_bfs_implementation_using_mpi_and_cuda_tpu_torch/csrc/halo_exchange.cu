// The halo exchange of the vertex-sharded engines: H1, H2 and H3.
//
// Replaces three XLA chains of the JAX package's parallel/ modules, each
// built there from byte lanes (unpack the words to 0/1 bytes, scatter-max,
// re-pack) so that colliding writers make an OR.  atomicOr on 32-bit words
// is that OR, so no byte-lane buffer is made here.
//
// H1 halo_pair_or — sharded_bell.py:444-448 ``rebuild_planes``, the
//   landing of the boundary pairs at their owner in push_sharded.py:176-183,
//   and the 2D mesh's sparse wire decode, partition2d.py:323
//   ``decode_words_sparse`` (its row gather :654 ``_sparse_row_gather``):
//     for every segment s (at most kMaxSegments a launch) and every pair
//     (id, words[W]) of it with 0 <= id - lo_s < rows_s:
//       plane[base_s + id - lo_s] |= words
//   Duplicate ids are allowed, within a segment and across segments; an id
//   outside its segment's rows (the sentinel) drops, so a segment's
//   sentinel never lands on the next segment's first row — the aliasing
//   that JAX re-clamps after rebasing (partition2d.py:667-669).  The 2D
//   mesh's gathers land all their segments in one launch: a col block's R
//   row segments, or a col leg's C peers' chunks.  Gated on the device
//   control when ``ctrl`` is given.  The segment table travels in the
//   launch's parameters and each block copies it to shared memory.
//
// H2 halo_push_or — sharded_bell.py:350 ``_push_own_hits`` with its match
//   (:455-466): every gathered pair's in-block push-CSR row (sources sorted
//   ascending, ``build_push_halo``) walked and the pair's words ORed into the
//   own block's hit rows; two launches.
//   The match (``msbfs_halo_push_match``), a thread a pair: an id outside
//   [first source, last source] (the sentinel n_pad) is dropped before any
//   search; the others search the sources' first levels in shared memory
//   (a table of kSplit evenly spaced sources a block, loaded once) and the
//   rest, at most m / kSplit + 1 entries, in device memory, a thread's
//   kMatchItems pairs in flight together.  It writes each pair's (st, deg)
//   (deg 0 unmatched), the exclusive prefix ``pos`` of deg (the pair's first
//   edge in the flat edge space) by the decoupled look-back of
//   ordered_scan.cuh (tiles of kMatchTile pairs by ticket), and the total
//   (int64), which the engine's one stacked read a level takes for the
//   route decision (JAX's ``edges_needed <= push_budget``).
//   The push (``msbfs_halo_push_or``), a thread an edge over the flat edge
//   space (JAX's cumsum / cummax owner map): edge j's owner is the last
//   pair with pos <= j, found in a table of kSplit sampled prefixes in
//   shared memory and then a few device loads; unmatched pairs own no edge
//   and are never visited.  The pair's words are ORed (atomicOr) into the
//   edge's own hit row.  Its grid follows the edge count the host read; the
//   loop bound is the device's total.
//
// H3 owner_push_expand — push_sharded.py:131-175 ``_push_level``: the own
//   queue's rows of the (block + 1, width) own-row table (global ids,
//   sentinel n_pad), in-block neighbours ORed into the own hit rows,
//   out-of-block ones compacted in slot order (queue entry i, column d, slot
//   i * width + d) into at most ``bnd`` (dst, words) boundary pairs, the rest
//   of the pair buffers cleared to (n_pad, 0); the boundary slots' count in
//   full, and its running maximum in ``peak``.  The order is JAX's: after a
//   truncated level the kept pairs decide the next levels, whose peaks decide
//   the capacity protocol's rerun.  The slots spread over the card: a grid
//   of kExpandBlocksPerSm blocks an SM (the listed count lives on the
//   device, so the grid cannot follow it) takes tiles of kExpandTile slots
//   by ticket, each thread kExpandItems consecutive slots; the boundary
//   pairs are placed by the decoupled look-back of ordered_scan.cuh.  The tile that
//   holds the last slot (the first ticket when there is none) writes the
//   count, the peak and the sentinels (on a long run of them, a few blocks
//   write them after their last tile).  One launch a call.
//
// Bound: bytes.  H1 reads each pair and writes its row's words (its body
// sits at the launch floor: 0.0055-0.0060 ms against a 0.00005 ms bound on
// the widest rebuild, NVIDIA H100 80GB HBM3, 700 W, chip_smoke.py, so the
// 2D mesh's gathers save launches, not bytes); H2's match
// reads each pair's id, a matched pair's search path, CSR entry and writes
// its (st, deg, pos), its push a matched pair's entry, each edge's slot and
// the owner's words, and writes a row's words an edge.  Its parent gave a
// warp to each pair, sentinels included, and lane 0 searched while 31
// waited (0.029 ms on the widest push of RMAT-20's vertex-sharded forest,
// 16,384 pairs of which 1,233 matched, against a 0.0001 ms bound; NVIDIA
// H100 80GB HBM3, 700 W, chip_smoke.py), and the route decision repeated
// the search as about seven torch launches a shard; H3 reads the listed rows' table rows and words, writes the reached
// hit words and the pairs.  H3's old single block of 1024 threads walked
// the slots a tile at a time on one SM (0.286-0.499 ms on road-1024's
// widest level against a 0.000634 ms bound, NVIDIA H100 80GB HBM3, 700 W,
// chip_compare.py); spread over the card it takes 0.015-0.017 ms, and a
// thin level's chain of dependent reads (count, ticket, queue, table,
// frontier) twice the 0.0055 ms launch floor.
#include <climits>

#include "msbfs_common.cuh"
#include "ordered_scan.cuh"

namespace {

constexpr int kExpandThreads = 256;
// Consecutive slots a thread takes a tile.
constexpr int kExpandItems = 2;
constexpr int kExpandTile = kExpandThreads * kExpandItems;
constexpr int kExpandBlocksPerSm = 2;

constexpr int kMaxSegments = 16;

// H1's segments: pair lists, their first items in the launch's item space
// (pairs * W, prefix summed), id offsets, destination rows and row counts.
struct Segments {
  const int* ids[kMaxSegments];
  const uint32_t* words[kMaxSegments];
  long long first[kMaxSegments + 1];
  long long lo[kMaxSegments];
  long long base[kMaxSegments];
  long long rows[kMaxSegments];
};

__global__ void __launch_bounds__(msbfs::kThreads)
pair_or_kernel(const Segments segs, int nseg, int W, uint32_t* __restrict__ plane,
               const int* __restrict__ ctrl, int max_levels) {
  if (ctrl != nullptr && !msbfs::level_go(ctrl, max_levels)) return;
  __shared__ Segments s;
  if (threadIdx.x == 0) s = segs;
  __syncthreads();
  const long long items = s.first[nseg];
  int seg = 0;
  for (long long t = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       t < items; t += static_cast<long long>(gridDim.x) * blockDim.x) {
    while (t >= s.first[seg + 1]) ++seg;  // t only grows
    const long long local = t - s.first[seg];
    const long long i = W == 1 ? local : local / W;
    const long long r = static_cast<long long>(__ldg(s.ids[seg] + i)) - s.lo[seg];
    if (r < 0 || r >= s.rows[seg]) continue;
    const uint32_t x = __ldg(s.words[seg] + local);
    if (x) atomicOr(plane + (s.base[seg] + r) * W + (local - i * W), x);
  }
}

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kMatchThreads = 256;
// Consecutive pairs a thread takes a tile (their searches in flight
// together).
constexpr int kMatchItems = 4;
constexpr long long kMatchTile = kMatchThreads * kMatchItems;
constexpr int kMatchBlocksPerSm = 2;
// Sampled sources (the match) or prefixes (the push) a block keeps in
// shared memory: the first log2(kSplit) levels of every search.
constexpr int kSplit = 2048;

// Index of sample k of an ascending array of ``m`` entries.
__device__ __forceinline__ long long sample_at(int k, long long m) {
  return m <= kSplit ? k : static_cast<long long>(k) * m / kSplit;
}

// The samples of ``a`` (m entries) into ``split``; their count.
__device__ __forceinline__ int load_samples(const int* a, long long m, int* split) {
  const int ns = static_cast<int>(m < kSplit ? m : kSplit);
  for (int k = threadIdx.x; k < ns; k += blockDim.x) split[k] = __ldg(a + sample_at(k, m));
  __syncthreads();
  return ns;
}

// Samples with a value <= x (split ascending).
__device__ __forceinline__ int count_le(const int* split, int ns, long long x) {
  int lo = 0, hi = ns;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (split[mid] <= x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(kMatchThreads)
push_match_kernel(const int* __restrict__ ids, long long pairs,
                  const int* __restrict__ src_ids, const int* __restrict__ src_start,
                  const int* __restrict__ src_cnt, long long m, int* __restrict__ st,
                  int* __restrict__ deg, int* __restrict__ pos, long long* __restrict__ total,
                  unsigned long long* __restrict__ scratch, long long tiles, unsigned epoch) {
  namespace scan = msbfs::scan;
  __shared__ scan::TileShared sh;
  __shared__ int split[kSplit];
  const int ns = load_samples(src_ids, m, split);
  const long long last = m > 0 ? __ldg(src_ids + m - 1) : -1;
  unsigned long long* ticket = scratch;
  unsigned long long* status = scratch + scan::kHeader;
  long long t;
  while ((t = scan::next_tile(ticket, sh)) < tiles) {
    const long long i0 = t * kMatchTile + static_cast<long long>(threadIdx.x) * kMatchItems;
    int id[kMatchItems];
    long long lo[kMatchItems], hi[kMatchItems];
    bool hit[kMatchItems];  // a probe (or the sample) read id at lo
#pragma unroll
    for (int k = 0; k < kMatchItems; ++k) {
      id[k] = i0 + k < pairs ? __ldg(ids + i0 + k) : -1;
      lo[k] = hi[k] = 0;
      hit[k] = false;
      if (ns > 0 && id[k] >= split[0] && id[k] <= last) {
        // Sample c - 1 <= id < sample c: a match lies in [sample c - 1,
        // sample c), and is that sample when it equals id.
        const int c = count_le(split, ns, id[k]);
        const long long a = sample_at(c - 1, m);
        if (split[c - 1] == id[k]) {
          lo[k] = hi[k] = a;
          hit[k] = true;
        } else {
          lo[k] = a + 1;
          hi[k] = c < ns ? sample_at(c, m) : m;
        }
      }
    }
    // The first entry >= id in [lo, hi), every item's probes together; the
    // entry an item ends on was probed last at hi, so its value is known.
    // The warp loops until its last lane is done, so that it reaches the
    // tile's scan converged (its shuffles read every lane).
    bool more = true;
    while (__any_sync(kFullMask, more)) {
      more = false;
#pragma unroll
      for (int k = 0; k < kMatchItems; ++k) {
        if (lo[k] < hi[k]) {
          const long long mid = (lo[k] + hi[k]) >> 1;
          const int x = __ldg(src_ids + mid);
          if (x < id[k]) {
            lo[k] = mid + 1;
          } else {
            hi[k] = mid;
            hit[k] = x == id[k];
          }
          more |= lo[k] < hi[k];
        }
      }
    }
    int d[kMatchItems], s[kMatchItems];
    unsigned edges = 0;
#pragma unroll
    for (int k = 0; k < kMatchItems; ++k) {
      d[k] = s[k] = 0;
      if (hit[k]) {
        s[k] = __ldg(src_start + lo[k]);
        d[k] = __ldg(src_cnt + lo[k]);
      }
      edges += static_cast<unsigned>(d[k]);
    }
    __syncwarp();
    const unsigned long long before =
        scan::place_tile<kMatchThreads>(edges, t, epoch, status, sh);
    unsigned at = sh.excl + static_cast<uint32_t>(before);
#pragma unroll
    for (int k = 0; k < kMatchItems; ++k) {
      if (i0 + k < pairs) {
        st[i0 + k] = s[k];
        deg[i0 + k] = d[k];
        pos[i0 + k] = static_cast<int>(at);
      }
      at += static_cast<unsigned>(d[k]);
    }
    if (t == tiles - 1 && threadIdx.x == 0) {
      *total = static_cast<long long>(sh.excl) + static_cast<uint32_t>(sh.agg);
    }
  }
  scan::release_ticket(ticket, t, tiles);
}

__global__ void __launch_bounds__(msbfs::kThreads)
push_spread_kernel(const uint32_t* __restrict__ words, long long pairs, int W,
                   const int* __restrict__ st, const int* __restrict__ pos,
                   const long long* __restrict__ total, const int* __restrict__ vals,
                   uint32_t* __restrict__ hits, long long block) {
  __shared__ int split[kSplit];
  const int ns = load_samples(pos, pairs, split);
  const long long edges = __ldcg(total);
  for (long long j = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; j < edges;
       j += static_cast<long long>(gridDim.x) * blockDim.x) {
    // The owner: the last pair with pos <= j (pos[0] = 0, and a pair with
    // no edge shares its pos with the next, so the last such pair owns j).
    const int c = count_le(split, ns, j);
    long long lo = sample_at(c - 1, pairs);
    long long hi = c < ns ? sample_at(c, pairs) : pairs;
    int first = split[c - 1];
    while (hi - lo > 1) {
      const long long mid = (lo + hi) >> 1;
      const int x = __ldg(pos + mid);
      if (x <= j) {
        lo = mid;
        first = x;
      } else {
        hi = mid;
      }
    }
    const long long v = __ldg(vals + __ldg(st + lo) + (j - first));
    if (v < 0 || v >= block) continue;
    for (int w = 0; w < W; ++w) {
      const uint32_t x = __ldg(words + lo * W + w);
      if (x) atomicOr(hits + v * W + w, x);
    }
  }
}

// (n_pad, 0) over boundary slots [first, bnd): thread ``me`` of ``stride``.
__device__ __forceinline__ void fill_sentinels(long long first, long long bnd, int W,
                                               long long n_pad, int* bnd_ids,
                                               uint32_t* bnd_words, long long me,
                                               long long stride) {
  for (long long at = first + me; at < bnd; at += stride) bnd_ids[at] = static_cast<int>(n_pad);
  for (long long e = first * W + me; e < bnd * W; e += stride) bnd_words[e] = 0u;
}

// H3's finalizer, every thread of its block: the count, its peak, and the
// sentinels itself or the first sentinel slot published to the helpers.
__device__ __forceinline__ void finish_expand(long long total, long long bnd, int W,
                                              long long n_pad, int* bnd_ids,
                                              uint32_t* bnd_words, int* bcount, int* peak,
                                              unsigned long long* published, unsigned epoch,
                                              long long helpers) {
  const long long first = min(total, bnd);
  if (threadIdx.x == 0) {
    const int b = static_cast<int>(min(total, static_cast<long long>(INT_MAX)));
    *bcount = b;
    atomicMax(peak, b);
    if (helpers) {
      msbfs::scan::store_word(published, msbfs::scan::status_word(
                                             epoch, msbfs::scan::kPrefix,
                                             static_cast<uint32_t>(first)));
    }
  }
  if (!helpers) fill_sentinels(first, bnd, W, n_pad, bnd_ids, bnd_words, threadIdx.x, blockDim.x);
}

__global__ void __launch_bounds__(kExpandThreads)
owner_expand_kernel(const int* __restrict__ table, int width,
                    const int* __restrict__ queue, long long cap,
                    const int* __restrict__ count,
                    const uint32_t* __restrict__ frontier, int W,
                    uint32_t* __restrict__ hits, long long block, long long lo,
                    long long n_pad, int* __restrict__ bnd_ids,
                    uint32_t* __restrict__ bnd_words, long long bnd,
                    int* __restrict__ bcount, int* __restrict__ peak,
                    const int* __restrict__ ctrl, int max_levels,
                    unsigned long long* __restrict__ scratch, unsigned epoch) {
  namespace scan = msbfs::scan;
  if (!msbfs::level_go(ctrl, max_levels)) return;
  __shared__ scan::TileShared sh;
  unsigned long long* ticket = scratch;
  unsigned long long* published = scratch + 1;
  unsigned long long* status = scratch + scan::kHeader;
  const long long listed = min(static_cast<long long>(__ldcg(count)), cap);
  const long long slots = listed * width;
  const long long tiles = (slots + kExpandTile - 1) / kExpandTile;
  const long long helpers = scan::sentinel_helpers(bnd * (1 + W));
  long long t;
  while ((t = scan::next_tile(ticket, sh)) < tiles) {
    const long long s0 = t * kExpandTile + static_cast<long long>(threadIdx.x) * kExpandItems;
    // The thread's slots in three rounds of independent loads (queue
    // entries, table entries, frontier words), so a slot's chain of three
    // dependent reads is paid once a tile, not once a slot.
    int u[kExpandItems];
    int v[kExpandItems];
#pragma unroll
    for (int k = 0; k < kExpandItems; ++k) {
      const long long s = s0 + k;
      u[k] = s < slots ? __ldg(queue + s / width) : 0;
    }
#pragma unroll
    for (int k = 0; k < kExpandItems; ++k) {
      const long long s = s0 + k;
      v[k] = s < slots ? __ldg(table + static_cast<long long>(u[k]) * width + s % width)
                       : static_cast<int>(n_pad);
    }
    unsigned flags = 0;
#pragma unroll
    for (int k = 0; k < kExpandItems; ++k) {
      if (v[k] >= n_pad) continue;
      const long long local = v[k] - lo;
      if (local >= 0 && local < block) {
        for (int c = 0; c < W; ++c) {
          const uint32_t x = __ldg(frontier + static_cast<long long>(u[k]) * W + c);
          if (x) atomicOr(hits + local * W + c, x);
        }
      } else {
        flags |= 1u << k;
      }
    }
    const unsigned long long before =
        scan::place_tile<kExpandThreads>(__popc(flags), t, epoch, status, sh);
    long long at = static_cast<long long>(sh.excl) + static_cast<uint32_t>(before);
#pragma unroll
    for (int k = 0; k < kExpandItems; ++k) {
      if (!((flags >> k) & 1u)) continue;
      if (at < bnd) {
        bnd_ids[at] = v[k];
        for (int c = 0; c < W; ++c) {
          bnd_words[at * W + c] = __ldg(frontier + static_cast<long long>(u[k]) * W + c);
        }
      }
      ++at;
    }
    if (t == tiles - 1) {
      finish_expand(static_cast<long long>(sh.excl) + static_cast<uint32_t>(sh.agg), bnd, W,
                    n_pad, bnd_ids, bnd_words, bcount, peak, published, epoch, helpers);
    }
  }
  if (tiles == 0 && t == 0) {
    finish_expand(0, bnd, W, n_pad, bnd_ids, bnd_words, bcount, peak, published, epoch,
                  helpers);
  }
  scan::release_ticket(ticket, t, tiles);
  // Past kFinalizerSentinels, helpers write the sentinels (n_pad, 0) over
  // [min(total, bnd), bnd).
  const long long first = scan::sentinel_start(published, t - tiles, helpers, epoch, sh);
  if (first < 0) return;
  fill_sentinels(first, bnd, W, n_pad, bnd_ids, bnd_words,
                 (t - tiles) * kExpandThreads + threadIdx.x, helpers * kExpandThreads);
}

}  // namespace

// H1.  ids (pairs,) int32, words (pairs, W) uint32, plane (rows, W);
// ctrl may be null (ungated).
// H1.  segs: ``nseg`` (1 to kMaxSegments) host rows of six int64 — ids,
// words (device pointers), pairs, lo, base, rows — each landing its pairs
// (ids int32, words (pairs, W) uint32) in plane rows [base, base + rows)
// of ``plane`` (int32 rows of W words).
extern "C" int msbfs_halo_pair_or(int device, const long long* segs, int nseg, int W,
                                  void* plane, const void* ctrl, int max_levels,
                                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (W < 1 || nseg < 1 || nseg > kMaxSegments || plane == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Segments s{};
  s.first[0] = 0;
  for (int i = 0; i < nseg; ++i) {
    const long long* row = segs + 6 * i;
    const long long pairs = row[2], base = row[4], rows = row[5];
    if (pairs < 0 || base < 0 || rows < 0 || (base + rows) * W >= (1LL << 31) ||
        (pairs > 0 && (row[0] == 0 || row[1] == 0))) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    s.ids[i] = reinterpret_cast<const int*>(row[0]);
    s.words[i] = reinterpret_cast<const uint32_t*>(row[1]);
    s.first[i + 1] = s.first[i] + pairs * W;
    s.lo[i] = row[3];
    s.base[i] = base;
    s.rows[i] = rows;
  }
  for (int i = nseg + 1; i <= kMaxSegments; ++i) s.first[i] = s.first[nseg];
  const long long items = s.first[nseg];
  if (items == 0) return static_cast<int>(cudaSuccess);
  pair_or_kernel<<<msbfs::grid_for(items, msbfs::kThreads), msbfs::kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      s, nseg, W, static_cast<uint32_t*>(plane), static_cast<const int*>(ctrl), max_levels);
  return static_cast<int>(cudaGetLastError());
}

// H2's match.  ids (pairs,) int32; the in-block push CSR of one shard:
// src_ids (m,) ascending, src_start and src_cnt (m,); writes st, deg, pos
// (pairs,) int32 and total (1,) int64.  The pairs' edges must stay below
// 2^31 (so they do when the ids are distinct: each shard's own rows).
// scratch: 2 + 2 * max(1, ceil(pairs / kMatchTile)) int64 of
// ordered_scan.cuh, ``epoch`` in [1, 2^30), new for every launch on it.
extern "C" int msbfs_halo_push_match(int device, const void* ids, long long pairs,
                                     const void* src_ids, const void* src_start,
                                     const void* src_cnt, long long m, void* st, void* deg,
                                     void* pos, void* total, void* scratch, unsigned epoch,
                                     void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (pairs < 0 || pairs >= (1LL << 31) || m < 0 || m >= (1LL << 31) || total == nullptr ||
      scratch == nullptr || epoch == 0 || epoch >= msbfs::scan::kEpochs) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int sms = 0;
  err = msbfs::sm_count(device, &sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  // At least one tile, so that the total is written when there is no pair.
  const long long tiles = pairs > 0 ? (pairs + kMatchTile - 1) / kMatchTile : 1;
  const long long most = static_cast<long long>(sms) * kMatchBlocksPerSm;
  push_match_kernel<<<static_cast<int>(tiles < most ? tiles : most), kMatchThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(ids), pairs, static_cast<const int*>(src_ids),
      static_cast<const int*>(src_start), static_cast<const int*>(src_cnt), m,
      static_cast<int*>(st), static_cast<int*>(deg), static_cast<int*>(pos),
      static_cast<long long*>(total), static_cast<unsigned long long*>(scratch), tiles, epoch);
  return static_cast<int>(cudaGetLastError());
}

// H2's push.  words (pairs, W) uint32; st and pos (pairs,) int32 and total
// (1,) int64 from the match; vals the push CSR's block-local rows; hits
// (block, W).  ``edges``: the host's count of the total, which sizes the
// grid only (the loop runs to the device's total).
extern "C" int msbfs_halo_push_or(int device, const void* words, long long pairs, int W,
                                  const void* st, const void* pos, const void* total,
                                  long long edges, const void* vals, void* hits,
                                  long long block, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (W < 1 || pairs < 0 || pairs >= (1LL << 31) || edges < 0 || block < 0 ||
      block * W >= (1LL << 31) || total == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (pairs == 0) return static_cast<int>(cudaSuccess);
  push_spread_kernel<<<msbfs::grid_for(edges, msbfs::kThreads), msbfs::kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), pairs, W, static_cast<const int*>(st),
      static_cast<const int*>(pos), static_cast<const long long*>(total),
      static_cast<const int*>(vals), static_cast<uint32_t*>(hits), block);
  return static_cast<int>(cudaGetLastError());
}

// H3.  table (block + 1, width) int32 global ids; queue (cap,) and count
// (1,) from the own frontier's row queue; frontier and hits (block, W);
// bnd_ids (bnd,) int32 and bnd_words (bnd, W); bcount and peak (1,) int32;
// scratch: 2 + ceil(cap * width / kExpandTile) int64 of ordered_scan.cuh,
// ``epoch`` in [1, 2^30), new for every launch on that scratch.
extern "C" int msbfs_owner_push_expand(int device, const void* table, int width,
                                       const void* queue, long long cap,
                                       const void* count, const void* frontier, int W,
                                       void* hits, long long block, long long lo,
                                       long long n_pad, void* bnd_ids, void* bnd_words,
                                       long long bnd, void* bcount, void* peak,
                                       const void* ctrl, int max_levels, void* scratch,
                                       unsigned epoch, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (W < 1 || width < 1 || cap < 0 || bnd < 0 || block < 0 || n_pad < block ||
      n_pad >= (1LL << 31) || (block + 1) * width >= (1LL << 31) || cap * width >= (1LL << 31) ||
      ctrl == nullptr || scratch == nullptr || epoch == 0 || epoch >= msbfs::scan::kEpochs) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int sms = 0;
  err = msbfs::sm_count(device, &sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  owner_expand_kernel<<<sms * kExpandBlocksPerSm, kExpandThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(table), width, static_cast<const int*>(queue), cap,
      static_cast<const int*>(count), static_cast<const uint32_t*>(frontier), W,
      static_cast<uint32_t*>(hits), block, lo, n_pad, static_cast<int*>(bnd_ids),
      static_cast<uint32_t*>(bnd_words), bnd, static_cast<int*>(bcount),
      static_cast<int*>(peak), static_cast<const int*>(ctrl), max_levels,
      static_cast<unsigned long long*>(scratch), epoch);
  return static_cast<int>(cudaGetLastError());
}

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
// H2 halo_push_or — sharded_bell.py:350 ``_push_own_hits``: every gathered
//   pair's in-block push-CSR row (sources sorted ascending, ``build_push_halo``)
//   is walked and the pair's words ORed into the own block's hit rows.  A warp
//   a pair: lane 0 finds the source by binary search, the lanes share its
//   edges.
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
// 2D mesh's gathers save launches, not bytes); H2 reads
// each pair, its source's CSR entry and edges, and writes a row's words an
// edge; H3 reads the listed rows' table rows and words, writes the reached
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

__global__ void push_or_pairs_kernel(const int* __restrict__ ids,
                                     const uint32_t* __restrict__ words,
                                     long long pairs, int W,
                                     const int* __restrict__ src_ids,
                                     const int* __restrict__ src_start,
                                     const int* __restrict__ src_cnt, long long m,
                                     const int* __restrict__ vals,
                                     uint32_t* __restrict__ hits, long long block) {
  const int lane = threadIdx.x & 31;
  const long long warps = static_cast<long long>(gridDim.x) * (blockDim.x >> 5);
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x >> 5) + (threadIdx.x >> 5);
       i < pairs; i += warps) {
    const int id = __ldg(ids + i);
    long long pos = 0;
    if (lane == 0) {
      long long a = 0, b = m;  // first entry >= id
      while (a < b) {
        const long long mid = (a + b) >> 1;
        if (__ldg(src_ids + mid) < id) a = mid + 1; else b = mid;
      }
      pos = a;
    }
    pos = __shfl_sync(0xffffffffu, pos, 0);
    if (pos >= m || __ldg(src_ids + pos) != id) continue;
    const int st = __ldg(src_start + pos), deg = __ldg(src_cnt + pos);
    const uint32_t* row = words + i * W;
    for (int e = lane; e < deg; e += 32) {
      const long long v = __ldg(vals + st + e);
      if (v < 0 || v >= block) continue;
      for (int c = 0; c < W; ++c) {
        const uint32_t x = __ldg(row + c);
        if (x) atomicOr(hits + v * W + c, x);
      }
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

// H2.  The in-block push CSR of one shard: src_ids (m,) ascending, src_start
// and src_cnt (m,), vals (block-local rows); hits (block, W).
extern "C" int msbfs_halo_push_or(int device, const void* ids, const void* words,
                                  long long pairs, int W, const void* src_ids,
                                  const void* src_start, const void* src_cnt,
                                  long long m, const void* vals, void* hits,
                                  long long block, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (W < 1 || pairs < 0 || m < 0 || block < 0 || block * W >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (pairs == 0 || m == 0) return static_cast<int>(cudaSuccess);
  const int warps_per_block = msbfs::kThreads / 32;
  push_or_pairs_kernel<<<msbfs::grid_for(pairs, warps_per_block), msbfs::kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(ids), static_cast<const uint32_t*>(words), pairs, W,
      static_cast<const int*>(src_ids), static_cast<const int*>(src_start),
      static_cast<const int*>(src_cnt), m, static_cast<const int*>(vals),
      static_cast<uint32_t*>(hits), block);
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

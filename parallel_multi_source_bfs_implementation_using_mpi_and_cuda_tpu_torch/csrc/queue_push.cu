// Kernels K10 and K11 — the frontier queues of the push and ppush routes.
//
// K10 queue_expand replaces the gather and hit scatter of the JAX
// package's ops/push.py:185 _push_chunk (:203-208).  For each running
// query q and each of its first min(count[q], cap) queue entries u, every
// neighbour v of u gets hit[q, v] = 1, and the 4096-byte tile of the hit
// row that holds v gets touched[q, v >> 12] = 1.  The neighbours are the
// padded table's dedup CSR (the (n + 1, w) table's rows without their
// sentinel slots, in the table's order), so no row holds v twice; several
// rows may, and their writers store the same byte, so plain stores make
// the OR the JAX scatter-max builds — for the flags as for the hit bytes.
//
// K11 queue_compact replaces ops/push.py:57 compact_indices, :83
// compact_frontier_planes and the carry update of :209-219 (and, in its
// row mode, the apply and the union-queue compaction of
// ops/push_packed.py:110-139).
//
// Queue mode, three launches a level, each grid sized to the card (the
// blocks it holds at once, striding over the work), none to the plane:
//   A  count: a block reads 64 tiles' flags at once (a grid apart, so a
//      crowded region spreads over the blocks) and lists the flagged
//      ones, then works on the listed tiles only, four at a time, thread t
//      on each one's 16-byte word t (coalesced, four loads in flight):
//      new = hit & ~visited, visited |= new, hit = new; the tile's count
//      of new entries into offsets (zero for a tile with no flag) and a
//      bit for each word that holds one (nonzero, warp w's ballot the
//      tile's word w);
//   B  scan, a block a query: the tiles' counts become their exclusive
//      offsets, and the counters advance: count, F += count * (level + 1),
//      levels, reached, max_count, level and updated;
//   C  write: the flagged tiles again, listed the same way, their flags
//      cleared; for four tiles with new entries at a time, each thread
//      reads its word where its bit is set and clears it, a block scan
//      ranks the words, and the thread stores its ids at offset + rank
//      while below the capacity (16 bytes a store for a full word, where
//      the address allows); the last block (one ticket, ctrl[2], a block)
//      rewrites ctrl[0] from the counters B advanced.
// The queue is the ascending first cap ids and the count stays whole, as
// in the JAX compaction: a tile's offset comes from the scan in tile
// order, never from an atomic append.  Order matters after a truncated
// level: later levels' counts depend on which ids were kept, and those
// counts decide the capacity protocol's overflow line and retry.
//
// Row mode (ppush), two launches a level, both over the same contiguous
// share of 256-row tiles a block (at most kMaxBlocks blocks):
//   R1 apply, a warp a tile, a lane a row: new = hits & ~visited, visited
//      |= new, frontier = new, hits cleared; the per-lane new bits counted
//      by warp ballots (a __popc(__ballot_sync) for each bit some lane
//      holds), summed once a warp in shared memory and added once a block
//      to counts; the tile's nonzero rows as 8 ballot words (nonzero) and
//      its rows and their out-degrees (read together after the apply)
//      into offsets, summed per block; the
//      last block (one ticket) scans the blocks' (rows, edges) pairs and
//      advances the counters, count, peak, the worklist's state and
//      ctrl[0..1], as the JAX loop body does;
//   R2 write, gated on the next level: each block scans its tiles' pairs
//      from its block's offset and lists each tile's nonzero rows from the
//      ballot words, each with its first edge (a warp scan of the listed
//      rows' out-degrees), ascending, while below the capacity — so K3
//      walks the listed rows' edges of the CSR as it walks the direction
//      switch's worklist.  The frontier plane is not read again.
//
// Queue mode: visited and hit are (K, pitch) bytes, pitch a multiple of 16
// past n; touched (K, tiles) bytes, zero between levels as hit is.  A
// query runs while updated[q] and level[q] < stop[q]; ctrl[0] = some query
// may run (every launch returns at once when it is 0).  Row mode: hits,
// visited and frontier are (n, W) words; the level runs while
// level_go(ctrl, max_levels), and R2 only when the next one may.
//
// Bound: bytes.  K10 must read the queued ids, their CSR offsets (a row's
// start and end, most often in one sector) and the edges they walk, and write a hit byte an edge and a flag
// a touched tile; it reads no sentinel slot and divides nothing.  K11's
// queue mode must read the flags and the touched tiles' hit bytes, visited
// where a hit is set (read and written), and write the new ids and the
// counters: its work follows the frontier's tiles, not the plane, so a
// thin level costs its three launches.  The row mode (K3 writes no tile
// flags) must read the whole hit plane (n 4W bytes), visited where a hit
// is set, and write the frontier plane and the listed rows' ids and
// edges; no per-bit atomic, no single-block scan.
#include "msbfs_common.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = msbfs::kThreads / 32;
// A tile of the queue mode: thread t of a block owns its 16-byte word t,
// bytes [16 t, 16 t + 16), so a block's loads are coalesced and its
// entries are in the queue's order; warp w's ballot is the tile's word w
// of 8.
constexpr int kTileShift = 12;
constexpr int kTileBytes = 1 << kTileShift;
constexpr int kWordsPerTile = 8;  // ballot words
// A tile of the row mode: 256 rows, a warp 32 rows at a time, 8 times.
constexpr int kTileRows = 32 * kWordsPerTile;
// The queue mode's blocks read the flags of this many tiles at a time
// (so a level that touches every tile still spreads over the card), and
// work on this many of the listed tiles at once.
constexpr int kListTiles = 64;
constexpr int kGroup = 4;
constexpr int kScanThreads = 1024;

__device__ __forceinline__ bool may_run(const int* updated, const int* level,
                                        const int* stop, int q) {
  return __ldcg(updated + q) != 0 && __ldcg(level + q) < __ldcg(stop + q);
}

__device__ __forceinline__ int lane_id() { return threadIdx.x & 31; }

// Exclusive prefix of x over the block's threads in thread order (the
// block a multiple of 32 threads); *total gets the block's sum.
__device__ __forceinline__ int block_exclusive(int x, int* total) {
  __shared__ int s_warp[32];
  const int lane = lane_id();
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  int inc = x;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, inc, d);
    if (lane >= d) inc += y;
  }
  if (lane == 31) s_warp[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    int s = lane < warps ? s_warp[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(kFull, s, d);
      if (lane >= d) s += y;
    }
    if (lane < warps) s_warp[lane] = s;
  }
  __syncthreads();
  const int before = warp ? s_warp[warp - 1] : 0;
  *total = s_warp[warps - 1];
  __syncthreads();  // s_warp is reused by the next call
  return before + inc - x;
}

// off[0, m) -> their exclusive prefix, in place; returns the sum.  Reads
// through L2: the counts may come from other blocks of this launch.
__device__ __forceinline__ int scan_in_place(int* off, int m) {
  const int per = (m + blockDim.x - 1) / blockDim.x;
  const int a = min(m, static_cast<int>(threadIdx.x) * per);
  const int b = min(m, a + per);
  int s = 0;
  for (int i = a; i < b; ++i) s += __ldcg(off + i);
  int total;
  int p = block_exclusive(s, &total);
  for (int i = a; i < b; ++i) {
    const int c = __ldcg(off + i);
    off[i] = p;
    p += c;
  }
  return total;
}

// Exclusive prefix of x over the warp's lanes; *total gets the warp's sum.
__device__ __forceinline__ int warp_exclusive(int x, int* total) {
  const int lane = lane_id();
  int inc = x;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, inc, d);
    if (lane >= d) inc += y;
  }
  *total = __shfl_sync(kFull, inc, 31);
  return inc - x;
}

__device__ __forceinline__ int warp_sum(int x) {
#pragma unroll
  for (int d = 16; d; d >>= 1) x += __shfl_xor_sync(kFull, x, d);
  return x;
}

__device__ __forceinline__ bool any4(const uint4& x) {
  return (x.x | x.y | x.z | x.w) != 0u;
}

__device__ __forceinline__ int popc4(const uint4& x) {
  return __popc(x.x) + __popc(x.y) + __popc(x.z) + __popc(x.w);
}

// The last block of a launch to call this (every block calls it once)
// gets true; ctrl[2] is the ticket, zeroed by that block.
__device__ __forceinline__ bool last_block(int* ctrl) {
  __shared__ bool s_last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    s_last = atomicAdd(ctrl + 2, 1) == static_cast<int>(gridDim.x) - 1;
  }
  __syncthreads();
  if (s_last) __threadfence();
  return s_last;
}

// ---- K10 -------------------------------------------------------------------

__global__ void __launch_bounds__(msbfs::kThreads)
queue_expand_kernel(const int* __restrict__ start, const int* __restrict__ vals,
                    long long pitch, int tiles,
                    uint8_t* hit, uint8_t* touched, const int* __restrict__ queue,
                    int cap, const int* count, const int* level, const int* updated,
                    const int* stop, const int* ctrl) {
  if (__ldcg(ctrl) == 0) return;
  const int q = blockIdx.y;
  if (!may_run(updated, level, stop, q)) return;
  const long long c = min(__ldcg(count + q), cap);
  const int* qq = queue + static_cast<long long>(q) * cap;
  uint8_t* h = hit + q * pitch;
  uint8_t* flag = touched + static_cast<long long>(q) * tiles;
  const int lane = lane_id();
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  // 32 consecutive entries a warp, a lane each: their CSR rows' starts and
  // ends.  Then the warp walks their edges in the queue's order, a lane
  // an edge (the edge's entry found by a binary search of the degrees'
  // prefix over the lanes), so a store instruction covers a few entries'
  // neighbours — the order index_fill_ of the flat ids stores in, where a
  // lane an entry scatters a warp's stores over 32 entries' rows.
  // The next 32 entries' rows are read while this step's edges are
  // walked.
  auto row_of = [&](long long i, int* first, int* d) {
    *first = 0;
    *d = 0;
    if (i < c) {
      const int u = __ldg(qq + i);
      *first = __ldg(start + u);
      *d = __ldg(start + u + 1) - *first;  // the same sector, most often
    }
  };
  long long i0 = static_cast<long long>(blockIdx.x) * blockDim.x + (threadIdx.x & ~31);
  int next_first, next_d;
  row_of(i0 + lane, &next_first, &next_d);
  for (; i0 < c; i0 += step) {
    const int first = next_first, d = next_d;
    row_of(i0 + step + lane, &next_first, &next_d);
    int edges;
    const int before = warp_exclusive(d, &edges);
    for (int e0 = 0; e0 < edges; e0 += 32) {
      const int e = e0 + lane;
      int owner = 0;
#pragma unroll
      for (int half = 16; half; half >>= 1) {
        if (__shfl_sync(kFull, before, owner + half) <= e) owner += half;
      }
      const int at = __shfl_sync(kFull, first, owner) + e - __shfl_sync(kFull, before, owner);
      if (e < edges) {
        const int v = __ldg(vals + at);
        h[v] = 1;
        flag[v >> kTileShift] = 1;  // a warp's stores to one flag merge
      }
    }
  }
}

// ---- K11, queue mode ---------------------------------------------------------

// The block's list slot of a flagged thread (threads in order); *listed
// gets the block's count.  The caller stores its entries at the slot and
// syncs before reading them.
__device__ __forceinline__ int list_slot(bool flagged, int* listed) {
  __shared__ int s_warp[kWarps];
  const int lane = lane_id();
  const int warp = threadIdx.x >> 5;
  const unsigned m = __ballot_sync(kFull, flagged);
  if (lane == 0) s_warp[warp] = __popc(m);
  __syncthreads();
  int before = 0, total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int c = s_warp[w];
    before += w < warp ? c : 0;
    total += c;
  }
  *listed = total;
  return before + __popc(m & ((1u << lane) - 1u));
}

__global__ void __launch_bounds__(msbfs::kThreads)
queue_count(uint8_t* hit, uint8_t* visited, const uint8_t* touched, long long pitch,
            int tiles, long long units, int* offsets, unsigned* nonzero,
            const int* level, const int* updated, const int* stop, const int* ctrl) {
  if (__ldcg(ctrl) == 0) return;
  // The listed tiles: query (bit 31 set: it may not run) and tile; the
  // group's counts.
  __shared__ int s_q[kListTiles], s_t[kListTiles], s_cnt[kGroup];
  const int lane = lane_id();
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x < kGroup) s_cnt[threadIdx.x] = 0;
  const long long step = static_cast<long long>(gridDim.x) * kListTiles;
  for (long long base = 0; base < units; base += step) {
    // The block's flags lie a grid apart, so the tiles of a query that
    // still runs when the others have stopped spread over every block.
    const long long u = base + blockIdx.x + static_cast<long long>(threadIdx.x) * gridDim.x;
    bool flagged = false;
    int q = 0, t = 0;
    bool run = false;
    if (threadIdx.x < kListTiles && u < units) {
      q = static_cast<int>(u / tiles);
      t = static_cast<int>(u - static_cast<long long>(q) * tiles);
      flagged = touched[u] != 0;
      run = may_run(updated, level, stop, q);
      if (!flagged) offsets[u + q] = 0;  // (q, t) of the (K, tiles + 1) offsets
    }
    int listed;
    const int slot = list_slot(flagged, &listed);
    if (flagged) {
      s_q[slot] = q | (run ? 0 : static_cast<int>(1u << 31));
      s_t[slot] = t;
    }
    __syncthreads();
    for (int g = 0; g < listed; g += kGroup) {
      // Word threadIdx.x of up to kGroup tiles at once: new = hit &
      // ~visited, visited |= new, hit = new (C lists what is left and
      // clears it); a query that may not run lists nothing and its hit
      // bytes are cleared.
      uint4 h[kGroup], v[kGroup];
      long long at[kGroup];
      bool run[kGroup], in[kGroup];
#pragma unroll
      for (int k = 0; k < kGroup; ++k) {
        h[k] = make_uint4(0u, 0u, 0u, 0u);
        run[k] = in[k] = false;
        at[k] = 0;
        if (g + k < listed) {
          const int qk = s_q[g + k];
          run[k] = qk >= 0;
          const long long b = static_cast<long long>(s_t[g + k]) * kTileBytes + 16 * threadIdx.x;
          at[k] = static_cast<long long>(qk & 0x7fffffff) * pitch + b;
          in[k] = b < pitch;
          if (in[k]) h[k] = *reinterpret_cast<const uint4*>(hit + at[k]);
        }
      }
      // A 32-byte sector is two threads' words: where either stores, both
      // do (the other its word unchanged), so L2 takes whole sectors and
      // reads nothing back for a partial write (a word past the row's
      // pitch is never touched).
#pragma unroll
      for (int k = 0; k < kGroup; ++k) {
        const bool partner_in = __shfl_xor_sync(kFull, in[k], 1);
        const bool partner_hit = __shfl_xor_sync(kFull, any4(h[k]), 1);
        in[k] = in[k] && partner_in;  // from here: both words of the sector
        const bool pair = any4(h[k]) || (in[k] && partner_hit);
        v[k] = run[k] && pair ? *reinterpret_cast<const uint4*>(visited + at[k])
                              : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int k = 0; k < kGroup; ++k) {
        // Bytes are 0 or 1: h & ~v is the byte-wise "hit and not visited".
        const uint4 nw = run[k] ? make_uint4(h[k].x & ~v[k].x, h[k].y & ~v[k].y,
                                             h[k].z & ~v[k].z, h[k].w & ~v[k].w)
                                : make_uint4(0u, 0u, 0u, 0u);
        const bool fresh = any4(nw);
        const bool partner_fresh = __shfl_xor_sync(kFull, fresh, 1);
        if (fresh || (in[k] && partner_fresh)) {
          *reinterpret_cast<uint4*>(visited + at[k]) =
              make_uint4(v[k].x | nw.x, v[k].y | nw.y, v[k].z | nw.z, v[k].w | nw.w);
        }
        const bool changed = nw.x != h[k].x || nw.y != h[k].y || nw.z != h[k].z ||
                             nw.w != h[k].w;
        const bool partner_changed = __shfl_xor_sync(kFull, changed, 1);
        if (changed || (in[k] && partner_changed)) {
          *reinterpret_cast<uint4*>(hit + at[k]) = nw;
        }
        const unsigned m = __ballot_sync(kFull, any4(nw));
        const int c = warp_sum(popc4(nw));
        if (lane == 0 && g + k < listed) {
          const long long tile = static_cast<long long>(s_q[g + k] & 0x7fffffff) * tiles +
                                 s_t[g + k];
          nonzero[tile * kWordsPerTile + warp] = m;
          if (c) atomicAdd(s_cnt + k, c);
        }
      }
      __syncthreads();
      if (threadIdx.x < kGroup && g + threadIdx.x < listed) {
        const int qk = s_q[g + threadIdx.x] & 0x7fffffff;
        offsets[static_cast<long long>(qk) * (tiles + 1) + s_t[g + threadIdx.x]] =
            s_cnt[threadIdx.x];
        s_cnt[threadIdx.x] = 0;
      }
      __syncthreads();
    }
    __syncthreads();  // s_q and s_t are rewritten next round
  }
}

__global__ void __launch_bounds__(kScanThreads)
queue_scan(int* offsets, int tiles, int* count, long long* f, int* levels,
           int* reached, int* level, int* updated, const int* stop,
           int* max_count, const int* ctrl) {
  if (__ldcg(ctrl) == 0) return;
  const int q = blockIdx.x;
  const bool run = may_run(updated, level, stop, q);
  int* off = offsets + static_cast<long long>(q) * (tiles + 1);
  // A wrote every tile's count (zero for a query that may not run).
  const int total = scan_in_place(off, tiles);
  if (threadIdx.x == 0) {
    off[tiles] = total;
    if (run) {
      const int lv = level[q];
      count[q] = total;
      f[q] += static_cast<long long>(total) * (lv + 1);
      if (total > 0) levels[q] = lv + 2;
      reached[q] += total;
      max_count[q] = max(max_count[q], total);
      updated[q] = total > 0;
      level[q] = lv + 1;
    }
  }
}

// A thread's ids of one 16-byte word ``nw`` of new entries (the first at
// vertex ``id``) at queue slots p, p + 1, ... while below the capacity: 16
// bytes a store for a full word where the address allows.
__device__ __forceinline__ void store_word(int* qq, int p, int cap, int id, const uint4& nw) {
  if (popc4(nw) == 16 && p + 16 <= cap && (reinterpret_cast<uintptr_t>(qq + p) & 15u) == 0u) {
    int4* d = reinterpret_cast<int4*>(qq + p);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      d[k] = make_int4(id + 4 * k, id + 4 * k + 1, id + 4 * k + 2, id + 4 * k + 3);
    }
    return;
  }
  const unsigned w[4] = {nw.x, nw.y, nw.z, nw.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    for (unsigned x = w[k]; x && p < cap; x &= x - 1u, ++p) {
      qq[p] = id + 4 * k + ((__ffs(x) - 1) >> 3);
    }
  }
}

__global__ void __launch_bounds__(msbfs::kThreads)
queue_write(uint8_t* hit, uint8_t* touched, long long pitch, int tiles, long long units,
            const int* offsets, const unsigned* nonzero, int* queue, int cap,
            const int* level, const int* updated, const int* stop, int* ctrl, int K) {
  if (__ldcg(ctrl) == 0) return;
  // The listed tiles (query, tile, first slot) and the group's per-warp
  // sums of new entries.
  __shared__ int s_q[kListTiles], s_t[kListTiles], s_slot[kListTiles];
  __shared__ unsigned s_words[kListTiles][kWordsPerTile];
  __shared__ int s_sum[kGroup][kWarps];
  const int lane = lane_id();
  const int warp = threadIdx.x >> 5;
  const long long step = static_cast<long long>(gridDim.x) * kListTiles;
  for (long long base = 0; base < units; base += step) {
    // The block's flags lie a grid apart, so the tiles of a query that
    // still runs when the others have stopped spread over every block.
    const long long u = base + blockIdx.x + static_cast<long long>(threadIdx.x) * gridDim.x;
    int q = 0, t = 0, lo = 0, hi = 0;
    uint4 w0 = make_uint4(0u, 0u, 0u, 0u), w1 = w0;
    if (threadIdx.x < kListTiles && u < units) {
      // The flag, the offsets and the ballot words read in one round (a
      // tile with no flag has a zero count).
      q = static_cast<int>(u / tiles);
      t = static_cast<int>(u - static_cast<long long>(q) * tiles);
      const bool flagged = touched[u] != 0;
      lo = offsets[u + q];  // (q, t) of the (K, tiles + 1) offsets
      hi = offsets[u + q + 1];
      const uint4* words = reinterpret_cast<const uint4*>(nonzero + u * kWordsPerTile);
      w0 = __ldg(words);
      w1 = __ldg(words + 1);
      if (flagged) touched[u] = 0;
      if (!flagged) hi = lo;
    }
    int listed;
    const int slot = list_slot(hi > lo, &listed);
    if (hi > lo) {
      s_q[slot] = q;
      s_t[slot] = t;
      s_slot[slot] = lo;
      unsigned* w = s_words[slot];
      w[0] = w0.x; w[1] = w0.y; w[2] = w0.z; w[3] = w0.w;
      w[4] = w1.x; w[5] = w1.y; w[6] = w1.z; w[7] = w1.w;
    }
    __syncthreads();
    for (int g = 0; g < listed; g += kGroup) {
      // Word threadIdx.x of up to kGroup tiles, where its bit says it holds
      // new entries: read, cleared, ranked by a block scan.
      uint4 nw[kGroup];
      long long at[kGroup];
      int c[kGroup], p[kGroup];
      bool in[kGroup];
#pragma unroll
      for (int k = 0; k < kGroup; ++k) {
        nw[k] = make_uint4(0u, 0u, 0u, 0u);
        at[k] = 0;
        in[k] = false;
        if (g + k < listed) {
          const unsigned word = s_words[g + k][warp];
          const long long b = static_cast<long long>(s_t[g + k]) * kTileBytes + 16 * threadIdx.x;
          at[k] = static_cast<long long>(s_q[g + k]) * pitch + b;
          in[k] = b < pitch;
          if ((word >> lane) & 1u) nw[k] = *reinterpret_cast<const uint4*>(hit + at[k]);
        }
      }
#pragma unroll
      for (int k = 0; k < kGroup; ++k) {
        // A word with no new entry is zero after A, so a sector's two
        // words are cleared together (whole-sector stores; a word past
        // the row's pitch is never touched).
        const bool mine = any4(nw[k]);
        const bool partner = __shfl_xor_sync(kFull, mine, 1);
        const bool partner_in = __shfl_xor_sync(kFull, in[k], 1);
        if (mine || (in[k] && partner_in && partner)) {
          *reinterpret_cast<uint4*>(hit + at[k]) = make_uint4(0u, 0u, 0u, 0u);
        }
        c[k] = popc4(nw[k]);
        int total;
        p[k] = warp_exclusive(c[k], &total);
        if (lane == 0) s_sum[k][warp] = total;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kGroup; ++k) {
        if (!c[k]) continue;
        int before = s_slot[g + k];
        for (int w = 0; w < warp; ++w) before += s_sum[k][w];
        const int q_k = s_q[g + k];
        const int id = s_t[g + k] * kTileBytes + 16 * threadIdx.x;
        store_word(queue + static_cast<long long>(q_k) * cap, before + p[k], cap, id, nw[k]);
      }
      __syncthreads();  // s_sum is rewritten by the next group
    }
    __syncthreads();  // the list is rewritten next round
  }
  // The last block rewrites the go flag from the counters B advanced.
  if (!last_block(ctrl)) return;
  int go = 0;
  for (int i = threadIdx.x; i < K; i += blockDim.x) go |= may_run(updated, level, stop, i);
  go = __syncthreads_or(go);
  if (threadIdx.x == 0) {
    ctrl[0] = go;
    ctrl[2] = 0;
  }
}

// ---- K11, row mode -----------------------------------------------------------

// The warp's count of each new bit of a word: a ballot for each bit some
// lane holds.  Lane 0 adds it into cnt[bit] (any W), or, with cnt null,
// lane b into *mine (W == 1: lane b keeps bit b's count in a register).
__device__ __forceinline__ void count_bits(uint32_t nw, int* cnt, int* mine) {
  const int lane = lane_id();
  for (unsigned any = __reduce_or_sync(kFull, nw); any; any &= any - 1u) {
    const int b = __ffs(any) - 1;
    const int c = __popc(__ballot_sync(kFull, (nw >> b) & 1u));
    if (cnt == nullptr) {
      *mine += lane == b ? c : 0;
    } else if (lane == 0) {
      atomicAdd(cnt + b, c);
    }
  }
}

// One word of the apply: new = h & ~v, visited |= new, hits cleared,
// frontier = new; returns new.
__device__ __forceinline__ uint32_t apply_word(uint32_t h, uint32_t v, uint32_t* hp,
                                               uint32_t* vp, uint32_t* fp) {
  const uint32_t nw = h & ~v;
  if (nw) *vp = v | nw;
  if (h) *hp = 0u;
  *fp = nw;
  return nw;
}

// kOne: W == 1, the tile's eight 32-row words of hits read before any is
// applied.  Otherwise a lane walks its row's W words, 16 bytes at a time
// where W is a multiple of 4.
template <bool kOne>
__global__ void __launch_bounds__(msbfs::kThreads)
row_apply(uint32_t* hits, uint32_t* visited, uint32_t* frontier, long long n, int W,
          const int* __restrict__ degrees, int* offsets, long long stride,
          unsigned* nonzero, int tiles, int per, int* counts, bool smem_counts,
          int* count, long long* f, int* levels, int* reached, int* peak,
          long long* state, int cap, int* ctrl, int max_levels) {
  if (!msbfs::level_go(ctrl, max_levels)) return;
  extern __shared__ int s_counts[];
  __shared__ int s_rows[kWarps], s_edges[kWarps];
  if (smem_counts) {
    for (int i = threadIdx.x; i < 32 * W; i += blockDim.x) s_counts[i] = 0;
    __syncthreads();
  }
  int* cnt = smem_counts ? s_counts : counts;
  const int lane = lane_id();
  const int warp = threadIdx.x >> 5;
  const int t0 = blockIdx.x * per;
  const int t1 = min(tiles, t0 + per);
  int rows_acc = 0, edges_acc = 0, mine = 0;
  for (int t = t0 + warp; t < t1; t += kWarps) {
    const long long r0 = static_cast<long long>(t) * kTileRows + lane;
    unsigned word = 0u;
    int rows_t = 0;
    // The lane's rows that enter the frontier: their out-degrees are read
    // together after the tile's apply, and summed once.
    unsigned lane_nz = 0u;
    if (kOne) {
      uint32_t h[kWordsPerTile], v[kWordsPerTile];
#pragma unroll
      for (int j = 0; j < kWordsPerTile; ++j) {
        const long long r = r0 + 32 * j;
        h[j] = r < n ? hits[r] : 0u;
      }
#pragma unroll
      for (int j = 0; j < kWordsPerTile; ++j) v[j] = h[j] ? visited[r0 + 32 * j] : 0u;
#pragma unroll
      for (int j = 0; j < kWordsPerTile; ++j) {
        const long long r = r0 + 32 * j;
        uint32_t nw = 0u;
        if (r < n) nw = apply_word(h[j], v[j], hits + r, visited + r, frontier + r);
        count_bits(nw, nullptr, &mine);
        const unsigned m = __ballot_sync(kFull, nw != 0u);
        if (lane == j) word = m;
        rows_t += __popc(m);
        lane_nz |= (nw != 0u ? 1u : 0u) << j;
      }
    } else {
      const bool vec = (W & 3) == 0;
      for (int j = 0; j < kWordsPerTile; ++j) {
        const long long r = r0 + 32 * j;
        const bool in = r < n;
        bool nz = false;
        for (int k = 0; k < W; k += vec ? 4 : 1) {
          const long long i = r * W + k;
          if (vec) {
            uint4 nw4 = make_uint4(0u, 0u, 0u, 0u);
            if (in) {
              uint4* hp = reinterpret_cast<uint4*>(hits + i);
              uint4* vp = reinterpret_cast<uint4*>(visited + i);
              const uint4 h = *hp;
              if (any4(h)) {
                const uint4 v = *vp;
                nw4 = make_uint4(h.x & ~v.x, h.y & ~v.y, h.z & ~v.z, h.w & ~v.w);
                if (any4(nw4)) {
                  *vp = make_uint4(v.x | nw4.x, v.y | nw4.y, v.z | nw4.z, v.w | nw4.w);
                }
                *hp = make_uint4(0u, 0u, 0u, 0u);
              }
              *reinterpret_cast<uint4*>(frontier + i) = nw4;
            }
            nz |= any4(nw4);
            count_bits(nw4.x, cnt + 32 * k, &mine);
            count_bits(nw4.y, cnt + 32 * (k + 1), &mine);
            count_bits(nw4.z, cnt + 32 * (k + 2), &mine);
            count_bits(nw4.w, cnt + 32 * (k + 3), &mine);
          } else {
            uint32_t nw = 0u;
            if (in) {
              const uint32_t h = hits[i];
              nw = apply_word(h, h ? visited[i] : 0u, hits + i, visited + i, frontier + i);
            }
            nz |= nw != 0u;
            count_bits(nw, cnt + 32 * k, &mine);
          }
        }
        const unsigned m = __ballot_sync(kFull, nz);
        if (lane == j) word = m;
        rows_t += __popc(m);
        lane_nz |= (nz ? 1u : 0u) << j;
      }
    }
    int d[kWordsPerTile];
#pragma unroll
    for (int j = 0; j < kWordsPerTile; ++j) {
      d[j] = (lane_nz >> j) & 1u ? __ldg(degrees + r0 + 32 * j) : 0;
    }
    int lane_edges = 0;
#pragma unroll
    for (int j = 0; j < kWordsPerTile; ++j) lane_edges += d[j];
    const int edges_t = warp_sum(lane_edges);
    if (lane < kWordsPerTile) nonzero[static_cast<long long>(t) * kWordsPerTile + lane] = word;
    if (lane == 0) {
      offsets[t] = rows_t;
      offsets[stride + t] = edges_t;
    }
    rows_acc += rows_t;
    edges_acc += edges_t;
  }
  if (lane == 0) {
    s_rows[warp] = rows_acc;
    s_edges[warp] = edges_acc;
  }
  if (kOne && mine) atomicAdd(cnt + lane, mine);
  __syncthreads();
  if (smem_counts) {
    for (int i = threadIdx.x; i < 32 * W; i += blockDim.x) {
      if (s_counts[i]) atomicAdd(counts + i, s_counts[i]);
    }
  }
  if (threadIdx.x == 0) {
    int r = 0, e = 0;
    for (int w = 0; w < kWarps; ++w) {
      r += s_rows[w];
      e += s_edges[w];
    }
    offsets[tiles + blockIdx.x] = r;
    offsets[stride + tiles + blockIdx.x] = e;
  }
  if (!last_block(ctrl)) return;
  // The last block: the blocks' (rows, edges) become their offsets, and
  // the counters and the control advance (ctrl[0..1] last: every other
  // block has read its gate).
  const int lv = __ldcg(ctrl + 1);
  const int rows = scan_in_place(offsets + tiles, gridDim.x);
  const int edges = scan_in_place(offsets + stride + tiles, gridDim.x);
  int any = 0;
  for (int i = threadIdx.x; i < 32 * W; i += blockDim.x) {
    const int c = __ldcg(counts + i);
    if (c) {
      f[i] += static_cast<long long>(c) * (lv + 1);
      levels[i] = lv + 2;
      reached[i] += c;
      counts[i] = 0;
      any = 1;
    }
  }
  any = __syncthreads_or(any);
  if (threadIdx.x == 0) {
    count[0] = rows;
    // The JAX loop counts a frontier's rows when a level starts on it.
    if (lv + 1 < max_levels) peak[0] = max(peak[0], rows);
    state[msbfs::kListed] = min(rows, cap);
    // A list cut at the capacity: row_write stores its edges.
    if (rows <= cap) state[msbfs::kListedEdges] = edges;
    ctrl[0] = any;
    ctrl[1] = lv + 1;
    ctrl[2] = 0;
  }
}

__global__ void __launch_bounds__(msbfs::kThreads)
row_write(long long n, const int* __restrict__ degrees, const int* offsets,
          long long stride, const unsigned* nonzero, int tiles, int per, int* worklist,
          int cap, long long* state, const int* ctrl, int max_levels) {
  if (!msbfs::level_go(ctrl, max_levels)) return;  // the next level's gate
  const int t0 = blockIdx.x * per;
  const int t1 = min(tiles, t0 + per);
  int row_base = __ldcg(offsets + tiles + blockIdx.x);
  int edge_base = __ldcg(offsets + stride + tiles + blockIdx.x);
  if (t0 >= t1 || row_base >= cap) return;  // block-uniform
  __shared__ int s_slot[msbfs::kThreads], s_first[msbfs::kThreads],
      s_rows[msbfs::kThreads];
  const int lane = lane_id();
  const int warp = threadIdx.x >> 5;
  for (int a = t0; a < t1; a += msbfs::kThreads) {  // 256 tiles a round
    const int t = a + threadIdx.x;
    const int rows_t = t < t1 ? __ldcg(offsets + t) : 0;
    const int edges_t = t < t1 ? __ldcg(offsets + stride + t) : 0;
    int rows_total, edges_total;
    s_slot[threadIdx.x] = row_base + block_exclusive(rows_t, &rows_total);
    s_first[threadIdx.x] = edge_base + block_exclusive(edges_t, &edges_total);
    s_rows[threadIdx.x] = rows_t;
    __syncthreads();
    for (int i = warp; i < min(msbfs::kThreads, t1 - a); i += kWarps) {
      int slot = s_slot[i];
      if (s_rows[i] == 0 || slot >= cap) continue;
      int first = s_first[i];
      const long long tile = a + i;
      const unsigned mine =
          lane < kWordsPerTile ? __ldcg(nonzero + tile * kWordsPerTile + lane) : 0u;
      // The listed rows' out-degrees, all eight 32-row words at once.
      unsigned m[kWordsPerTile];
      int d[kWordsPerTile];
#pragma unroll
      for (int j = 0; j < kWordsPerTile; ++j) {
        m[j] = __shfl_sync(kFull, mine, j);
        d[j] = (m[j] >> lane) & 1u ? __ldg(degrees + tile * kTileRows + 32 * j + lane) : 0;
      }
      for (int j = 0; j < kWordsPerTile && slot < cap; ++j) {
        if (m[j] == 0u) continue;
        const long long r = tile * kTileRows + 32 * j + lane;
        int d_total;
        const int e = first + warp_exclusive(d[j], &d_total);
        const int s = slot + __popc(m[j] & ((1u << lane) - 1u));
        if ((m[j] >> lane) & 1u && s < cap) {
          worklist[s] = static_cast<int>(r);
          worklist[cap + s] = e;
          if (s == cap - 1) state[msbfs::kListedEdges] = e + d[j];
        }
        slot += __popc(m[j]);
        first += d_total;
      }
    }
    row_base += rows_total;
    edge_base += edges_total;
    if (row_base >= cap) return;  // block-uniform
    __syncthreads();  // the shared offsets are rewritten next round
  }
}

// Blocks of ``kernel`` that fit on the card at once (``smem`` bytes of
// dynamic shared memory each): the card-sized grids' cap.  Cached per
// device and shared-memory size in ``cache``.
struct Resident {
  int smem[msbfs::kMaxDevices];
  int blocks[msbfs::kMaxDevices];
};

template <typename Kernel>
cudaError_t resident_blocks(Kernel kernel, int smem, int device, Resident* cache, int* out) {
  const bool cached = device >= 0 && device < msbfs::kMaxDevices;
  if (cached && cache->blocks[device] && cache->smem[device] == smem) {
    *out = cache->blocks[device];
    return cudaSuccess;
  }
  int per_sm = 0, sms = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                                  msbfs::kThreads, smem);
  if (err == cudaSuccess) err = msbfs::sm_count(device, &sms);
  if (err != cudaSuccess) return err;
  *out = per_sm < 1 ? sms : per_sm * sms;
  if (cached) {
    cache->smem[device] = smem;
    cache->blocks[device] = *out;
  }
  return cudaSuccess;
}

Resident g_count, g_write, g_apply_one, g_apply_words, g_write_rows;

// A grid of ``items`` / ``per_block`` blocks, at most ``most``.
int card_grid(long long items, int per_block, int most) {
  const long long blocks = (items + per_block - 1) / per_block;
  return static_cast<int>(blocks < 1 ? 1 : blocks > most ? most : blocks);
}

}  // namespace

// K10.  start, vals: the padded table's dedup CSR, (n + 1,) offsets (row
// u's neighbours vals[start[u], start[u + 1])) and (E,); hit: (K, pitch)
// bytes; touched: (K, tiles) bytes, tiles = the 4096-byte tiles of pitch;
// queue: (K, cap).
extern "C" int msbfs_queue_expand(int device, const void* start, const void* vals,
                                  long long n, int K, long long pitch,
                                  void* hit, void* touched, int tiles,
                                  const void* queue, long long cap,
                                  const void* count, const void* level,
                                  const void* updated, const void* stop,
                                  const void* ctrl, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n < 0 || n >= (1LL << 31) || K < 1 || K > 65535 || cap < 1 ||
      cap > (1LL << 31) - 1 || pitch < n + 1 || pitch % 16 ||
      tiles != (pitch + kTileBytes - 1) / kTileBytes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // A thread an entry, at most kMaxBlocks blocks in all, striding.
  long long bx = (cap + msbfs::kThreads - 1) / msbfs::kThreads;
  const long long most = msbfs::kMaxBlocks / K;
  bx = bx > most ? most : bx;
  bx = bx < 1 ? 1 : bx;
  queue_expand_kernel<<<dim3(static_cast<unsigned>(bx), K), msbfs::kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(start), static_cast<const int*>(vals), pitch, tiles,
      static_cast<uint8_t*>(hit),
      static_cast<uint8_t*>(touched), static_cast<const int*>(queue),
      static_cast<int>(cap), static_cast<const int*>(count),
      static_cast<const int*>(level), static_cast<const int*>(updated),
      static_cast<const int*>(stop), static_cast<const int*>(ctrl));
  return static_cast<int>(cudaGetLastError());
}

// K11.  mode 0 (queue): hit/visited (K = lanes, pitch) bytes, touched (K,
// tiles) bytes, queue (K, cap), per-query count/f/levels/reached/level/
// updated/stop/peak (max_count), offsets (K, tiles + 1) (stride unused),
// nonzero (K, tiles, 8) ballot words; frontier, counts, state and degrees
// unused.
// mode 1 (rows): hits/visited/frontier (n, W = lanes) words, queue the
// (2, cap) worklist (the listed rows, then each one's first edge in the
// level's edge space), count and peak (1,), f/levels/reached/counts (32W,),
// offsets (2, stride) (the tiles' rows, then their edges; past the tiles
// the blocks'), nonzero (tiles, 8) words, state the worklist's
// (kSwitchWords,) int64, degrees (n,) the rows' out-degrees in the CSR K3
// walks; level/updated/stop/touched unused (the control is ctrl[0..1]).
extern "C" int msbfs_queue_compact(
    int device, int mode, void* hit, void* visited, void* frontier, long long n,
    int lanes, long long pitch, void* queue, long long cap, void* count, void* f,
    void* levels, void* reached, void* level, void* updated, const void* stop,
    void* peak, void* counts, void* offsets, long long stride, int tiles,
    void* touched, void* nonzero, void* state, const void* degrees, void* ctrl,
    int max_levels, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* const c = static_cast<int*>(ctrl);
  int* const off = static_cast<int*>(offsets);
  unsigned* const nz = static_cast<unsigned*>(nonzero);
  if (n < 0 || n >= (1LL << 31) - 1 || lanes < 1 || cap < 0 ||
      cap > (1LL << 31) - 1 || tiles < 1 || nonzero == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (mode == 0) {
    const int K = lanes;
    if (K > 65535 || pitch < n + 1 || pitch % 16 || touched == nullptr ||
        tiles != (pitch + kTileBytes - 1) / kTileBytes) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    uint8_t* const h = static_cast<uint8_t*>(hit);
    uint8_t* const flags = static_cast<uint8_t*>(touched);
    int* const lv = static_cast<int*>(level);
    int* const up = static_cast<int*>(updated);
    const int* const st = static_cast<const int*>(stop);
    // Every (query, tile) flag, kListTiles a block at a time, at most the
    // blocks the card holds at once.
    const long long units = static_cast<long long>(K) * tiles;
    int most = 0;
    err = resident_blocks(queue_count, 0, device, &g_count, &most);
    if (err != cudaSuccess) return static_cast<int>(err);
    queue_count<<<card_grid(units, kListTiles, most), msbfs::kThreads, 0, s>>>(
        h, static_cast<uint8_t*>(visited), flags, pitch, tiles, units, off, nz, lv, up, st,
        c);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    queue_scan<<<K, kScanThreads, 0, s>>>(
        off, tiles, static_cast<int*>(count), static_cast<long long*>(f),
        static_cast<int*>(levels), static_cast<int*>(reached), lv, up, st,
        static_cast<int*>(peak), c);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    err = resident_blocks(queue_write, 0, device, &g_write, &most);
    if (err != cudaSuccess) return static_cast<int>(err);
    queue_write<<<card_grid(units, kListTiles, most), msbfs::kThreads, 0, s>>>(
        h, flags, pitch, tiles, units, off, nz, static_cast<int*>(queue),
        static_cast<int>(cap), lv, up, st, c, K);
    return static_cast<int>(cudaGetLastError());
  }
  if (mode != 1) return static_cast<int>(cudaErrorInvalidValue);
  const int W = lanes;
  if (n * W >= (1LL << 31) || tiles != (n + kTileRows - 1) / kTileRows ||
      state == nullptr || degrees == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // Per-lane counts in shared memory up to W = 256 (32 KB), else atomics
  // straight into the counts vector.
  const bool smem = W <= 256;
  const int smem_bytes = smem ? 32 * W * static_cast<int>(sizeof(int)) : 0;
  auto apply = W == 1 ? row_apply<true> : row_apply<false>;
  // A contiguous share of the tiles a block, at least a tile a warp, at
  // most the blocks the card holds at once (the partition R2 reuses).
  int most = 0, most_write = 0;
  err = resident_blocks(apply, smem_bytes, device, W == 1 ? &g_apply_one : &g_apply_words,
                        &most);
  if (err == cudaSuccess) err = resident_blocks(row_write, 0, device, &g_write_rows, &most_write);
  if (err != cudaSuccess) return static_cast<int>(err);
  most = most < most_write ? most : most_write;
  if (stride <= tiles) return static_cast<int>(cudaErrorInvalidValue);
  const long long room = stride - tiles;  // the blocks' sums sit past the tiles'
  const int grid = card_grid(tiles, kWarps, room < most ? static_cast<int>(room) : most);
  const int per = (tiles + grid - 1) / grid;
  uint32_t* const fr = static_cast<uint32_t*>(frontier);
  const int* const deg = static_cast<const int*>(degrees);
  long long* const st = static_cast<long long*>(state);
  apply<<<grid, msbfs::kThreads, smem_bytes, s>>>(
      static_cast<uint32_t*>(hit), static_cast<uint32_t*>(visited), fr, n, W, deg, off,
      stride, nz, tiles, per, static_cast<int*>(counts), smem, static_cast<int*>(count),
      static_cast<long long*>(f), static_cast<int*>(levels), static_cast<int*>(reached),
      static_cast<int*>(peak), st, static_cast<int>(cap), c, max_levels);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  row_write<<<grid, msbfs::kThreads, 0, s>>>(
      n, deg, off, stride, nz, tiles, per, static_cast<int*>(queue),
      static_cast<int>(cap), st, c, max_levels);
  return static_cast<int>(cudaGetLastError());
}

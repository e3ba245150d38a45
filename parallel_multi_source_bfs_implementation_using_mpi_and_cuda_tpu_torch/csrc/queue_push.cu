// Kernels K10 and K11 — the frontier queues of the push and ppush routes.
//
// K10 queue_expand replaces the gather and hit scatter of the JAX
// package's ops/push.py:185 _push_chunk (:203-208).  For each running
// query q and each of its first min(count[q], cap) queue entries u, every
// neighbour v != n of u (row u of the (n + 1, w) padded table, sentinel n)
// gets hit[q, v] = 1.  The table's rows are the deduped neighbours, so no
// row holds v twice; several rows may, and their writers store the same
// byte, so plain stores make the OR the JAX scatter-max builds.
//
// K11 queue_compact replaces ops/push.py:57 compact_indices, :83
// compact_frontier_planes and the carry update of :201-219 (and, in its
// row mode, the apply and the union-queue compaction of
// ops/push_packed.py:110-139).  Three launches in one call:
//   A  apply, a block a tile: new = hit & ~visited, visited |= new, and a
//      count of the tile's new entries into offsets;
//   B  scan, a block a query (one for the row mode): the tiles' counts
//      become their exclusive offsets, and the counters advance: count,
//      F += count * (level + 1), levels, reached, max_count (peak), level
//      and updated (the row mode: the per-lane counts of A, the control
//      ctrl[0..1], and the worklist's length and edges for K3's walk);
//   C  write, a block a tile with new entries: a block scan of the
//      tile's entries gives each its slot, offset + rank, stored while it
//      is below the capacity — so the queue is the ascending first cap
//      ids and the count stays whole, as in the JAX compaction; the queue
//      mode clears the hit bytes here and its last block rewrites ctrl[0];
//      the row mode also stores each listed row's first edge (a second
//      scan, of the rows' out-degrees), so K3 walks the listed rows' edges
//      of a CSR as it walks the direction switch's worklist.
// Order matters only after a truncated level: later levels' counts then
// depend on which ids were kept, and those counts decide the capacity
// protocol's overflow line and retry.  A tile's offset comes from the scan,
// not from an atomic append, so the kept ids are JAX's.
//
// Queue mode: visited and hit are (K, pitch) bytes, pitch a multiple of 16
// past n; a tile is 4096 bytes (256 threads, 16 bytes each).  A query runs
// while updated[q] and level[q] < stop[q]; ctrl[0] = some query may run
// (every launch returns at once when it is 0), ctrl[2] C's ticket.
// Row mode: hits, visited and frontier are (n, W) words; a tile is 256
// rows, a thread a row; the level runs while level_go(ctrl, max_levels),
// and C only when the next one may.
//
// Bound: bytes.  K10 reads the queued entries and their table rows and
// writes a byte a neighbour.  K11 must read the hit plane (K (n + 1)
// bytes; n 4W in the row mode), visited where a hit is set, and
// write the new entries, their ids and the counters (the row mode: n 4W
// bytes of hits, the frontier written, the listed rows' ids and edges).
// A and C skip a 16-byte hit word that is zero, and C a tile with no new
// entry, so a thin wavefront costs about one pass over the hit plane.
#include "msbfs_common.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kTileBytes = 16 * msbfs::kThreads;
constexpr int kTileRows = msbfs::kThreads;
constexpr int kScanThreads = 1024;

__device__ __forceinline__ bool may_run(const int* updated, const int* level,
                                        const int* stop, int q) {
  return __ldcg(updated + q) != 0 && __ldcg(level + q) < __ldcg(stop + q);
}

// Exclusive prefix of x over the block's threads in thread order (the
// block a multiple of 32 threads); *total gets the block's sum.
__device__ __forceinline__ int block_exclusive(int x, int* total) {
  __shared__ int s_warp[32];
  const int lane = threadIdx.x & 31;
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

// offsets[0, m) -> their exclusive prefix, in place; returns the sum.
__device__ __forceinline__ int scan_in_place(int* off, int m) {
  const int per = (m + blockDim.x - 1) / blockDim.x;
  const int a = min(m, static_cast<int>(threadIdx.x) * per);
  const int b = min(m, a + per);
  int s = 0;
  for (int i = a; i < b; ++i) s += off[i];
  int total;
  int p = block_exclusive(s, &total);
  for (int i = a; i < b; ++i) {
    const int c = off[i];
    off[i] = p;
    p += c;
  }
  return total;
}

__device__ __forceinline__ int popc4(const uint4& x) {
  return __popc(x.x) + __popc(x.y) + __popc(x.z) + __popc(x.w);
}

// ---- K10 -------------------------------------------------------------------

__global__ void __launch_bounds__(msbfs::kThreads)
queue_expand_kernel(const int* __restrict__ rows, int w, int n, long long pitch,
                    uint8_t* hit, const int* __restrict__ queue, int cap,
                    const int* count, const int* level, const int* updated,
                    const int* stop, const int* ctrl) {
  if (__ldcg(ctrl) == 0) return;
  const int q = blockIdx.y;
  if (!may_run(updated, level, stop, q)) return;
  const int c = min(__ldcg(count + q), cap);
  const long long slots = static_cast<long long>(c) * w;
  const int* qq = queue + static_cast<long long>(q) * cap;
  uint8_t* h = hit + q * pitch;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < slots; i += step) {
    const long long u = __ldg(qq + i / w);
    const int v = __ldg(rows + u * w + i % w);
    if (v != n) h[v] = 1;
  }
}

// ---- K11, queue mode ---------------------------------------------------------

__global__ void __launch_bounds__(msbfs::kThreads)
queue_apply(uint8_t* hit, uint8_t* visited, long long pitch, int* offsets,
            int tiles, const int* level, const int* updated, const int* stop,
            const int* ctrl) {
  if (__ldcg(ctrl) == 0) return;
  const int q = blockIdx.y;
  const int t = blockIdx.x;
  int* off = offsets + static_cast<long long>(q) * (tiles + 1);
  if (!may_run(updated, level, stop, q)) {
    // C then finds no tile with entries for this query.
    if (threadIdx.x == 0) {
      off[t] = 0;
      if (t == 0) off[tiles] = 0;
    }
    return;
  }
  const long long b0 = static_cast<long long>(t) * kTileBytes + threadIdx.x * 16;
  int c = 0;
  if (b0 < pitch) {
    uint4* hp = reinterpret_cast<uint4*>(hit + q * pitch + b0);
    const uint4 h = *hp;
    if (h.x | h.y | h.z | h.w) {
      uint4* vp = reinterpret_cast<uint4*>(visited + q * pitch + b0);
      const uint4 v = *vp;
      // Bytes are 0 or 1: h & ~v is the byte-wise "hit and not visited".
      const uint4 nw = make_uint4(h.x & ~v.x, h.y & ~v.y, h.z & ~v.z, h.w & ~v.w);
      c = popc4(nw);
      if (c) *vp = make_uint4(v.x | nw.x, v.y | nw.y, v.z | nw.z, v.w | nw.w);
      *hp = nw;  // C lists these and clears them
    }
  }
  int total;
  block_exclusive(c, &total);
  if (threadIdx.x == 0) off[t] = total;
}

__global__ void __launch_bounds__(kScanThreads)
queue_scan(int* offsets, int tiles, int* count, long long* f, int* levels,
           int* reached, int* level, int* updated, const int* stop,
           int* max_count, const int* ctrl) {
  if (__ldcg(ctrl) == 0) return;
  const int q = blockIdx.x;
  if (!may_run(updated, level, stop, q)) return;
  int* off = offsets + static_cast<long long>(q) * (tiles + 1);
  const int total = scan_in_place(off, tiles);
  if (threadIdx.x == 0) {
    off[tiles] = total;
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

__global__ void __launch_bounds__(msbfs::kThreads)
queue_write(uint8_t* hit, long long pitch, const int* offsets, int tiles,
            int* queue, int cap, const int* level, const int* updated,
            const int* stop, int* ctrl, int K) {
  if (__ldcg(ctrl) == 0) return;
  const int q = blockIdx.y;
  const int t = blockIdx.x;
  const int* off = offsets + static_cast<long long>(q) * (tiles + 1);
  const int lo = __ldcg(off + t);
  if (__ldcg(off + t + 1) > lo) {  // block-uniform
    const long long b0 = static_cast<long long>(t) * kTileBytes + threadIdx.x * 16;
    uint4 nw = make_uint4(0u, 0u, 0u, 0u);
    uint4* hp = reinterpret_cast<uint4*>(hit + q * pitch + b0);
    if (b0 < pitch) nw = *hp;
    const int c = popc4(nw);
    int total;
    int slot = lo + block_exclusive(c, &total);
    if (c) {
      int* qq = queue + static_cast<long long>(q) * cap;
      const uint8_t* bytes = reinterpret_cast<const uint8_t*>(&nw);
      for (int i = 0; i < 16 && slot < cap; ++i) {
        if (bytes[i]) qq[slot++] = static_cast<int>(b0 + i);
      }
      *hp = make_uint4(0u, 0u, 0u, 0u);
    }
  }
  // The last block rewrites the go flag from the counters B advanced.
  __shared__ bool s_last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    s_last = atomicAdd(ctrl + 2, 1) == static_cast<int>(gridDim.x * gridDim.y) - 1;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  int go = 0;
  for (int i = threadIdx.x; i < K; i += blockDim.x) go |= may_run(updated, level, stop, i);
  go = __syncthreads_or(go);
  if (threadIdx.x == 0) {
    ctrl[0] = go;
    ctrl[2] = 0;
  }
}

// ---- K11, row mode -----------------------------------------------------------

__global__ void __launch_bounds__(msbfs::kThreads)
row_apply(uint32_t* hits, uint32_t* visited, uint32_t* frontier, long long n,
          int W, const int* __restrict__ degrees, int* offsets, int tiles,
          int* counts, bool smem_counts, const int* ctrl, int max_levels) {
  if (!msbfs::level_go(ctrl, max_levels)) return;
  extern __shared__ int s_counts[];
  if (smem_counts) {
    for (int i = threadIdx.x; i < 32 * W; i += blockDim.x) s_counts[i] = 0;
    __syncthreads();
  }
  int* cnt = smem_counts ? s_counts : counts;
  const long long r = static_cast<long long>(blockIdx.x) * kTileRows + threadIdx.x;
  int nz = 0;
  if (r < n) {
    for (int j = 0; j < W; ++j) {
      const long long i = r * W + j;
      const uint32_t h = hits[i];
      uint32_t nw = 0u;
      if (h) {
        const uint32_t v = visited[i];
        nw = h & ~v;
        if (nw) visited[i] = v | nw;
        hits[i] = 0u;
      }
      frontier[i] = nw;
      if (nw) nz = 1;
      while (nw) {
        const int b = __ffs(nw) - 1;
        nw &= nw - 1u;
        atomicAdd(cnt + 32 * j + b, 1);
      }
    }
  }
  int rows_total, edges_total;
  block_exclusive(nz, &rows_total);
  block_exclusive(nz ? __ldg(degrees + r) : 0, &edges_total);
  if (threadIdx.x == 0) {
    offsets[blockIdx.x] = rows_total;
    offsets[tiles + 1 + blockIdx.x] = edges_total;
  }
  if (smem_counts) {
    __syncthreads();
    for (int i = threadIdx.x; i < 32 * W; i += blockDim.x) {
      if (s_counts[i]) atomicAdd(counts + i, s_counts[i]);
    }
  }
}

__global__ void __launch_bounds__(kScanThreads)
row_scan(int* offsets, int tiles, int* count, long long* f, int* levels,
         int* reached, int* counts, int lanes, int* peak, long long* state,
         int cap, int* ctrl, int max_levels) {
  if (!msbfs::level_go(ctrl, max_levels)) return;
  const int lv = __ldcg(ctrl + 1);
  const int rows = scan_in_place(offsets, tiles);
  const int edges = scan_in_place(offsets + tiles + 1, tiles);
  int any = 0;
  for (int i = threadIdx.x; i < lanes; i += blockDim.x) {
    const int c = counts[i];
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
    offsets[tiles] = rows;
    offsets[2 * tiles + 1] = edges;
    count[0] = rows;
    // The JAX loop counts a frontier's rows when a level starts on it.
    if (lv + 1 < max_levels) peak[0] = max(peak[0], rows);
    state[msbfs::kListed] = min(rows, cap);
    // A list cut at the capacity: row_write stores its edges.
    if (rows <= cap) state[msbfs::kListedEdges] = edges;
    ctrl[0] = any;
    ctrl[1] = lv + 1;
  }
}

__global__ void __launch_bounds__(msbfs::kThreads)
row_write(const uint32_t* frontier, long long n, int W,
          const int* __restrict__ degrees, const int* offsets, int tiles,
          int* worklist, int cap, long long* state, const int* ctrl,
          int max_levels) {
  if (!msbfs::level_go(ctrl, max_levels)) return;  // the next level's gate
  const int lo = __ldcg(offsets + blockIdx.x);
  if (__ldcg(offsets + blockIdx.x + 1) == lo || lo >= cap) return;
  const long long r = static_cast<long long>(blockIdx.x) * kTileRows + threadIdx.x;
  int nz = 0;
  if (r < n) {
    for (int j = 0; j < W && !nz; ++j) nz = __ldcg(frontier + r * W + j) != 0u;
  }
  const int d = nz ? __ldg(degrees + r) : 0;
  int total;
  const int slot = lo + block_exclusive(nz, &total);
  const int first = __ldcg(offsets + tiles + 1 + blockIdx.x) + block_exclusive(d, &total);
  if (nz && slot < cap) {
    worklist[slot] = static_cast<int>(r);
    worklist[cap + slot] = first;
    if (slot == cap - 1) state[msbfs::kListedEdges] = first + d;
  }
}

}  // namespace

// K10.  rows: the (n + 1, w) table; hit: (K, pitch) bytes; queue: (K, cap).
extern "C" int msbfs_queue_expand(int device, const void* rows, int w,
                                  long long n, int K, long long pitch, void* hit,
                                  const void* queue, long long cap,
                                  const void* count, const void* level,
                                  const void* updated, const void* stop,
                                  const void* ctrl, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (w < 1 || n < 0 || n >= (1LL << 31) || K < 1 || K > 65535 || cap < 1 ||
      cap > (1LL << 31) - 1 || pitch < n + 1 || pitch % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  long long bx = (cap * w + msbfs::kThreads - 1) / msbfs::kThreads;
  bx = bx < 1 ? 1 : bx > 1024 ? 1024 : bx;
  queue_expand_kernel<<<dim3(static_cast<unsigned>(bx), K), msbfs::kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(rows), w, static_cast<int>(n), pitch,
      static_cast<uint8_t*>(hit), static_cast<const int*>(queue),
      static_cast<int>(cap), static_cast<const int*>(count),
      static_cast<const int*>(level), static_cast<const int*>(updated),
      static_cast<const int*>(stop), static_cast<const int*>(ctrl));
  return static_cast<int>(cudaGetLastError());
}

// K11.  mode 0 (queue): hit/visited (K = lanes, pitch) bytes, queue (K, cap),
// per-query count/f/levels/reached/level/updated/stop/peak (max_count),
// offsets (K, tiles + 1); frontier, counts, state and degrees unused.
// mode 1 (rows): hits/visited/frontier (n, W = lanes) words, queue the
// (2, cap) worklist (the listed rows, then each one's first edge in the
// level's edge space), count and peak (1,), f/levels/reached/counts (32W,),
// offsets (2, tiles + 1) (the tiles' rows, then their edges), state the
// worklist's (kSwitchWords,) int64, degrees (n,) the rows' out-degrees in
// the CSR K3 walks; level/updated/stop unused (the control is ctrl[0..1]).
extern "C" int msbfs_queue_compact(
    int device, int mode, void* hit, void* visited, void* frontier, long long n,
    int lanes, long long pitch, void* queue, long long cap, void* count, void* f,
    void* levels, void* reached, void* level, void* updated, const void* stop,
    void* peak, void* counts, void* offsets, int tiles, void* state,
    const void* degrees, void* ctrl, int max_levels, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* const c = static_cast<int*>(ctrl);
  int* const off = static_cast<int*>(offsets);
  if (n < 0 || n >= (1LL << 31) - 1 || lanes < 1 || cap < 0 ||
      cap > (1LL << 31) - 1 || tiles < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (mode == 0) {
    const int K = lanes;
    if (K > 65535 || pitch < n + 1 || pitch % 16 ||
        tiles != (pitch + kTileBytes - 1) / kTileBytes) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    uint8_t* const h = static_cast<uint8_t*>(hit);
    int* const lv = static_cast<int*>(level);
    int* const up = static_cast<int*>(updated);
    const int* const st = static_cast<const int*>(stop);
    const dim3 grid(static_cast<unsigned>(tiles), K);
    queue_apply<<<grid, msbfs::kThreads, 0, s>>>(
        h, static_cast<uint8_t*>(visited), pitch, off, tiles, lv, up, st, c);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    queue_scan<<<K, kScanThreads, 0, s>>>(
        off, tiles, static_cast<int*>(count), static_cast<long long*>(f),
        static_cast<int*>(levels), static_cast<int*>(reached), lv, up, st,
        static_cast<int*>(peak), c);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    queue_write<<<grid, msbfs::kThreads, 0, s>>>(
        h, pitch, off, tiles, static_cast<int*>(queue), static_cast<int>(cap), lv,
        up, st, c, K);
    return static_cast<int>(cudaGetLastError());
  }
  if (mode != 1) return static_cast<int>(cudaErrorInvalidValue);
  const int W = lanes;
  if (n * W >= (1LL << 31) || tiles != (n + kTileRows - 1) / kTileRows ||
      state == nullptr || degrees == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  uint32_t* const fr = static_cast<uint32_t*>(frontier);
  const int* const deg = static_cast<const int*>(degrees);
  long long* const st = static_cast<long long*>(state);
  // Per-lane counts in shared memory up to W = 256 (32 KB), else atomics
  // straight into the counts vector.
  const bool smem = W <= 256;
  row_apply<<<tiles, msbfs::kThreads, smem ? 32 * W * sizeof(int) : 0, s>>>(
      static_cast<uint32_t*>(hit), static_cast<uint32_t*>(visited), fr, n, W, deg,
      off, tiles, static_cast<int*>(counts), smem, c, max_levels);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  row_scan<<<1, kScanThreads, 0, s>>>(
      off, tiles, static_cast<int*>(count), static_cast<long long*>(f),
      static_cast<int*>(levels), static_cast<int*>(reached),
      static_cast<int*>(counts), 32 * W, static_cast<int*>(peak), st,
      static_cast<int>(cap), c, max_levels);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  row_write<<<tiles, msbfs::kThreads, 0, s>>>(
      fr, n, W, deg, off, tiles, static_cast<int*>(queue), static_cast<int>(cap), st, c,
      max_levels);
  return static_cast<int>(cudaGetLastError());
}

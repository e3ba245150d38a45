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
// it stays in the 50 MB L2).  Thread mapping, from a small host-built
// bucket table (off, rows, width, row_base, first thread; at most
// kMaxBuckets per level) that every block loads into shared memory and
// searches by thread index:
//   - narrow buckets (W_b <= 32): one thread per (row, word), word fastest,
//     looping over the row's W_b slots: the W threads of a row read the same
//     cols entries (one broadcast) and neighbouring words;
//   - wide buckets (W_b > 32, the hub chunk rows up to 256): one warp per
//     row, lanes striding over the slots (coalesced cols reads), a
//     shuffle-OR per word.
// Each bucket's thread range starts at a multiple of 32, so a warp never
// spans two buckets and the shuffle sees all 32 lanes.  One launch per
// forest level (level l reads level l-1's rows), then the gather; each is
// gated on the device control: it returns at once unless the level may run
// and ctrl[3] is the pull direction.
#include "msbfs_common.cuh"

namespace {

constexpr int kMaxBuckets = 64;
constexpr int kTab = 5;  // off, rows, width, row_base, first thread
constexpr int kMeta = 6;  // cols ptr, prev rows, out row offset, bucket
                          // begin, bucket count, threads

__global__ void __launch_bounds__(msbfs::kThreads)
forest_level_kernel(const uint32_t* __restrict__ prev, long long prev_rows,
                    const int* __restrict__ cols,
                    const long long* __restrict__ table, int nb,
                    uint32_t* __restrict__ out, int W, long long threads,
                    const int* __restrict__ ctrl, int max_levels) {
  if (!msbfs::direction_go(ctrl, max_levels, msbfs::kDirPull)) return;
  __shared__ long long s_tab[kMaxBuckets * kTab];
  for (int i = threadIdx.x; i < nb * kTab; i += blockDim.x) s_tab[i] = table[i];
  __syncthreads();
  const int lane = threadIdx.x & 31;
  for (long long t = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       t < threads; t += static_cast<long long>(gridDim.x) * blockDim.x) {
    // The last bucket whose first thread is <= t (warp-uniform).
    int lo = 0, hi = nb - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (s_tab[mid * kTab + 4] <= t) lo = mid; else hi = mid - 1;
    }
    const long long* b = s_tab + lo * kTab;
    const long long off = b[0], rows = b[1], row_base = b[3];
    const int width = static_cast<int>(b[2]);
    const long long local = t - b[4];
    if (width > 32) {
      const long long row = local >> 5;
      if (row >= rows) continue;  // warp-uniform
      const int* rc = cols + off + row * width;
      for (int w = 0; w < W; ++w) {
        uint32_t acc = 0u;
        for (int j = lane; j < width; j += 32) {
          const long long c = __ldg(rc + j);
          if (c < prev_rows) acc |= __ldg(prev + c * W + w);
        }
#pragma unroll
        for (int s = 16; s > 0; s >>= 1) acc |= __shfl_xor_sync(0xffffffffu, acc, s);
        if (lane == 0) out[(row_base + row) * W + w] = acc;
      }
    } else {
      const long long row = local / W;
      if (row >= rows) continue;
      const int w = static_cast<int>(local - row * W);
      const int* rc = cols + off + row * width;
      uint32_t acc = 0u;
      for (int j = 0; j < width; ++j) {
        const long long c = __ldg(rc + j);
        if (c < prev_rows) acc |= __ldg(prev + c * W + w);
      }
      out[(row_base + row) * W + w] = acc;
    }
  }
}

__global__ void __launch_bounds__(msbfs::kThreads)
forest_gather_kernel(const uint32_t* __restrict__ v_cat,
                     const int* __restrict__ final_slot,
                     uint32_t* __restrict__ hits, long long n, int W,
                     const int* __restrict__ ctrl, int max_levels) {
  if (!msbfs::direction_go(ctrl, max_levels, msbfs::kDirPull)) return;
  const long long total = n * W;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < total; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long v = i / W;
    const long long slot = __ldg(final_slot + v);
    hits[i] = __ldcg(v_cat + slot * W + (i - v * W));
  }
}

}  // namespace

extern "C" int msbfs_forest_or(int device, const void* frontier,
                               const void* table, const long long* meta,
                               int levels, void* scratch,
                               const void* final_slot, void* hits, long long n,
                               int W, long long total_rows, const void* ctrl,
                               int max_levels, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (W < 1 || n < 0 || levels < 0 || total_rows < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* c = static_cast<const int*>(ctrl);
  uint32_t* const v_cat = static_cast<uint32_t*>(scratch);
  const long long* tab = static_cast<const long long*>(table);
  for (int li = 0; li < levels; ++li) {
    const long long* m = meta + li * kMeta;
    const int nb = static_cast<int>(m[4]);
    if (nb > kMaxBuckets) return static_cast<int>(cudaErrorInvalidValue);
    if (m[5] == 0) continue;  // a level without rows
    const uint32_t* prev =
        li == 0 ? static_cast<const uint32_t*>(frontier)
                : v_cat + meta[(li - 1) * kMeta + 2] * W;
    forest_level_kernel<<<msbfs::grid_for(m[5], msbfs::kThreads),
                          msbfs::kThreads, 0, s>>>(
        prev, m[1], reinterpret_cast<const int*>(m[0]), tab + m[3] * kTab, nb,
        v_cat + m[2] * W, W, m[5], c, max_levels);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  forest_gather_kernel<<<msbfs::grid_for(n * W, msbfs::kThreads),
                         msbfs::kThreads, 0, s>>>(
      v_cat, static_cast<const int*>(final_slot),
      static_cast<uint32_t*>(hits), n, W, c, max_levels);
  return static_cast<int>(cudaGetLastError());
}

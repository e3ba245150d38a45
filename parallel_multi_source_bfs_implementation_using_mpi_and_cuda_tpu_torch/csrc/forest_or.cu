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
// K1's segment form (msbfs_forest_segment, msbfs_forest_gather) replaces
// the XLA chain of the host-streamed engine, the JAX package's
// ops/streamed.py:117 _segment_fold / :139 _segment_or / :146
// _final_hits: there the forest never enters device memory, and each BFS
// level streams its cols through a small ring of device buffers, one slot
// segment (a run of whole bucket rows, at most the slot budget) at a time.
// msbfs_forest_segment runs the same level kernel over one segment — the
// cols pointer of the buffer just uploaded, a per-segment bucket table
// (offsets relative to the segment, output rows relative to its first
// row) and the segment's first output row in the scratch — and
// msbfs_forest_gather is the final take by final_slot as its own launch.
// Bound: the same bytes as the whole-forest form (cols, the previous
// level's rows, the outputs), plus what the pipeline cannot hide: every
// BFS level uploads the whole forest over PCIe, so the streamed level is
// transfer-bound, not bound by this kernel.  A simple port: the level
// body is K1's own; a shared-memory frontier or live-row bits (as in
// flag_pull.cu) wait for a later pass.
#include "msbfs_common.cuh"

namespace {

constexpr int kMaxBuckets = 64;
constexpr int kTab = 6;   // off, rows, width, row_base, first run, rows per chunk
constexpr int kMeta = 6;  // cols ptr, prev rows, out row offset, bucket
                          // begin, bucket count, runs
constexpr int kWarps = msbfs::kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kPass = 8;  // words a pass of the generic width

// Chunks of 32 slots a warp has in flight, for rows read ``words`` words
// at a time: fewer at 8.
__host__ __device__ constexpr int run_chunks(int words) { return words >= 8 ? 2 : 4; }

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

// One forest level: runs of the buckets in table[0 .. nb), runs in all.
template <int W, bool kVec>
__global__ void __launch_bounds__(msbfs::kThreads)
forest_level_kernel(const uint32_t* __restrict__ prev, int prev_rows,
                    const int* __restrict__ cols,
                    const long long* __restrict__ table, int nb,
                    uint32_t* __restrict__ out, int w_rt, long long runs,
                    const int* __restrict__ ctrl, int max_levels) {
  if (!msbfs::direction_go(ctrl, max_levels, msbfs::kDirPull)) return;
  __shared__ long long s_tab[kMaxBuckets * kTab];
  for (int i = threadIdx.x; i < nb * kTab; i += blockDim.x) s_tab[i] = table[i];
  __syncthreads();
  constexpr int P = W ? W : kPass;
  constexpr int S = run_chunks(P);
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
          // distance d a lane holds its row's slots [lpos, lpos + 2d).
          for (int d = 1; d < width; d <<= 1) {
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

// hits[v] = v_cat[final_slot[v]], a vertex a thread, its row as vectors.
template <int W, bool kVec>
__global__ void __launch_bounds__(msbfs::kThreads)
forest_gather_kernel(const uint32_t* __restrict__ v_cat,
                     const int* __restrict__ final_slot,
                     uint32_t* __restrict__ hits, long long n, int w_rt,
                     const int* __restrict__ ctrl, int max_levels) {
  if (!msbfs::direction_go(ctrl, max_levels, msbfs::kDirPull)) return;
  const int Wd = W ? W : w_rt;
  for (long long v = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       v < n; v += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long slot = __ldg(final_slot + v);
    if constexpr (W != 0) {
      uint32_t x[W];
      ldcg_words<W, kVec>(x, v_cat + slot * W);
      store_words<W, kVec>(hits + v * W, x);
    } else {
      for (int w = 0; w < Wd; ++w) hits[v * Wd + w] = __ldcg(v_cat + slot * Wd + w);
    }
  }
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
  int W;
  const int* ctrl;
  int max_levels;
  cudaStream_t stream;
};

template <int W, bool kVec>
cudaError_t launch_level(const Args& a, int li) {
  const long long* m = a.meta + li * kMeta;
  const uint32_t* prev =
      li == 0 ? a.frontier : a.v_cat + a.meta[(li - 1) * kMeta + 2] * a.W;
  forest_level_kernel<W, kVec>
      <<<msbfs::grid_for(m[5] * 32, msbfs::kThreads), msbfs::kThreads, 0, a.stream>>>(
          prev, static_cast<int>(m[1]), reinterpret_cast<const int*>(m[0]),
          a.table + m[3] * kTab, static_cast<int>(m[4]), a.v_cat + m[2] * a.W, a.W,
          m[5], a.ctrl, a.max_levels);
  return cudaGetLastError();
}

template <int W, bool kVec>
cudaError_t run(const Args& a) {
  for (int li = 0; li < a.levels; ++li) {
    if (a.meta[li * kMeta + 5] == 0) continue;  // a level without rows
    const cudaError_t err = launch_level<W, kVec>(a, li);
    if (err != cudaSuccess) return err;
  }
  forest_gather_kernel<W, kVec>
      <<<msbfs::grid_for(a.n, msbfs::kThreads), msbfs::kThreads, 0, a.stream>>>(
          a.v_cat, a.final_slot, a.hits, a.n, a.W, a.ctrl, a.max_levels);
  return cudaGetLastError();
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

// One streamed segment: the level kernel over ``runs`` runs of the
// segment's ``buckets`` bucket pieces (table: (buckets, kTab) int64 on the
// device, slot offsets relative to ``cols``, first rows relative to
// ``out``).  prev: the previous level's (prev_rows, W) value rows (the
// frontier at forest level 0); a slot equal to prev_rows reads zero.
extern "C" int msbfs_forest_segment(int device, const void* prev,
                                    long long prev_rows, const void* cols,
                                    const void* table, int buckets,
                                    long long runs, void* out, int W,
                                    int chunks, int vec16, const void* ctrl,
                                    int max_levels, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int P = W == 1 || W == 2 || W == 4 || W == 8 ? W : kPass;
  if (W < 1 || prev_rows < 0 || prev_rows >= (1LL << 31) || buckets < 1 ||
      buckets > kMaxBuckets || runs < 1 || chunks != run_chunks(P)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* p = static_cast<const uint32_t*>(prev);
  const auto* c = static_cast<const int*>(cols);
  const auto* t = static_cast<const long long*>(table);
  auto* o = static_cast<uint32_t*>(out);
  const auto* g = static_cast<const int*>(ctrl);
  const int grid = msbfs::grid_for(runs * 32, msbfs::kThreads);
  const auto s = static_cast<cudaStream_t>(stream);
  const int rows = static_cast<int>(prev_rows);
#define MSBFS_SEGMENT(WW, VEC)                                                \
  forest_level_kernel<WW, VEC><<<grid, msbfs::kThreads, 0, s>>>(              \
      p, rows, c, t, buckets, o, W, runs, g, max_levels)
  switch (vec16 ? W : -W) {
    case 2: MSBFS_SEGMENT(2, true); break;
    case 4: MSBFS_SEGMENT(4, true); break;
    case 8: MSBFS_SEGMENT(8, true); break;
    case 1: case -1: MSBFS_SEGMENT(1, false); break;
    case -2: MSBFS_SEGMENT(2, false); break;
    case -4: MSBFS_SEGMENT(4, false); break;
    case -8: MSBFS_SEGMENT(8, false); break;
    default: MSBFS_SEGMENT(0, false); break;
  }
#undef MSBFS_SEGMENT
  return static_cast<int>(cudaGetLastError());
}

// The final take of the segment form: hits[v] = v_cat[final_slot[v]] over
// the (total_rows + 1, W) scratch of all forest levels, last row zero.
extern "C" int msbfs_forest_gather(int device, const void* v_cat,
                                   const void* final_slot, void* hits,
                                   long long n, int W, int vec16,
                                   const void* ctrl, int max_levels,
                                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (W < 1 || n < 1 || n >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* v = static_cast<const uint32_t*>(v_cat);
  const auto* f = static_cast<const int*>(final_slot);
  auto* h = static_cast<uint32_t*>(hits);
  const auto* g = static_cast<const int*>(ctrl);
  const int grid = msbfs::grid_for(n, msbfs::kThreads);
  const auto s = static_cast<cudaStream_t>(stream);
#define MSBFS_GATHER(WW, VEC)                                                 \
  forest_gather_kernel<WW, VEC><<<grid, msbfs::kThreads, 0, s>>>(             \
      v, f, h, n, W, g, max_levels)
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
  return static_cast<int>(cudaGetLastError());
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
  a.W = W;
  a.ctrl = static_cast<const int*>(ctrl);
  a.max_levels = max_levels;
  a.stream = static_cast<cudaStream_t>(stream);
  err = vec16 ? dispatch<true>(a) : dispatch<false>(a);
  return static_cast<int>(err);
}

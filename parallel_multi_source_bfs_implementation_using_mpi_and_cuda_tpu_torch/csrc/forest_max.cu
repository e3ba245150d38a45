// Kernel M4 — the BELL reduction forest max-fold over int32 neg-distance
// lanes, with the async drive's candidate step fused into it and, in its
// take form, the forest's final take by final_slot.
//
// Replaces the XLA chains of the JAX package's 2D mesh async drive:
// parallel/partition2d.py:1116 forest_max (ops/bell.py forest_hits with a
// max over each bucket's width, then :1070 _async_cand on the gathered
// maxima) and the streamed residency's ops/streamed.py:117
// _segment_fold(..., fold="max").  One launch folds one forest level, or
// one uploaded slot segment of it, over (rows, W) int32 planes (W lanes a
// row, one query a lane, 0 = unreached):
//
//   out[row_base_b + r, w] = MAX_{j < W_b} f(prev[cols[off_b + r*W_b + j], w])
//
// a slot equal to prev_rows reading 0.  ``cand`` applies
//   f(x) = y >= floor ? y : 0,  y = max(x - 1, 0)
// to every value read (forest level 0, whose prev is the gathered col
// block), else f(x) = x.  f is monotone and f(0) = 0, so applying it
// before the max equals JAX's _async_cand after the forest (one more hop
// is one level further; the horizon ``floor`` = NEG_BASE - max_levels
// zeroes a candidate beyond it).
//
// The take form (``final_slot`` given) computes the forest's last level
// in the final row order and writes the (n, W) hits directly: output row v
// reads s = final_slot[v]; a row of the last level (s - last_off in [0,
// last level rows)) is folded as above, a row of an earlier level (s <
// last_off) is copied from the scratch of level outputs, and the sentinel
// (s >= total_rows) writes 0.  Gated on the device control as K1s's
// forest_gather (the pull direction).  A one-level forest — every road
// tile of the 2D mesh — is then one launch, and its level output never
// makes the round trip through scratch (32.5 MB written and read back on
// the widest road-1024 tile).
//
// The commit form (``msbfs_forest_max_commit``, the async drive's local
// waves: partition2d.py ``_local_waves``, JAX's ``neg_relax_chunk`` over
// ``neg_commit``) is the take form restricted to the shard's own output
// rows [row0, row0 + rows): each folded row is committed into the own neg
// plane as M1's commit epilogue does (neg_commit.cuh: neg, delta, changed
// ORed, the next wave's send delta ? cand : 0, the flag set to the wave's
// tag), and no hit row is written.  The wave reads only its own rows, so
// the other C - 1 of the tile's C row chunks are neither folded nor
// stored, and the own rows never make the round trip through the hit
// plane into M1 (a local wave was M4, M1 and four torch launches: the
// send's where / zeros / copy and the flag's fill).
//
// Design.  A group of G lanes owns an output row (G a power of two, at
// most 32: a warp holds 32 / G rows).  A lane takes one 16-byte vector of
// the row's lanes when W is a multiple of 4 and the planes are aligned
// (G = W / 4: 8 lanes a row at W = 32), else one int32 lane (G = W); rows
// wider than 32 units loop over them.  The group finds its row's bucket
// once, by binary search of the level's bucket table in shared memory,
// loads G of the row's cols entries with one coalesced load and hands them
// round with __shfl_sync; kUnroll source rows are in flight at once.  A
// warp's loops run to the widest row it holds, so the shuffles stay
// convergent.  Source rows are read through the read-only cache.  The grid
// strides over the rows in at most msbfs::kMaxBlocks blocks.
//
// Bound: bytes — the level's cols once (4 bytes a slot), each distinct
// source row its live slots name (4 W bytes; a road tile's source row
// feeds several output rows), the output rows written; with the take also
// final_slot (4 bytes a row) and, for copied rows, their scratch rows.
// The one-thread-per-(row, lane) parent took 0.0752-0.0761 ms on the
// widest road-1024 tile against a 0.0204 ms bound (NVIDIA H100 80GB HBM3,
// 700 W, chip_smoke.py): 32 threads searched the bucket table for one row,
// each with a 64-bit division, and a warp had one row read in flight.
// This one (chip_probe_forest_max.py, same card) folds that level in about
// 0.061 ms and takes it into the tile's 524,288 hit rows in 0.092 against
// 0.0313: every row is a chain of dependent reads (final slot, cols,
// source rows) and the registers that more rows in flight would need cost
// resident warps; the int32 instance at W = 32 (a warp a row) takes 0.16.
#include <type_traits>

#include "msbfs_common.cuh"
#include "neg_commit.cuh"

namespace {

constexpr int kMaxBuckets = 64;
constexpr int kTab = 6;  // off, rows, width, row_base, (first run, rows per chunk: unused)
constexpr unsigned kFull = 0xffffffffu;
// Source rows a group has in flight for one output row
// (chip_probe_forest_max.py: 4 and 8 cost registers and so resident warps,
// and ran slower).
constexpr int kUnroll = 2;

// One launch's arguments.
struct Fold {
  const void* prev;  // (prev_rows, W) int32; a slot equal to prev_rows reads 0
  long long prev_rows;
  const int* cols;
  const long long* table;  // (nb, kTab): the level's (or segment's) buckets
  int nb;
  long long rows;  // output rows: the level's (or segment's), or n with the take
  void* out;
  int units;  // units a row: W int32 lanes, or W / 4 vectors
  int group;  // lanes a row
  int floor;
  // The take: final_slot (n,) int32, the scratch of earlier levels' rows,
  // the last level's first row in it, the forest's rows (the sentinel).
  const int* final_slot;
  const void* scratch;
  long long last_off;
  long long total_rows;
  const int* ctrl;
  int max_levels;
  // The commit form: the output rows are final rows row0 + [0, rows),
  // committed into ``commit`` (its planes (rows, W)).
  long long row0;
  msbfs::NegCommit commit;
};

template <bool kCand>
__device__ __forceinline__ int step(int v, int floor) {
  if constexpr (kCand) {
    v = v > 1 ? v - 1 : 0;
    if (v < floor) v = 0;
  }
  return v;
}

template <bool kCand>
__device__ __forceinline__ int4 step(int4 v, int floor) {
  return make_int4(step<kCand>(v.x, floor), step<kCand>(v.y, floor), step<kCand>(v.z, floor),
                   step<kCand>(v.w, floor));
}

__device__ __forceinline__ int vmax(int a, int b) { return max(a, b); }

__device__ __forceinline__ int4 vmax(int4 a, int4 b) {
  return make_int4(max(a.x, b.x), max(a.y, b.y), max(a.z, b.z), max(a.w, b.w));
}

// A source row's unit, through the read-only cache (L2-only reads ran the
// same: chip_probe_forest_max.py's ``ldcg``).
template <typename T>
__device__ __forceinline__ T load_row(const T* p) {
  return __ldg(p);
}

template <typename T>
__device__ __forceinline__ T zero_unit() {
  if constexpr (std::is_same<T, int4>::value) {
    return make_int4(0, 0, 0, 0);
  } else {
    return 0;
  }
}

template <bool kVec, bool kCand, bool kTake, bool kCommit>
__global__ void __launch_bounds__(msbfs::kThreads) forest_max_kernel(const Fold a) {
  static_assert(kTake || !kCommit, "the commit form is a form of the take");
  using T = typename std::conditional<kVec, int4, int>::type;
  if constexpr (kTake) {
    if (!msbfs::direction_go(a.ctrl, a.max_levels, msbfs::kDirPull)) return;
  }
  __shared__ long long s_tab[kMaxBuckets * kTab];
  for (int i = threadIdx.x; i < a.nb * kTab; i += blockDim.x) s_tab[i] = a.table[i];
  __syncthreads();
  const T* prev = static_cast<const T*>(a.prev);
  T* out = static_cast<T*>(a.out);
  const int U = a.units, G = a.group;
  const int lane = threadIdx.x & 31;
  const int q = lane & (G - 1);
  const int per_warp = 32 / G;
  const long long warps = static_cast<long long>(gridDim.x) * (blockDim.x >> 5);
  const long long warp =
      blockIdx.x * static_cast<long long>(blockDim.x >> 5) + (threadIdx.x >> 5);
  bool improved = false;
  // A warp takes per_warp consecutive rows at a time, a row a group.
  for (long long first = warp * per_warp; first < a.rows; first += warps * per_warp) {
    const long long v = first + lane / G;
    long long r = -1, copy = -1;  // the level row to fold, the scratch row to copy
    if (v < a.rows) {
      if constexpr (kTake) {
        const long long s = __ldg(a.final_slot + a.row0 + v);
        if (s < a.last_off) {
          copy = s;
        } else if (s < a.total_rows) {
          r = s - a.last_off;
        }
      } else {
        r = v;
      }
    }
    int width = 0;
    long long c0 = 0;
    if (r >= 0) {
      // The last bucket whose first row is <= r.
      int lo = 0, hi = a.nb - 1;
      while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (s_tab[mid * kTab + 3] <= r) lo = mid; else hi = mid - 1;
      }
      const long long* b = s_tab + lo * kTab;
      width = static_cast<int>(b[2]);
      c0 = b[0] + (r - b[3]) * width;
    }
    const int span = __reduce_max_sync(kFull, width);
    for (int u0 = 0; u0 < U; u0 += G) {
      const int u = u0 + q;
      const bool mine = u < U;
      T acc = zero_unit<T>();
      for (int j0 = 0; j0 < span; j0 += G) {
        const int col =
            j0 + q < width ? __ldg(a.cols + c0 + j0 + q) : static_cast<int>(a.prev_rows);
        for (int jj = 0; jj < G && j0 + jj < span; jj += kUnroll) {
          int src[kUnroll];
          T x[kUnroll];
#pragma unroll
          for (int i = 0; i < kUnroll; ++i) src[i] = __shfl_sync(kFull, col, jj + i, G);
#pragma unroll
          for (int i = 0; i < kUnroll; ++i) {
            const T* row = prev + src[i] * static_cast<long long>(U);
            x[i] = mine && jj + i < G && src[i] < a.prev_rows
                       ? step<kCand>(load_row(row + u), a.floor)
                       : zero_unit<T>();
          }
#pragma unroll
          for (int i = 0; i < kUnroll; ++i) acc = vmax(acc, x[i]);
        }
      }
      if constexpr (kTake) {
        if (copy >= 0 && mine) acc = __ldg(static_cast<const T*>(a.scratch) + copy * U + u);
      }
      if (v < a.rows && mine) {
        if constexpr (kCommit) {
          if constexpr (kVec) {
            improved |= msbfs::commit_quad(a.commit, acc, v * U + u);
          } else {
            improved |= msbfs::commit_lane(a.commit, acc, v * U + u);
          }
        } else {
          out[v * U + u] = acc;
        }
      }
    }
  }
  if constexpr (kCommit) msbfs::commit_flag(a.commit, improved);
}

// form: 0 the level, 1 the take, 2 the commit.
template <bool kVec, bool kCand, bool kTake, bool kCommit>
void launch_fold(const Fold& a, cudaStream_t s) {
  const int rows_a_block = (msbfs::kThreads / 32) * (32 / a.group);
  forest_max_kernel<kVec, kCand, kTake, kCommit>
      <<<msbfs::grid_for(a.rows, rows_a_block), msbfs::kThreads, 0, s>>>(a);
}

template <bool kVec, bool kCand>
void launch_fold(const Fold& a, int form, cudaStream_t s) {
  if (form == 2) {
    launch_fold<kVec, kCand, true, true>(a, s);
  } else if (form == 1) {
    launch_fold<kVec, kCand, true, false>(a, s);
  } else {
    launch_fold<kVec, kCand, false, false>(a, s);
  }
}

void launch_form(const Fold& a, bool vec, bool cand, int form, cudaStream_t s) {
  if (vec) {
    cand ? launch_fold<true, true>(a, form, s) : launch_fold<true, false>(a, form, s);
  } else {
    cand ? launch_fold<false, true>(a, form, s) : launch_fold<false, false>(a, form, s);
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// One forest level or segment: table (buckets, 6) int64 on the device
// (slot offsets relative to ``cols``, first rows relative to the level),
// prev (prev_rows, W) int32.  cand: 1 applies the candidate step with
// ``floor`` to every value read.  vec: 1 reads rows as 16-byte vectors (W
// a multiple of 4, every plane 16-byte aligned).
// Without ``final_slot``: ``rows`` output rows of the level into ``out``.
// With it (the take form): ``rows`` = n output rows of ``out`` (the hits),
// the table the last level's, ``scratch`` the earlier levels' rows (its
// last level starting at row ``last_off``, the forest ``total_rows``
// rows); gated on ``ctrl`` (direction_go at ``max_levels``, the pull).
extern "C" int msbfs_forest_max(int device, const void* prev, long long prev_rows,
                                const void* cols, const void* table, int buckets,
                                long long rows, void* out, int W, int cand, int floor, int vec,
                                const void* final_slot, const void* scratch, long long last_off,
                                long long total_rows, const void* ctrl, int max_levels,
                                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool take = final_slot != nullptr;
  if (W < 1 || prev_rows < 0 || prev_rows >= (1LL << 31) || buckets < (take ? 0 : 1) ||
      buckets > kMaxBuckets || rows < 0 || (cand != 0 && cand != 1) || (vec != 0 && vec != 1) ||
      (vec && (W % 4 != 0 || !aligned16(prev) || !aligned16(out) ||
               (take && last_off > 0 && !aligned16(scratch)))) ||
      (take && (ctrl == nullptr || last_off < 0 || total_rows < last_off ||
                (last_off > 0 && scratch == nullptr)))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rows == 0) return static_cast<int>(cudaSuccess);
  Fold a{};
  a.prev = prev;
  a.prev_rows = prev_rows;
  a.cols = static_cast<const int*>(cols);
  a.table = static_cast<const long long*>(table);
  a.nb = buckets;
  a.rows = rows;
  a.out = out;
  a.units = vec ? W / 4 : W;
  a.group = 1;
  while (a.group < a.units && a.group < 32) a.group <<= 1;
  a.floor = floor;
  a.final_slot = static_cast<const int*>(final_slot);
  a.scratch = scratch;
  a.last_off = last_off;
  a.total_rows = total_rows;
  a.ctrl = static_cast<const int*>(ctrl);
  a.max_levels = max_levels;
  launch_form(a, vec, cand, take ? 1 : 0, static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

// The commit form: the take form's arguments (table the last level's,
// ``scratch`` the earlier levels' rows, final_slot (total final rows,)
// int32), but only final rows [row0, row0 + rows) are folded, each
// committed into the (rows, W) planes neg (int32, in place), delta (uint8,
// written), acc (uint8, ORed with delta, or set to it with acc_set; or
// null) and send (int32, delta ? cand : 0; or null), and flag (int32, or
// null) set to ``tag`` on any delta; no hit row is written.  vec: 1 also
// needs neg and send 16-byte aligned and delta and acc 4-byte aligned.
// Gated as the take.
extern "C" int msbfs_forest_max_commit(int device, const void* prev, long long prev_rows,
                                       const void* cols, const void* table, int buckets, int W,
                                       int cand, int floor, int vec, const void* final_slot,
                                       const void* scratch, long long last_off,
                                       long long total_rows, const void* ctrl, int max_levels,
                                       long long row0, long long rows, void* neg, void* delta,
                                       void* acc, int acc_set, void* flag, int tag, void* send,
                                       void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const msbfs::NegCommit c{static_cast<int*>(neg), static_cast<uint8_t*>(delta),
                           static_cast<uint8_t*>(acc), static_cast<int*>(send),
                           static_cast<int*>(flag), acc_set, tag};
  if (W < 1 || prev_rows < 0 || prev_rows >= (1LL << 31) || buckets < 0 ||
      buckets > kMaxBuckets || row0 < 0 || rows < 0 || (cand != 0 && cand != 1) ||
      (vec != 0 && vec != 1) || (acc_set != 0 && acc_set != 1) || final_slot == nullptr ||
      ctrl == nullptr || neg == nullptr || delta == nullptr || last_off < 0 ||
      total_rows < last_off || (last_off > 0 && scratch == nullptr) ||
      (vec && (W % 4 != 0 || !aligned16(prev) || !msbfs::quad_aligned(c) ||
               (last_off > 0 && !aligned16(scratch))))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rows == 0) return static_cast<int>(cudaSuccess);
  Fold a{};
  a.prev = prev;
  a.prev_rows = prev_rows;
  a.cols = static_cast<const int*>(cols);
  a.table = static_cast<const long long*>(table);
  a.nb = buckets;
  a.rows = rows;
  a.units = vec ? W / 4 : W;
  a.group = 1;
  while (a.group < a.units && a.group < 32) a.group <<= 1;
  a.floor = floor;
  a.final_slot = static_cast<const int*>(final_slot);
  a.scratch = scratch;
  a.last_off = last_off;
  a.total_rows = total_rows;
  a.ctrl = static_cast<const int*>(ctrl);
  a.max_levels = max_levels;
  a.row0 = row0;
  a.commit = c;
  launch_form(a, vec, cand, 2, static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

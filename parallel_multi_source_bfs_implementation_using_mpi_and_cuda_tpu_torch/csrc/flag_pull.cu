// Kernel K5's pull — the byte-flag BELL forest with the visited mask.
//
// Replaces the JAX package's ops/bell.py:144 bell_hits_packed as its
// byte-flag engines consume it: ops/lowk.py:126 lowk_expand's pull
// (``jnp.where(visited > 0, 0, hits)``) and ops/bell.py:149
// bell_expand_packed (``(dist == -1) & (hits > 0)``).  For (n, Kp) uint8
// 0/1 planes (query q in byte q of a row, Kp = 4 Wd, read here as Wd
// uint32 words) over the forest's buckets:
//
//   hits[v, q] = (OR over v's dedup neighbours u of frontier[u, q])
//                AND NOT visited[v, q]
//
// The forest is forest_or.cu's: level 0 ORs the frontier rows of each
// padded slot, level l >= 1 the rows of level l - 1, every level output
// lives in one (total_rows + 1, Wd) scratch ``v_cat`` whose last row is
// zero, and the vertex's value is its ``final_slot`` row.
//
// Bound: bytes.  The function must read the frontier and visited planes
// and the cols of the rows it needs, and write the hit plane.  The frontier
// reads of the slots are random 32-byte L2 sectors (one a slot at Kp <= 32,
// two at Kp = 64), and on a dense level they, not device memory, set the
// floor (35.1M slots at RMAT-20).  So the design reads fewer of them:
//
//   - A lane *active* at this level is a real lane (byte q < k) whose
//     query's frontier is not empty: with ``lane_levels`` (the carry's
//     per-lane level counters, query q at lane 8q), levels[8q] == ctrl[1]
//     + 1; without, every real lane.  A row is *live* when its owner vertex
//     has an active lane it has not visited.  A row that is not live needs
//     no value: every lane of its owner's hits is either visited (masked)
//     or inactive (its frontier column is zero, so its OR is zero).
//   - A pre-pass launch writes the live bit of every forest row (from
//     ``row_owner``, the owner of each row at every level) and, where the
//     plan says so, the union frontier as one bit a vertex.
//   - A level launch walks the buckets as forest_or.cu does (a warp a run
//     of consecutive rows from a shared-memory bucket table; narrow rows in
//     32-lane chunks with a segmented shuffle, a warp a wide row).  A warp
//     first looks at 32 runs at once, a lane each, and walks only those
//     with a live row, so a level whose rows are mostly dead is not a
//     chain of dependent loads.  A lane whose row is not live loads neither
//     its cols nor a frontier row (the live bits of a chunk's rows are
//     consecutive, so one word covers it), and a chunk that read no source
//     row skips its shuffles.
//   - With the bitmap (n / 8 bytes) in shared memory, a level-0 slot whose
//     source is not in the frontier costs a shared-memory lookup and no L2
//     sector.  At k = 1 the bitmap is the frontier, so that instance reads
//     no frontier row at all.  Such a block holds up to 227 KB, one a
//     streaming multiprocessor at RMAT-20, so it takes 512 or 1024 threads.
//   - A warp on a wide row (hub chunk rows, the second forest level) stops
//     once its OR covers every active lane its owner has not visited
//     (Beamer's bottom-up exit).
//   - The final gather writes 0 for a vertex whose rows are not live and
//     does not read its v_cat row, which may hold an earlier level's value:
//     a row that is not live is not written.  A live level-1 row reads only
//     level-0 rows of its own owner, so those are live and fresh too.
//
// The live and exit rules rest on the byte planes' contract: bytes are 0 or
// 1, and a lane the mask calls inactive has no frontier byte set.  At Kp =
// 64 (the bell route) a row is four 16-byte loads in one pass, through L1
// so that the second 32-byte sector of a row comes from the line the first
// load brought; at Kp = 4 (the low-K route) one word through L2 only;
// other widths pass over 8 words at a time.
// Every launch is gated on the device control as forest_or.cu's are: it
// returns at once unless the level may run and ctrl[3] is the pull.
#include "msbfs_common.cuh"

namespace {

constexpr int kMaxBuckets = 64;
constexpr int kTab = 6;   // off, rows, width, row_base, first run, rows per chunk
constexpr int kMeta = 6;  // cols ptr, prev rows, out row offset, bucket
                          // begin, bucket count, runs
constexpr unsigned kFull = 0xffffffffu;
constexpr int kPass = 8;  // words a pass of the generic width

// Chunks of 32 slots a warp has in flight (the host's run table is cut
// for it): eight one-word rows, four of 16 words, two generic passes
// (sixteen one-word rows spill at the 64 registers of a 1024-thread block).
__host__ __device__ constexpr int run_chunks(int w) { return w == 1 ? 8 : w == 16 ? 4 : 2; }
// 32-slot chunks a warp reads of a wide row between two checks of the
// bottom-up exit: a 256-slot hub chunk row is four steps.
constexpr int kWideChunks = 2;

// Threads a block of a level launch: the bitmap instances are one or two
// blocks a multiprocessor, so they take large blocks (1024 threads leave
// 64 registers a thread: enough at one word a row, not at 16).
__host__ __device__ constexpr int level_threads(int w, bool map) {
  return !map ? msbfs::kThreads : (w == 1 ? 1024 : 512);
}

// Rows read in more than one load (16 words, the generic width's passes)
// go through L1: a warp's first load of 32 rows brings the 32-byte
// sectors that its next loads read.  One-load rows go through L2 only.
__host__ __device__ constexpr bool via_l1(int p) { return p > 4; }

template <bool kL1, typename T>
__device__ __forceinline__ T load(const T* p) {
  if constexpr (kL1) return __ldg(p); else return __ldcg(p);
}

// P words at p: 16-byte vectors where the plane allows.
template <int P, bool kVec>
__device__ __forceinline__ void ldcg_words(uint32_t (&out)[P],
                                           const uint32_t* p) {
  constexpr bool kL1 = via_l1(P);
  if constexpr (kVec && P % 4 == 0) {
#pragma unroll
    for (int i = 0; i < P; i += 4) {
      const uint4 x = load<kL1>(reinterpret_cast<const uint4*>(p + i));
      out[i] = x.x; out[i + 1] = x.y; out[i + 2] = x.z; out[i + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < P; ++i) out[i] = load<kL1>(p + i);
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
  } else {
#pragma unroll
    for (int i = 0; i < P; ++i) p[i] = in[i];
  }
}

// Words [w0, w0 + nw) of row c (Wd words a row) into x, zero past nw: the
// whole row at a template width (w0 == 0, nw == W), else nw <= P scalars.
template <int W, bool kVec, int P>
__device__ __forceinline__ void load_row(uint32_t (&x)[P],
                                         const uint32_t* __restrict__ plane,
                                         long long c, int Wd, int w0, int nw) {
  if constexpr (W != 0) {
    ldcg_words<W, kVec>(x, plane + c * W);
  } else {
    const uint32_t* row = plane + c * Wd + w0;
#pragma unroll
    for (int i = 0; i < P; ++i) x[i] = i < nw ? load<via_l1(P)>(row + i) : 0u;
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

__device__ __forceinline__ bool bit_of(const uint32_t* __restrict__ bits,
                                       long long i) {
  return (__ldg(bits + (i >> 5)) >> (i & 31)) & 1u;
}

// Is any of bits [a, b) set?
__device__ __forceinline__ bool any_bit(const uint32_t* __restrict__ bits,
                                        long long a, long long b) {
  for (long long w = a >> 5; w << 5 < b; ++w) {
    uint32_t x = __ldg(bits + w);
    if (a > w << 5) x &= ~0u << (a - (w << 5));
    if (b < (w + 1) << 5) x &= ~0u >> (((w + 1) << 5) - b);
    if (x) return true;
  }
  return false;
}

// The last bucket of the table whose first run is <= run.
__device__ __forceinline__ int bucket_of(const long long* s_tab, int nb,
                                         long long run) {
  int lo = 0, hi = nb - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (s_tab[mid * kTab + 4] <= run) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// The active-lane mask, one 0x01 byte a lane (Wd words into s_mask).
__device__ __forceinline__ void active_mask(uint32_t* s_mask, int Wd, int k,
                                            const int* __restrict__ lane_levels,
                                            const int* __restrict__ ctrl) {
  const int level = __ldcg(ctrl + 1);
  for (int w = threadIdx.x; w < Wd; w += blockDim.x) {
    uint32_t m = 0;
    for (int j = 0; j < 4; ++j) {
      const int q = 4 * w + j;
      const bool on = q < k && (lane_levels == nullptr ||
                                __ldcg(lane_levels + 8 * q) == level + 1);
      if (on) m |= 1u << (8 * j);
    }
    s_mask[w] = m;
  }
}

// The pre-pass: the active mask (block 0 stores it for the later
// launches), then warp units of 32 bits — the frontier bitmap's words
// (map_units of them: bit v = frontier row v is nonzero) and the live
// bits of the forest's rows.
template <int W, bool kVec>
__global__ void __launch_bounds__(msbfs::kThreads)
flag_prepass_kernel(const uint32_t* __restrict__ frontier,
                    const uint32_t* __restrict__ visited,
                    const int* __restrict__ lane_levels, int k,
                    const int* __restrict__ row_owner, long long n,
                    long long total_rows, int w_rt,
                    uint32_t* __restrict__ fmap, long long map_units,
                    uint32_t* __restrict__ live, uint32_t* __restrict__ mask,
                    const int* __restrict__ ctrl, int max_levels) {
  if (!msbfs::direction_go(ctrl, max_levels, msbfs::kDirPull)) return;
  extern __shared__ uint32_t s_mask[];
  const int Wd = W ? W : w_rt;
  active_mask(s_mask, Wd, k, lane_levels, ctrl);
  __syncthreads();
  if (blockIdx.x == 0) {
    for (int w = threadIdx.x; w < Wd; w += blockDim.x) mask[w] = s_mask[w];
  }
  constexpr int P = W ? W : kPass;
  const int lane = threadIdx.x & 31;
  const long long units = map_units + ((total_rows + 31) >> 5);
  const long long warps = static_cast<long long>(gridDim.x) * (blockDim.x >> 5);
  for (long long u = blockIdx.x * static_cast<long long>(blockDim.x >> 5) + (threadIdx.x >> 5);
       u < units; u += warps) {
    bool on = false;
    if (u < map_units) {
      const long long v = u * 32 + lane;
      if (v < n) {
        for (int w0 = 0; w0 < Wd && !on; w0 += P) {
          uint32_t x[P];
          load_row<W, kVec, P>(x, frontier, v, Wd, w0, min(P, Wd - w0));
#pragma unroll
          for (int i = 0; i < P; ++i) on |= x[i] != 0u;
        }
      }
      const unsigned word = __ballot_sync(kFull, on);
      if (lane == 0) fmap[u] = word;
    } else {
      const long long r = (u - map_units) * 32 + lane;
      if (r < total_rows) {
        const long long o = __ldg(row_owner + r);
        for (int w0 = 0; w0 < Wd && !on; w0 += P) {
          const int nw = min(P, Wd - w0);
          uint32_t x[P];
          load_row<W, kVec, P>(x, visited, o, Wd, w0, nw);
#pragma unroll
          for (int i = 0; i < P; ++i) {
            if (i < nw) on |= (s_mask[w0 + i] & ~x[i]) != 0u;
          }
        }
      }
      const unsigned word = __ballot_sync(kFull, on);
      if (lane == 0) live[u - map_units] = word;
    }
  }
}

// One forest level over the live rows: runs of the buckets in table[0 ..
// nb).  kMap: level 0 with the frontier bitmap staged in shared memory;
// kBits: k = 1, the bitmap is the frontier and no frontier row is read.
template <int W, bool kVec, bool kMap, bool kBits>
__global__ void __launch_bounds__(level_threads(W, kMap))
flag_level_kernel(const uint32_t* __restrict__ prev, int prev_rows,
                  const int* __restrict__ cols,
                  const long long* __restrict__ table, int nb,
                  uint32_t* __restrict__ v_cat, long long out_off, int w_rt,
                  long long runs, const uint32_t* __restrict__ live,
                  const uint32_t* __restrict__ fmap, int map_words,
                  const int* __restrict__ row_owner,
                  const uint32_t* __restrict__ visited,
                  const uint32_t* __restrict__ mask,
                  const int* __restrict__ ctrl, int max_levels) {
  if (!msbfs::direction_go(ctrl, max_levels, msbfs::kDirPull)) return;
  __shared__ long long s_tab[kMaxBuckets * kTab];
  extern __shared__ uint4 s_map4[];
  for (int i = threadIdx.x; i < nb * kTab; i += blockDim.x) s_tab[i] = table[i];
  if constexpr (kMap) {
    const uint4* src = reinterpret_cast<const uint4*>(fmap);
    for (int i = threadIdx.x; i < map_words / 4; i += blockDim.x) s_map4[i] = __ldcg(src + i);
  }
  __syncthreads();
  const uint32_t* const s_map = reinterpret_cast<const uint32_t*>(s_map4);
  constexpr int P = W ? W : kPass;
  constexpr int S = run_chunks(W);
  constexpr int kWarps = level_threads(W, kMap) / 32;
  const int Wd = W ? W : w_rt;
  const int lane = threadIdx.x & 31;
  uint32_t* const out = v_cat + out_off * Wd;
  // A slot's source, or prev_rows (the zero row) when it has none to read.
  auto source = [&](int c) {
    if constexpr (kMap) {
      if (c < prev_rows && !((s_map[c >> 5] >> (c & 31)) & 1u)) return prev_rows;
    }
    return c;
  };
  // A warp's runs are every warps-th from its own; it looks at 32 of them
  // at once, a lane each, and walks only those with a live row, so the
  // runs of a level whose rows are mostly not live cost one load each.
  const long long warps = static_cast<long long>(gridDim.x) * kWarps;
  for (long long first = blockIdx.x * static_cast<long long>(kWarps) + (threadIdx.x >> 5);
       first < runs; first += 32 * warps) {
    bool mine = false;
    if (first + lane * warps < runs) {
      const long long run = first + lane * warps;
      const long long* b = s_tab + bucket_of(s_tab, nb, run) * kTab;
      const long long g0 = out_off + b[3], local = run - b[4];
      if (b[5] > 0) {
        const long long r0 = local * S * b[5];
        mine = any_bit(live, g0 + r0, g0 + min(r0 + S * b[5], b[1]));
      } else {
        mine = bit_of(live, g0 + local);
      }
    }
    for (unsigned todo = __ballot_sync(kFull, mine); todo; todo &= todo - 1) {
      const long long run = first + (__ffs(todo) - 1) * warps;
      const long long* b = s_tab + bucket_of(s_tab, nb, run) * kTab;
      const long long rows = b[1];
      const int width = static_cast<int>(b[2]);
      const int rpc = static_cast<int>(b[5]);
      const long long local = run - b[4];
      const long long g0 = out_off + b[3];  // the bucket's first row in v_cat
      uint32_t* const out_b = out + b[3] * Wd;
      if (rpc > 0) {
        // Narrow: S chunks of rpc rows from row0; lane l takes slot l of a
        // chunk (row lrow, position lpos), the lanes past rpc * width none.
        const int* const rc = cols + b[0];
        const int lrow = lane / width;
        const int lpos = lane - lrow * width;
        const bool in_chunk = lrow < rpc;
        const long long row0 = local * S * rpc;
        // Bit s: this lane's row of chunk s is live; some lane's is; some
        // lane has a source row to read.
        uint32_t lv = 0, live_chunks = 0, gathered = 0;
#pragma unroll
        for (int s = 0; s < S; ++s) {
          const long long row = row0 + s * rpc + lrow;
          const bool on = in_chunk && row < rows && bit_of(live, g0 + row);
          lv |= static_cast<uint32_t>(on) << s;
          if (__any_sync(kFull, on)) live_chunks |= 1u << s;
        }
        int c[S];
#pragma unroll
        for (int s = 0; s < S; ++s) {
          c[s] = (lv >> s) & 1u ? __ldcg(rc + (row0 + s * rpc) * width + lane) : prev_rows;
        }
#pragma unroll
        for (int s = 0; s < S; ++s) {
          c[s] = source(c[s]);
          if (__any_sync(kFull, c[s] < prev_rows)) gathered |= 1u << s;
        }
        for (int w0 = 0; w0 < Wd; w0 += P) {
          const int nw = min(P, Wd - w0);
          uint32_t x[S][P];
#pragma unroll
          for (int s = 0; s < S; ++s) {
            if constexpr (kBits) {
              x[s][0] = c[s] < prev_rows ? 1u : 0u;
            } else if (c[s] < prev_rows) {
              load_row<W, kVec, P>(x[s], prev, c[s], Wd, w0, nw);
            } else {
#pragma unroll
              for (int i = 0; i < P; ++i) x[s][i] = 0u;
            }
          }
#pragma unroll
          for (int s = 0; s < S; ++s) {
            if (!((live_chunks >> s) & 1u)) continue;
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
            if (lpos == 0 && (lv >> s) & 1u) {
              store_row<W, kVec, P>(out_b, row0 + s * rpc + lrow, x[s], Wd, w0, nw);
            }
          }
        }
      } else {
        // Wide: one row a run, lanes striding over its slots, until the OR
        // covers every lane the owner still needs.
        const int* const rc = cols + b[0] + local * width;
        const long long owner = __ldg(row_owner + g0 + local);
        for (int w0 = 0; w0 < Wd; w0 += P) {
          const int nw = min(P, Wd - w0);
          uint32_t need[P], acc[P];
          load_row<W, kVec, P>(need, visited, owner, Wd, w0, nw);
          bool any_need = false;
#pragma unroll
          for (int i = 0; i < P; ++i) {
            need[i] = i < nw ? __ldg(mask + w0 + i) & ~need[i] : 0u;
            any_need |= need[i] != 0u;
            acc[i] = 0u;
          }
          for (int j0 = 0; any_need && j0 < width; j0 += 32 * kWideChunks) {
            int c[kWideChunks];
            bool any = false;
#pragma unroll
            for (int s = 0; s < kWideChunks; ++s) {
              const int j = j0 + s * 32 + lane;
              c[s] = source(j < width ? __ldcg(rc + j) : prev_rows);
              any |= c[s] < prev_rows;
            }
            // A step that read no source row leaves the warp's OR as it was.
            if (!__any_sync(kFull, any)) continue;
#pragma unroll
            for (int s = 0; s < kWideChunks; ++s) {
              if (c[s] < prev_rows) {
                if constexpr (kBits) {
                  acc[0] |= 1u;
                } else {
                  uint32_t x[P];
                  load_row<W, kVec, P>(x, prev, c[s], Wd, w0, nw);
#pragma unroll
                  for (int i = 0; i < P; ++i) acc[i] |= x[i];
                }
              }
            }
            bool covered = true;
#pragma unroll
            for (int i = 0; i < P; ++i) {
#pragma unroll
              for (int d = 16; d > 0; d >>= 1) acc[i] |= __shfl_xor_sync(kFull, acc[i], d);
              covered &= (acc[i] & need[i]) == need[i];
            }
            if (covered) break;  // warp-uniform: acc is the warp's OR
          }
          if (lane == 0) store_row<W, kVec, P>(out_b, local, acc, Wd, w0, nw);
        }
      }
    }
  }
}

// hits[v] = v_cat[final_slot[v]] & need(v), need(v) = the active lanes v
// has not visited; 0 without reading v_cat where need(v) is empty (its
// rows were not live) or v has no row.
template <int W, bool kVec>
__global__ void __launch_bounds__(msbfs::kThreads)
flag_gather_kernel(const uint32_t* __restrict__ v_cat,
                   const int* __restrict__ final_slot,
                   const uint32_t* __restrict__ visited,
                   const uint32_t* __restrict__ mask,
                   uint32_t* __restrict__ hits, long long n,
                   long long total_rows, int w_rt,
                   const int* __restrict__ ctrl, int max_levels) {
  if (!msbfs::direction_go(ctrl, max_levels, msbfs::kDirPull)) return;
  extern __shared__ uint32_t s_mask[];
  const int Wd = W ? W : w_rt;
  for (int w = threadIdx.x; w < Wd; w += blockDim.x) s_mask[w] = __ldcg(mask + w);
  __syncthreads();
  for (long long v = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       v < n; v += static_cast<long long>(gridDim.x) * blockDim.x) {
    if constexpr (W != 0) {
      uint32_t need[W], x[W];
      ldcg_words<W, kVec>(need, visited + v * W);
      bool any = false;
#pragma unroll
      for (int i = 0; i < W; ++i) {
        need[i] = s_mask[i] & ~need[i];
        any |= need[i] != 0u;
        x[i] = 0u;
      }
      const long long slot = any ? __ldg(final_slot + v) : total_rows;
      if (slot < total_rows) {
        ldcg_words<W, kVec>(x, v_cat + slot * W);
#pragma unroll
        for (int i = 0; i < W; ++i) x[i] &= need[i];
      }
      store_words<W, kVec>(hits + v * W, x);
    } else {
      const uint32_t* vis = visited + v * Wd;
      bool any = false;
      for (int w = 0; w < Wd && !any; ++w) any = (s_mask[w] & ~__ldg(vis + w)) != 0u;
      const long long slot = any ? __ldg(final_slot + v) : total_rows;
      for (int w = 0; w < Wd; ++w) {
        hits[v * Wd + w] = slot < total_rows
                               ? __ldg(v_cat + slot * Wd + w) & s_mask[w] & ~__ldg(vis + w)
                               : 0u;
      }
    }
  }
}

struct Args {
  const uint32_t* frontier;
  const uint32_t* visited;
  const int* lane_levels;
  int k;
  const long long* table;
  const long long* meta;
  int levels;
  uint32_t* v_cat;
  uint32_t* fmap;
  int map_words;
  uint32_t* live;
  uint32_t* mask;
  const int* row_owner;
  const int* final_slot;
  uint32_t* hits;
  long long n;
  int W;
  long long total_rows;
  const int* ctrl;
  int max_levels;
  int device;
  cudaStream_t stream;
};

// Per-device launch settings of one bitmap instance.
struct MapLaunch {
  int allowed[msbfs::kMaxDevices] = {};
  int blocks_per_sm[msbfs::kMaxDevices] = {};
  int blocks_smem[msbfs::kMaxDevices] = {};
};

template <int W, bool kVec, bool kMap, bool kBits>
cudaError_t launch_level(const Args& a, int li) {
  const long long* m = a.meta + li * kMeta;
  const uint32_t* prev =
      li == 0 ? a.frontier : a.v_cat + a.meta[(li - 1) * kMeta + 2] * a.W;
  constexpr int kT = level_threads(W, kMap);
  constexpr int kWarps = kT / 32;
  int grid = msbfs::grid_for(m[5] * 32, kT);
  int smem = 0;
  if constexpr (kMap) {
    static MapLaunch cfg;
    smem = a.map_words * 4;
    cudaError_t err = msbfs::allow_smem(flag_level_kernel<W, kVec, kMap, kBits>, smem,
                                        cfg.allowed, a.device);
    if (err != cudaSuccess) return err;
    int occ = 0, sms = 0;
    const bool cached = a.device >= 0 && a.device < msbfs::kMaxDevices;
    if (cached && cfg.blocks_smem[a.device] == smem && cfg.blocks_per_sm[a.device] > 0) {
      occ = cfg.blocks_per_sm[a.device];
    } else {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &occ, flag_level_kernel<W, kVec, kMap, kBits>, kT, smem);
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
    const long long wanted = (m[5] + kWarps - 1) / kWarps;
    grid = static_cast<int>(resident < wanted ? resident : wanted);
    if (grid < 1) grid = 1;
  }
  flag_level_kernel<W, kVec, kMap, kBits><<<grid, kT, smem, a.stream>>>(
      prev, static_cast<int>(m[1]), reinterpret_cast<const int*>(m[0]),
      a.table + m[3] * kTab, static_cast<int>(m[4]), a.v_cat, m[2], a.W, m[5],
      a.live, a.fmap, a.map_words, a.row_owner, a.visited, a.mask, a.ctrl,
      a.max_levels);
  return cudaGetLastError();
}

template <int W, bool kVec, bool kMap, bool kBits>
cudaError_t run(const Args& a) {
  const long long map_units = kMap ? (a.n + 31) >> 5 : 0;
  const long long units = map_units + ((a.total_rows + 31) >> 5);
  const int mask_smem = a.W * 4;
  flag_prepass_kernel<W, kVec>
      <<<msbfs::grid_for(units * 32, msbfs::kThreads), msbfs::kThreads, mask_smem, a.stream>>>(
          a.frontier, a.visited, a.lane_levels, a.k, a.row_owner, a.n, a.total_rows, a.W,
          a.fmap, map_units, a.live, a.mask, a.ctrl, a.max_levels);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  for (int li = 0; li < a.levels; ++li) {
    if (a.meta[li * kMeta + 5] == 0) continue;  // a level without rows
    err = li == 0 ? launch_level<W, kVec, kMap, kBits>(a, li)
                  : launch_level<W, kVec, false, false>(a, li);
    if (err != cudaSuccess) return err;
  }
  flag_gather_kernel<W, kVec>
      <<<msbfs::grid_for(a.n, msbfs::kThreads), msbfs::kThreads, mask_smem, a.stream>>>(
          a.v_cat, a.final_slot, a.visited, a.mask, a.hits, a.n, a.total_rows, a.W,
          a.ctrl, a.max_levels);
  return cudaGetLastError();
}

template <int W, bool kVec>
cudaError_t with_map(const Args& a, bool map, bool bits) {
  if (!map) return run<W, kVec, false, false>(a);
  if constexpr (W == 1) {
    if (bits) return run<W, kVec, true, true>(a);
  }
  return run<W, kVec, true, false>(a);
}

}  // namespace

// (n, 4W) uint8 frontier and visited planes, read as (n, W) words, ->
// every word of the (n, W) hits.  table: (buckets, kTab) int64 over all
// forest levels; meta: kMeta int64 per level (host memory); chunks: the
// 32-slot chunks of a narrow run the table was cut for.  lane_levels: the
// carry's per-lane level counters, or null (every lane q < k active).
// Scratch: v_cat (total_rows + 1, W) with its last row zero; fmap (map
// words, a multiple of 4, >= ceil(n / 32)), used when ``map``; live
// (ceil(total_rows / 32)); mask (W).  vec16: frontier, visited, v_cat and
// hits are 16-byte aligned (used at W = 16).  bits: k == 1 at W = 1 with
// the map.
extern "C" int msbfs_flag_pull(int device, const void* frontier,
                               const void* visited, const void* lane_levels,
                               int k, const void* table, const long long* meta,
                               int levels, void* v_cat, void* fmap,
                               int map_words, void* live, void* mask,
                               const void* row_owner, const void* final_slot,
                               void* hits, long long n, int W,
                               long long total_rows, int chunks, int vec16,
                               int map, int bits, const void* ctrl,
                               int max_levels, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  if (W < 1 || k < 0 || k > 4 * W || n < 0 || n >= (1LL << 31) || levels < 0 ||
      total_rows < 0 || total_rows >= (1LL << 31) || chunks != run_chunks(W) ||
      (bits && !(map && W == 1 && k == 1)) ||
      (map && (map_words % 4 || map_words < (n + 31) / 32))) {
    return invalid;
  }
  for (int li = 0; li < levels; ++li) {
    if (meta[li * kMeta + 4] > kMaxBuckets || meta[li * kMeta + 1] >= (1LL << 31)) {
      return invalid;
    }
  }
  Args a;
  a.frontier = static_cast<const uint32_t*>(frontier);
  a.visited = static_cast<const uint32_t*>(visited);
  a.lane_levels = static_cast<const int*>(lane_levels);
  a.k = k;
  a.table = static_cast<const long long*>(table);
  a.meta = meta;
  a.levels = levels;
  a.v_cat = static_cast<uint32_t*>(v_cat);
  a.fmap = static_cast<uint32_t*>(fmap);
  a.map_words = map_words;
  a.live = static_cast<uint32_t*>(live);
  a.mask = static_cast<uint32_t*>(mask);
  a.row_owner = static_cast<const int*>(row_owner);
  a.final_slot = static_cast<const int*>(final_slot);
  a.hits = static_cast<uint32_t*>(hits);
  a.n = n;
  a.W = W;
  a.total_rows = total_rows;
  a.ctrl = static_cast<const int*>(ctrl);
  a.max_levels = max_levels;
  a.device = device;
  a.stream = static_cast<cudaStream_t>(stream);
  switch (W) {
    case 1: err = with_map<1, false>(a, map, bits); break;
    case 16: err = vec16 ? with_map<16, true>(a, map, bits) : with_map<16, false>(a, map, bits); break;
    default: err = with_map<0, false>(a, map, bits); break;
  }
  return static_cast<int>(err);
}

// Native host runtime of the port's preprocessing: the reference-format
// binary decoded into an insertion-order CSR, the per-row dedup and the
// BELL forest's level build.
//
// The same algorithms, entry points and results as the JAX package's
// runtime/loader.cpp, cut to what the port's main path runs (no DIMACS or
// SNAP text parsers, no R-MAT sampler).  Against the reference's
// LoadGraphBin (main.cu:92-130) the decoder mmaps the file and walks it
// once instead of one fread per int, builds the CSR by a counting pass and
// a placement pass instead of a vector of vectors, and keeps int64
// offsets, so 2m >= 2^31 slots cannot overflow.  Every pass is threaded
// and gives the same bytes at any thread count.  Beyond the JAX package's
// runtime, the CSR build and the dedup also carry a cost column (the
// weighted route), which the JAX package builds with NumPy alone: the same
// slot order and the same least cost per parallel pair; and the weighted
// engines' split of the slots into a light and a heavy side, and each
// side's piece table.
//
// C ABI with caller-allocated buffers, bound with ctypes
// (runtime/native_loader.py), which builds this file at first use.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

// Threads for a pass over ``work`` items: MSBFS_NATIVE_THREADS when set
// (an exact count, capped at 64), else the hardware's, scaled down so
// that a small input never pays for spawning threads.
int num_threads_for(int64_t work, int64_t min_per_thread = int64_t{1} << 20) {
  const char* env = std::getenv("MSBFS_NATIVE_THREADS");
  if (env && *env) {
    const int t = std::atoi(env);
    if (t > 0) return std::min(t, 64);
  }
  int t = static_cast<int>(std::thread::hardware_concurrency());
  if (t <= 0) t = 1;
  if (t > 64) t = 64;
  const int64_t by_work =
      min_per_thread > 0 ? std::max<int64_t>(work / min_per_thread, 1) : 1;
  return static_cast<int>(std::min<int64_t>(t, by_work));
}

// fn(t, lo, hi) over [0, total) split into T contiguous ranges.
template <typename F>
void parallel_ranges(int T, int64_t total, F&& fn) {
  if (T <= 1 || total <= 0) {
    fn(0, 0, total);
    return;
  }
  const int64_t chunk = (total + T - 1) / T;
  std::vector<std::thread> threads;
  threads.reserve(T);
  for (int t = 0; t < T; ++t) {
    const int64_t lo = t * chunk;
    const int64_t hi = std::min(total, lo + chunk);
    if (lo >= hi) break;
    threads.emplace_back([&fn, t, lo, hi] { fn(t, lo, hi); });
  }
  for (auto& th : threads) th.join();
}

// fn(t) for every t in [0, T): for passes over a precomputed partition,
// where skipping a t would drop its rows.
template <typename F>
void parallel_tasks(int T, F&& fn) {
  if (T <= 1) {
    fn(0);
    return;
  }
  std::vector<std::thread> threads;
  threads.reserve(T);
  for (int t = 0; t < T; ++t) {
    threads.emplace_back([&fn, t] { fn(t); });
  }
  for (auto& th : threads) th.join();
}

// Row bounds splitting [0, n) into T parts of about equal slots: a plain
// row split would hand one thread all the hubs of a power-law graph.
std::vector<int64_t> split_rows_by_slots(int T, int64_t n,
                                         const int64_t* row_offsets) {
  std::vector<int64_t> bounds(T + 1, n);
  bounds[0] = 0;
  const int64_t total = n > 0 ? row_offsets[n] : 0;
  for (int t = 1; t < T; ++t) {
    const int64_t target = total * t / T;
    bounds[t] = std::lower_bound(row_offsets, row_offsets + n + 1, target) -
                row_offsets;
    if (bounds[t] < bounds[t - 1]) bounds[t] = bounds[t - 1];
  }
  return bounds;
}

struct MappedFile {
  const unsigned char* data = nullptr;
  size_t size = 0;
  int fd = -1;

  bool open(const char* path) {
    fd = ::open(path, O_RDONLY);
    if (fd < 0) return false;
    struct stat st;
    if (fstat(fd, &st) != 0) return false;
    size = static_cast<size_t>(st.st_size);
    if (size == 0) {
      data = nullptr;
      return true;
    }
    void* p = mmap(nullptr, size, PROT_READ, MAP_PRIVATE, fd, 0);
    if (p == MAP_FAILED) return false;
    data = static_cast<const unsigned char*>(p);
    return true;
  }

  ~MappedFile() {
    if (data) munmap(const_cast<unsigned char*>(data), size);
    if (fd >= 0) ::close(fd);
  }
};

inline int32_t read_i32(const unsigned char* p) {
  int32_t v;
  std::memcpy(&v, p, sizeof(v));
  return v;
}

inline int64_t read_i64(const unsigned char* p) {
  int64_t v;
  std::memcpy(&v, p, sizeof(v));
  return v;
}

constexpr size_t kHeaderBytes = sizeof(int32_t) + sizeof(int64_t);

// Counting + placement CSR build with per-thread histograms.  Record i
// lands before record j > i in every row (a thread's cursor base is the
// prefix over lower-numbered threads, which hold lower-numbered records),
// so the adjacency is the reference's insertion order at any thread
// count.  ``read_edge(i, &u, &v)`` reads record i.  With ``weights`` (m
// record costs) and ``edge_weights`` (2m slots) both non-null, each
// record's cost is placed beside both of its directed slots.  Returns 0, or
// 4 on an out-of-range endpoint.  The histograms take T * (n+1) * 8 B; T
// is capped so that they stay within about 2 GiB.
template <typename ReadEdge>
int build_csr_parallel(int64_t n, int64_t m, ReadEdge read_edge,
                       int64_t* row_offsets, int32_t* col_indices,
                       const int32_t* weights = nullptr,
                       int32_t* edge_weights = nullptr) {
  const bool weighted = weights != nullptr && edge_weights != nullptr;
  int T = num_threads_for(2 * m);
  if (n > 0) {
    const int64_t by_mem =
        std::max<int64_t>((int64_t{2} << 30) / ((n + 1) * 8), 1);
    T = static_cast<int>(std::min<int64_t>(T, by_mem));
  }
  std::atomic<int> err{0};
  if (T <= 1) {
    for (int64_t i = 0; i <= n; i++) row_offsets[i] = 0;
    for (int64_t i = 0; i < m; i++) {
      int64_t u, v;
      read_edge(i, &u, &v);
      if (u < 0 || u >= n || v < 0 || v >= n) return 4;
      row_offsets[u + 1]++;
      row_offsets[v + 1]++;
    }
    for (int64_t i = 0; i < n; i++) row_offsets[i + 1] += row_offsets[i];
    std::vector<int64_t> cursor(n > 0 ? n : 1);
    std::memcpy(cursor.data(), row_offsets,
                (n > 0 ? n : 1) * sizeof(int64_t));
    for (int64_t i = 0; i < m; i++) {
      int64_t u, v;
      read_edge(i, &u, &v);
      const int64_t pu = cursor[u]++;
      const int64_t pv = cursor[v]++;
      col_indices[pu] = static_cast<int32_t>(v);
      col_indices[pv] = static_cast<int32_t>(u);
      if (weighted) edge_weights[pu] = edge_weights[pv] = weights[i];
    }
    return 0;
  }

  // Pass 1: per-thread degree histograms over disjoint record ranges.
  std::vector<std::vector<int64_t>> counts(T);
  parallel_ranges(T, m, [&](int t, int64_t lo, int64_t hi) {
    counts[t].assign(n > 0 ? n : 1, 0);
    for (int64_t i = lo; i < hi; i++) {
      int64_t u, v;
      read_edge(i, &u, &v);
      if (u < 0 || u >= n || v < 0 || v >= n) {
        err.store(4, std::memory_order_relaxed);
        return;
      }
      counts[t][u]++;
      counts[t][v]++;
    }
  });
  if (err.load()) return 4;
  // Reduce and scan; counts[t][i] becomes thread t's write cursor for
  // row i (the row's start plus the lower threads' share).
  row_offsets[0] = 0;
  parallel_ranges(T, n, [&](int, int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; i++) {
      int64_t total = 0;
      for (int t = 0; t < T; ++t) total += counts[t][i];
      row_offsets[i + 1] = total;
    }
  });
  for (int64_t i = 0; i < n; i++) row_offsets[i + 1] += row_offsets[i];
  parallel_ranges(T, n, [&](int, int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; i++) {
      int64_t running = row_offsets[i];
      for (int t = 0; t < T; ++t) {
        const int64_t c = counts[t][i];
        counts[t][i] = running;
        running += c;
      }
    }
  });
  // Pass 2: placement over the same record ranges, private cursors.
  parallel_ranges(T, m, [&](int t, int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; i++) {
      int64_t u, v;
      read_edge(i, &u, &v);
      const int64_t pu = counts[t][u]++;
      const int64_t pv = counts[t][v]++;
      col_indices[pu] = static_cast<int32_t>(v);
      col_indices[pv] = static_cast<int32_t>(u);
      if (weighted) edge_weights[pu] = edge_weights[pv] = weights[i];
    }
  });
  return 0;
}

// Bucket of a nonzero count: the first ladder width >= count, else the
// hub (last) bucket.  The ladder is short, so a linear scan.
inline int bucket_of(int64_t count, int num_widths, const int32_t* widths) {
  for (int b = 0; b < num_widths - 1; ++b) {
    if (count <= widths[b]) return b;
  }
  return num_widths - 1;
}

}  // namespace

extern "C" {

// The threads a pass over ``work`` items takes (the CSR build's count at
// work = 2m): what the caller reports beside its times.
int msbfs_native_threads(int64_t work) { return num_threads_for(work); }

// Reads "int32 n, int64 m".  Returns 0, 1 on an unreadable file, 2 on a
// negative count, 3 when the file is shorter than its m records.
int msbfs_graph_header(const char* path, int64_t* n_out, int64_t* m_out) {
  MappedFile f;
  if (!f.open(path) || f.size < kHeaderBytes) return 1;
  *n_out = read_i32(f.data);
  *m_out = read_i64(f.data + sizeof(int32_t));
  if (*n_out < 0 || *m_out < 0) return 2;
  if (f.size < kHeaderBytes + static_cast<size_t>(*m_out) * 8) return 3;
  return 0;
}

// Fills row_offsets (n+1 int64) and col_indices (2m int32) from the
// file's m records: the insertion-order adjacency of the reference's
// push_back sequence (main.cu:114-115).  Bytes after the records (a
// weight section) are not read.  Returns 0, 1 on an unreadable file, 3 on
// a short file, 4 on an out-of-range endpoint.
int msbfs_load_graph_csr(const char* path, int64_t n, int64_t m,
                         int64_t* row_offsets, int32_t* col_indices) {
  MappedFile f;
  if (!f.open(path)) return 1;
  if (f.size < kHeaderBytes + static_cast<size_t>(m) * 8) return 3;
  const unsigned char* edges = f.data + kHeaderBytes;
  return build_csr_parallel(
      n, m,
      [edges](int64_t i, int64_t* u, int64_t* v) {
        *u = read_i32(edges + i * 8);
        *v = read_i32(edges + i * 8 + 4);
      },
      row_offsets, col_indices);
}

// msbfs_load_graph_csr with the records' costs (m int32, read from the
// file's weight section by the caller) placed beside their slots in
// edge_weights (2m int32).  Same return codes.
int msbfs_load_graph_csr_weighted(const char* path, int64_t n, int64_t m,
                                  const int32_t* weights, int64_t* row_offsets,
                                  int32_t* col_indices, int32_t* edge_weights) {
  MappedFile f;
  if (!f.open(path)) return 1;
  if (f.size < kHeaderBytes + static_cast<size_t>(m) * 8) return 3;
  const unsigned char* edges = f.data + kHeaderBytes;
  return build_csr_parallel(
      n, m,
      [edges](int64_t i, int64_t* u, int64_t* v) {
        *u = read_i32(edges + i * 8);
        *v = read_i32(edges + i * 8 + 4);
      },
      row_offsets, col_indices, weights, edge_weights);
}

// The same build from an in-memory (m, 2) int32 C-contiguous record
// array: two O(m) passes in place of a stable argsort over 2m keys.
// Returns 0, 1 on a negative count, 4 on an out-of-range endpoint.
int msbfs_csr_from_edges(int64_t n, int64_t m, const int32_t* edges,
                         int64_t* row_offsets, int32_t* col_indices) {
  if (n < 0 || m < 0) return 1;
  return build_csr_parallel(
      n, m,
      [edges](int64_t i, int64_t* u, int64_t* v) {
        *u = edges[2 * i];
        *v = edges[2 * i + 1];
      },
      row_offsets, col_indices);
}

// msbfs_csr_from_edges with the records' costs (m int32) placed beside
// their slots in edge_weights (2m int32).
int msbfs_csr_from_edges_weighted(int64_t n, int64_t m, const int32_t* edges,
                                  const int32_t* weights, int64_t* row_offsets,
                                  int32_t* col_indices, int32_t* edge_weights) {
  if (n < 0 || m < 0) return 1;
  return build_csr_parallel(
      n, m,
      [edges](int64_t i, int64_t* u, int64_t* v) {
        *u = edges[2 * i];
        *v = edges[2 * i + 1];
      },
      row_offsets, col_indices, weights, edge_weights);
}

// Per-row dedup of a CSR: each row sorted, duplicates and self-loops
// dropped.  Fills out_dst (>= num_slots int32; the first <return value>
// entries, sorted by (row, neighbour)) and out_deg (n int64 dedup
// degrees).  Returns the dedup slot count, or -1 when the rows are not
// monotone, overlap or leave [0, num_slots).  row_offsets[0] > 0 is valid:
// the slots before the first row belong to no row.
int64_t msbfs_dedup_rows(int64_t n, int64_t num_slots,
                         const int64_t* row_offsets,
                         const int32_t* col_indices, int32_t* out_dst,
                         int64_t* out_deg) {
  if (n < 0 || num_slots < 0) return -1;
  int64_t prev_end = 0;
  for (int64_t u = 0; u < n; ++u) {
    const int64_t s = row_offsets[u];
    const int64_t e = row_offsets[u + 1];
    if (s < prev_end || e < s || e > num_slots) return -1;
    prev_end = e;
  }
  const int T = num_threads_for(num_slots, int64_t{1} << 19);
  const std::vector<int64_t> bounds = split_rows_by_slots(T, n, row_offsets);
  // Phase A: each thread sorts and dedups its rows, writing them
  // contiguously from its region's first slot in out_dst (regions are
  // disjoint and out_dst is not col_indices, so nothing aliases).
  std::vector<int64_t> block_len(T, 0);
  parallel_tasks(T, [&](int t) {
    std::vector<int32_t> scratch;
    int64_t w = row_offsets[bounds[t]];
    const int64_t w0 = w;
    for (int64_t u = bounds[t]; u < bounds[t + 1]; ++u) {
      const int64_t s = row_offsets[u];
      const int64_t e = row_offsets[u + 1];
      scratch.assign(col_indices + s, col_indices + e);
      std::sort(scratch.begin(), scratch.end());
      int64_t cnt = 0;
      int32_t prev = 0;
      for (int32_t v : scratch) {
        if (v == static_cast<int32_t>(u)) continue;  // self-loop
        if (cnt && v == prev) continue;              // duplicate
        out_dst[w++] = v;
        prev = v;
        ++cnt;
      }
      out_deg[u] = cnt;
    }
    block_len[t] = w - w0;
  });
  // Phase B: slide each block left onto the end of the one before, in
  // ascending order so that no move overwrites a block not yet moved.
  // Block 0 moves too: with row_offsets[0] > 0 it must land at 0.
  int64_t w = 0;
  for (int t = 0; t < T; ++t) {
    const int64_t src = row_offsets[bounds[t]];
    if (src != w && block_len[t]) {
      std::memmove(out_dst + w, out_dst + src,
                   block_len[t] * sizeof(int32_t));
    }
    w += block_len[t];
  }
  return w;
}

// msbfs_dedup_rows over a weighted CSR (edge_weights: a cost per slot):
// parallel slots collapse to their least cost, written to out_w beside
// out_dst.  Each row sorts (neighbour << 32 | cost) keys, so a neighbour's
// first key holds its least cost.  Same returns.
int64_t msbfs_dedup_rows_weighted(int64_t n, int64_t num_slots,
                                  const int64_t* row_offsets,
                                  const int32_t* col_indices,
                                  const int32_t* edge_weights, int32_t* out_dst,
                                  int32_t* out_w, int64_t* out_deg) {
  if (n < 0 || num_slots < 0) return -1;
  int64_t prev_end = 0;
  for (int64_t u = 0; u < n; ++u) {
    const int64_t s = row_offsets[u];
    const int64_t e = row_offsets[u + 1];
    if (s < prev_end || e < s || e > num_slots) return -1;
    prev_end = e;
  }
  const int T = num_threads_for(num_slots, int64_t{1} << 19);
  const std::vector<int64_t> bounds = split_rows_by_slots(T, n, row_offsets);
  std::vector<int64_t> block_len(T, 0);
  parallel_tasks(T, [&](int t) {
    std::vector<uint64_t> scratch;
    int64_t w = row_offsets[bounds[t]];
    const int64_t w0 = w;
    for (int64_t u = bounds[t]; u < bounds[t + 1]; ++u) {
      const int64_t s = row_offsets[u];
      const int64_t e = row_offsets[u + 1];
      scratch.resize(e - s);
      for (int64_t i = s; i < e; ++i) {
        scratch[i - s] = (static_cast<uint64_t>(static_cast<uint32_t>(col_indices[i])) << 32) |
                         static_cast<uint32_t>(edge_weights[i]);
      }
      std::sort(scratch.begin(), scratch.end());
      int64_t cnt = 0;
      int32_t prev = 0;
      for (uint64_t key : scratch) {
        const int32_t v = static_cast<int32_t>(key >> 32);
        if (v == static_cast<int32_t>(u)) continue;  // self-loop
        if (cnt && v == prev) continue;              // a costlier parallel slot
        out_dst[w] = v;
        out_w[w++] = static_cast<int32_t>(key & 0xffffffffu);
        prev = v;
        ++cnt;
      }
      out_deg[u] = cnt;
    }
    block_len[t] = w - w0;
  });
  int64_t w = 0;
  for (int t = 0; t < T; ++t) {
    const int64_t src = row_offsets[bounds[t]];
    if (src != w && block_len[t]) {
      std::memmove(out_dst + w, out_dst + src, block_len[t] * sizeof(int32_t));
      std::memmove(out_w + w, out_w + src, block_len[t] * sizeof(int32_t));
    }
    w += block_len[t];
  }
  return w;
}

// The weighted route's sides (weighted/deltastep.py): a stable partition
// of slot arrays by cost, the light slots (w <= delta) first, then the
// heavy ones, each side in slot order.  Each thread counts its chunk's
// light slots; a prefix over the threads places every chunk's two runs.
// Returns the light count, or -1 on bad input.
int64_t msbfs_split_slots(int64_t total, const int32_t* u, const int32_t* v,
                          const int32_t* w, int32_t delta, int32_t* out_u,
                          int32_t* out_v, int32_t* out_w) {
  if (total < 0) return -1;
  const int T = num_threads_for(total);
  const int64_t chunk = T > 0 ? (total + T - 1) / T : 0;
  std::vector<int64_t> light(T + 1, 0);
  parallel_tasks(T, [&](int t) {
    const int64_t lo = std::min(total, t * chunk);
    const int64_t hi = std::min(total, lo + chunk);
    int64_t c = 0;
    for (int64_t s = lo; s < hi; ++s) c += w[s] <= delta;
    light[t + 1] = c;
  });
  for (int t = 0; t < T; ++t) light[t + 1] += light[t];
  const int64_t num_light = light[T];
  parallel_tasks(T, [&](int t) {
    const int64_t lo = std::min(total, t * chunk);
    const int64_t hi = std::min(total, lo + chunk);
    int64_t a = light[t];
    int64_t b = num_light + (lo - light[t]);
    for (int64_t s = lo; s < hi; ++s) {
      const int64_t at = w[s] <= delta ? a++ : b++;
      out_u[at] = u[s];
      out_v[at] = v[s];
      out_w[at] = w[s];
    }
  });
  return num_light;
}

// The piece table of a side (models/csr.py row_pieces): over slots whose
// source rows come in runs (sorted, or sorted within each segment that
// starts at a position of ``cuts``, ascending), a piece starts at every
// run's first slot and every piece_slots slots into a run; piece i is
// (start_i, start_{i+1} or total, rows[start_i]).  Each thread finds the
// start of the run it enters by a scan back, counts (fill == 0) or writes
// its pieces after the threads before it.  Returns the piece count, or -1
// on bad input.
int64_t msbfs_row_pieces(int64_t total, const int32_t* rows, int64_t num_cuts,
                         const int64_t* cuts, int64_t piece_slots, int fill,
                         int32_t* out) {
  if (total < 0 || num_cuts < 0 || piece_slots < 1) return -1;
  const int T = num_threads_for(total);
  const int64_t chunk = T > 0 ? (total + T - 1) / T : 0;
  const int64_t* cuts_end = cuts + num_cuts;
  std::vector<int64_t> count(T + 1, 0);
  auto walk = [&](int t, bool write) {
    const int64_t lo = std::min(total, t * chunk);
    const int64_t hi = std::min(total, lo + chunk);
    if (lo >= hi) return;
    int64_t run = lo;
    while (run > 0 && rows[run - 1] == rows[lo] &&
           !std::binary_search(cuts, cuts_end, run)) {
      --run;
    }
    const int64_t* next_cut = std::lower_bound(cuts, cuts_end, lo);
    int64_t at = write ? count[t] : 0;
    int64_t into = (lo - run) % piece_slots;  // slots into the current piece
    for (int64_t s = lo; s < hi; ++s) {
      bool cut = false;
      while (next_cut < cuts_end && *next_cut <= s) cut |= *next_cut++ == s;
      if (s > lo && (cut || rows[s] != rows[s - 1])) into = 0;
      if (into == 0) {
        if (write) {
          out[3 * at] = static_cast<int32_t>(s);
          out[3 * at + 2] = rows[s];
        }
        ++at;
      }
      if (++into == piece_slots) into = 0;
    }
    if (!write) count[t + 1] = at;
  };
  parallel_tasks(T, [&](int t) { walk(t, false); });
  for (int t = 0; t < T; ++t) count[t + 1] += count[t];
  const int64_t pieces = count[T];
  if (!fill) return pieces;
  parallel_tasks(T, [&](int t) { walk(t, true); });
  parallel_ranges(T, pieces, [&](int, int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      out[3 * i + 1] = i + 1 < pieces ? out[3 * (i + 1)] : static_cast<int32_t>(total);
    }
  });
  return pieces;
}

// BELL level build, pass 1: each owner's rows.  Buckets in ladder order,
// owners ascending within a bucket, a hub owner's items chunked into
// ceil(count / W_max) rows -- the NumPy build's order.  Fills
// rows_per_owner (V), first_row (V; 0 for an owner with no rows),
// bucket_rows (B) and flat_off (B: slot offset of each bucket's first
// row).  Returns the level's padded slots, or -1 on bad input.
int64_t msbfs_bell_assign(int64_t v_total, const int64_t* item_count,
                          int num_widths, const int32_t* widths,
                          int64_t* rows_per_owner, int64_t* first_row,
                          int64_t* bucket_rows, int64_t* flat_off) {
  if (v_total < 0 || num_widths <= 0) return -1;
  const int64_t w_max = widths[num_widths - 1];
  const int T = num_threads_for(v_total);
  const int64_t chunk = T > 0 ? (v_total + T - 1) / T : 0;
  // Per-thread bucket histograms over contiguous owner ranges; their
  // per-bucket prefix over threads gives each thread its cursors, so the
  // second scan assigns the serial first_row values.
  std::vector<std::vector<int64_t>> local(
      T, std::vector<int64_t>(num_widths, 0));
  parallel_tasks(T, [&](int t) {
    const int64_t lo = t * chunk;
    const int64_t hi = std::min(v_total, lo + chunk);
    for (int64_t v = lo; v < hi; ++v) {
      const int64_t cnt = item_count[v];
      if (cnt <= 0) {
        rows_per_owner[v] = 0;
        continue;
      }
      const int b = bucket_of(cnt, num_widths, widths);
      const int64_t rows =
          b == num_widths - 1 ? (cnt + w_max - 1) / w_max : 1;
      rows_per_owner[v] = rows;
      local[t][b] += rows;
    }
  });
  for (int b = 0; b < num_widths; ++b) {
    bucket_rows[b] = 0;
    for (int t = 0; t < T; ++t) bucket_rows[b] += local[t][b];
  }
  std::vector<int64_t> row_base(num_widths);
  int64_t rows_acc = 0, slots_acc = 0;
  for (int b = 0; b < num_widths; ++b) {
    row_base[b] = rows_acc;
    flat_off[b] = slots_acc;
    rows_acc += bucket_rows[b];
    slots_acc += bucket_rows[b] * widths[b];
  }
  for (int b = 0; b < num_widths; ++b) {
    int64_t running = 0;
    for (int t = 0; t < T; ++t) {
      const int64_t c = local[t][b];
      local[t][b] = running;
      running += c;
    }
  }
  parallel_tasks(T, [&](int t) {
    const int64_t lo = t * chunk;
    const int64_t hi = std::min(v_total, lo + chunk);
    std::vector<int64_t> cursor = local[t];
    for (int64_t v = lo; v < hi; ++v) {
      if (item_count[v] <= 0) {
        first_row[v] = 0;
        continue;
      }
      const int b = bucket_of(item_count[v], num_widths, widths);
      first_row[v] = row_base[b] + cursor[b];
      cursor[b] += rows_per_owner[v];
    }
  });
  return slots_acc;
}

// BELL level build, pass 2: the level's flat int32 slots.  Slot i of an
// owner's rows holds item_vals[item_start[v] + i]; a padding slot holds
// sentinel_value (the previous value array's zero row).  Owners write
// disjoint slot ranges, so the pass splits by owner range.  Returns 0, 1
// on bad input, 2 when an owner's items leave [0, num_items).
int msbfs_bell_fill(int64_t v_total, const int64_t* item_start,
                    const int64_t* item_count, int num_widths,
                    const int32_t* widths, const int32_t* item_vals,
                    int64_t num_items, const int64_t* first_row,
                    const int64_t* bucket_rows, const int64_t* flat_off,
                    int32_t sentinel_value, int32_t* flat_out) {
  if (v_total < 0 || num_widths <= 0) return 1;
  std::vector<int64_t> row_base(num_widths);
  int64_t rows_acc = 0;
  for (int b = 0; b < num_widths; ++b) {
    row_base[b] = rows_acc;
    rows_acc += bucket_rows[b];
  }
  std::atomic<int> err{0};
  const int T = num_threads_for(num_items);
  parallel_ranges(T, v_total, [&](int, int64_t lo, int64_t hi) {
    for (int64_t v = lo; v < hi; ++v) {
      const int64_t cnt = item_count[v];
      if (cnt <= 0) continue;
      const int b = bucket_of(cnt, num_widths, widths);
      const int64_t w = widths[b];
      const int64_t start = item_start[v];
      if (start < 0 || start + cnt > num_items) {
        err.store(2, std::memory_order_relaxed);
        return;
      }
      int64_t slot = flat_off[b] + (first_row[v] - row_base[b]) * w;
      const int64_t rows = b == num_widths - 1 ? (cnt + w - 1) / w : 1;
      int64_t item = 0;
      for (int64_t r = 0; r < rows; ++r) {
        for (int64_t i = 0; i < w; ++i, ++slot) {
          flat_out[slot] =
              item < cnt ? item_vals[start + item++] : sentinel_value;
        }
      }
    }
  });
  return err.load();
}

}  // extern "C"

// Kernel K4 — a batch's start: the packed sources and the whole level-loop
// carry in one launch, with no host read.
//
// Replaces the JAX package's ops/bitbell.py:93 pack_queries (stride 1:
// query q at bit q, 32 queries a word) and ops/lowk.py:66 lowk_pack
// (stride 8: query q in byte q of a row of 0/1 bytes, which the port views
// as words: bit 8q, since host and card are little-endian), with
// ops/bitbell.py:311 bit_level_init and, on a direction-switched route,
// the predicate of ops/lowk.py:138 over ops/engine.py:34
// frontier_activity, all of which JAX runs in one jitted function.  For
// (K, S) int32 queries padded with -1, on (rows, W) planes:
//
//   for every q < K, s < S with 0 <= v = queries[q, s] < n:
//     visited[v] |= bit, frontier[v] |= bit       with bit = q * stride
//   reached[lane] = the distinct sources of the lane's query
//   levels[lane] = reached[lane] > 0;  f = 0;  counts = 0
//   ctrl = [any(reached > 0), 0, 0, dir]
//
// and with a direction switch (msbfs_common.cuh) the sources' worklist —
// every nonzero row with out-edges, once, with its exclusive edge prefix —
// the state words (listed rows and edges, active rows and edges) and dir =
// kDirPush when active rows <= row_limit and their edges <= edge_limit,
// else kDirPull: the level apply's switch epilogue (level_apply.cu) on the
// sources.  Sources outside [0, n), the -1 padding among them, are
// dropped: the reference's bounds check (main.cu:46-51).
//
// Design: the entry point clears the carry's one allocation (planes,
// counters, control, the switch's state and hit plane) with one memset,
// then launches one grid of a thread per (q, s).  The old value of a
// thread's atomicOr into the frontier says whether it set the (v, q) bit
// first, so exactly one thread counts each distinct pair: exact counts with
// no sort (the plain version sorts, and its unique() reads its size back).
// With a switch, the thread that set a bit first also claims the row in a
// bitmap of the rows (an atomicOr a source; a row made nonzero by two
// threads at once is claimed by one), and the claiming thread appends a row
// with out-edges by the apply's 64-bit slot-and-prefix atomic (state
// kAppend: list slots in the high half, edges in the low).  A warp's
// appends taken together in one atomic (as the apply takes them) made the
// launch no faster on the card at a few thousand sources (PERF.md),
// so each row takes its own.  The block that
// takes the last ticket (ctrl[2]) sees every count and append: it writes
// levels, ctrl and the state, then clears the ticket and the scratch words,
// as the apply does.  The host reads nothing: the next level reads ctrl on
// the device.
//
// Bound: bytes.  The launch reads the queries (4 bytes each) and writes the
// words the sources set in both planes, the per-lane counters, the list
// entries (8 bytes each) and the control: a few KB on every route of the
// port.  What a batch start pays is its launches: the queries' upload, the
// memset and this kernel.
#include "msbfs_common.cuh"

namespace {

using u64 = unsigned long long;

struct Switch {
  const int* count;  // (rows,) dedup out-degree
  uint32_t* claim;   // (ceil(n / 32),) claimed rows, zero
  int* wl_rows;      // worklist row 0
  int* wl_offs;      // worklist row 1
  long long cap;
  long long* state;  // (kSwitchWords,), zero
  long long row_limit;
  long long edge_limit;
};

template <bool kSwitch>
__global__ void __launch_bounds__(msbfs::kThreads)
batch_start_kernel(const int* __restrict__ queries, long long total, long long s,
                   long long n, int stride, uint32_t* __restrict__ visited,
                   uint32_t* __restrict__ frontier, int w, int lanes,
                   int* __restrict__ levels, int* __restrict__ reached,
                   int* __restrict__ ctrl, Switch sw) {
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       i < total; i += step) {
    const int v = __ldg(queries + i);
    if (v < 0 || v >= n) continue;
    const int bit = static_cast<int>(i / s) * stride;
    const uint32_t mask = 1u << (bit & 31);
    const size_t word = static_cast<size_t>(v) * w + (bit >> 5);
    const uint32_t old = atomicOr(frontier + word, mask);
    atomicOr(visited + word, mask);
    if (old & mask) continue;
    atomicAdd(reached + bit, 1);
    if constexpr (kSwitch) {
      const uint32_t row_bit = 1u << (v & 31);
      if (atomicOr(sw.claim + (v >> 5), row_bit) & row_bit) continue;
      const int d = __ldg(sw.count + v);
      u64* st = reinterpret_cast<u64*>(sw.state);
      if (d > 0) {
        const u64 at = atomicAdd(st + msbfs::kAppend, (u64{1} << 32) + static_cast<u64>(d));
        const long long idx = static_cast<long long>(at >> 32);
        if (idx < sw.cap) {
          sw.wl_rows[idx] = v;
          sw.wl_offs[idx] = static_cast<int>(static_cast<uint32_t>(at));
        }
      } else {
        atomicAdd(st + msbfs::kOtherRows, u64{1});
      }
    }
  }
  // Last-block tail: this block's atomics are visible before it takes a
  // ticket; the block that takes the last ticket sees them all.
  __shared__ int s_last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    s_last = atomicAdd(ctrl + 2, 1) == static_cast<int>(gridDim.x) - 1;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  int found = 0;
  for (int q = threadIdx.x; q < lanes; q += blockDim.x) {
    const int c = __ldcg(reached + q);
    levels[q] = c > 0;
    found |= c > 0;
  }
  found = __syncthreads_or(found);
  if (threadIdx.x == 0) {
    int dir = msbfs::kDirPull;
    if constexpr (kSwitch) {
      u64* st = reinterpret_cast<u64*>(sw.state);
      const u64 app = atomicExch(st + msbfs::kAppend, u64{0});
      const long long listed = static_cast<long long>(app >> 32);
      const long long edges = static_cast<long long>(app & 0xffffffffull);
      const long long rows =
          listed + static_cast<long long>(atomicExch(st + msbfs::kOtherRows, u64{0}));
      sw.state[msbfs::kListed] = listed < sw.cap ? listed : sw.cap;
      sw.state[msbfs::kListedEdges] = edges;
      sw.state[msbfs::kActiveRows] = rows;
      sw.state[msbfs::kActiveEdges] = edges;
      dir = rows <= sw.row_limit && edges <= sw.edge_limit ? msbfs::kDirPush
                                                           : msbfs::kDirPull;
    }
    ctrl[0] = found;
    ctrl[1] = 0;
    ctrl[3] = dir;
    ctrl[2] = 0;
  }
}

}  // namespace

// queries: (k, s) int32, row-major (null when k * s == 0); zero: the
// carry's allocation, whose first zero_bytes bytes are cleared before the
// launch and hold visited and frontier ((rows, w) words each), levels,
// reached (32 w lanes each) and ctrl (4), and with a switch its state and
// claim bitmap (ceil(n / 32) words); stride: the lanes between two
// queries' bits, with k * stride <= 32 w.  count: the (rows,) out-degrees,
// or null for no switch; worklist: the (2, cap) int32 list.  The launch
// runs for an empty batch too: it writes the control and the switch.
extern "C" int msbfs_batch_start(int device, const void* queries, long long k,
                                 long long s, long long n, int stride, void* zero,
                                 long long zero_bytes, void* visited,
                                 void* frontier, int w, void* levels,
                                 void* reached, void* ctrl, const void* count,
                                 void* claim, void* worklist, long long cap,
                                 void* state, long long row_limit,
                                 long long edge_limit, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool switched = count != nullptr;
  if (k < 0 || s < 0 || n < 0 || n >= (1LL << 31) || w < 1 || stride < 1 ||
      k * stride > 32LL * w || zero_bytes < 0 || (k * s > 0 && queries == nullptr) ||
      (switched && (claim == nullptr || state == nullptr || cap < 0 ||
                    (cap > 0 && worklist == nullptr)))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(zero, 0, static_cast<size_t>(zero_bytes), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long total = k * s;
  int* wl = static_cast<int*>(worklist);
  const Switch sw{static_cast<const int*>(count), static_cast<uint32_t*>(claim), wl,
                  wl ? wl + cap : nullptr, cap, static_cast<long long*>(state),
                  row_limit, edge_limit};
  auto args = [&](auto kernel) {
    kernel<<<msbfs::grid_for(total, msbfs::kThreads), msbfs::kThreads, 0, st>>>(
        static_cast<const int*>(queries), total, s, n, stride,
        static_cast<uint32_t*>(visited), static_cast<uint32_t*>(frontier), w, 32 * w,
        static_cast<int*>(levels), static_cast<int*>(reached), static_cast<int*>(ctrl), sw);
  };
  if (switched) {
    args(batch_start_kernel<true>);
  } else {
    args(batch_start_kernel<false>);
  }
  return static_cast<int>(cudaGetLastError());
}

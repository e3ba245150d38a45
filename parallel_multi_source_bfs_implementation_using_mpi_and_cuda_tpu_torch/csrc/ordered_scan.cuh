// The ordered compaction across blocks that H3 owner_push_expand
// (halo_exchange.cu) and M2 wire_encode (mesh_wire.cu) share: a
// single-pass scan with decoupled look-back (Merrill and Garland,
// "Single-pass Parallel Prefix Scan with Decoupled Look-back", 2016).
//
// A launch cuts its input into tiles in input order.  Persistent blocks
// take tiles by an atomic ticket, so tile t - 1 is always held by a block
// that is already running when tile t waits on it.  A tile counts its
// entries, publishes that count (its aggregate) at once, then one warp
// walks back over the earlier tiles' status words, a window a round,
// summing aggregates until it meets an inclusive prefix, and publishes its
// own inclusive prefix.  Entry j of the tile goes to slot (exclusive prefix + j): the
// order of the input, and no atomic places an entry, so the result is the
// same bits on every run.
//
// Scratch: int64 words, zero when first allocated
// (ops/cuda_halo.py ``ScanScratch``):
//   [0]                    the tile ticket; the block that takes the
//                          launch's last ticket sets it back to 0
//   [1]                    the finalizer's published value (the first
//                          sentinel slot), for the blocks that write the
//                          sentinels
//   [2, 2 + tiles)         a status word a tile
//   [2 + tiles, 2 + 2 * tiles)  a second value a tile (M2's byte count)
// A status word is (epoch << 34) | (flag << 32) | value, flag kAggregate
// or kPrefix.  The wrapper passes a new epoch to every launch, so a word
// left by an earlier launch reads as not yet published and no launch
// clears the scratch between calls.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace msbfs {
namespace scan {

constexpr int kHeader = 2;
constexpr unsigned long long kAggregate = 1;
constexpr unsigned long long kPrefix = 2;
// Epochs run 1 .. kEpochs - 1 (30 bits); the wrapper zeroes the scratch
// before it wraps.
constexpr unsigned kEpochs = 1u << 30;
constexpr unsigned kWarpFull = 0xffffffffu;

// The words are read and written relaxed at gpu scope, not acquire /
// release: a word carries its whole message (epoch, flag and value in one
// single-copy-atomic 64-bit access), and no block reads anything else that
// another block wrote before publishing (the entries and the sentinels of
// a launch fall on disjoint slots), so no fence is needed (the fences cost
// 1.6 us of a thin H3 call on an NVIDIA H100 80GB HBM3 at 700 W,
// chip_probe_scan.py).
__device__ __forceinline__ unsigned long long load_word(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_word(unsigned long long* p, unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned long long status_word(unsigned epoch,
                                                          unsigned long long flag,
                                                          uint32_t value) {
  return (static_cast<unsigned long long>(epoch) << 34) | (flag << 32) | value;
}

// The flag of ``s`` in this epoch: 0 (not published) for another epoch's.
__device__ __forceinline__ unsigned flag_of(unsigned long long s, unsigned epoch) {
  return (s >> 34) == epoch ? static_cast<unsigned>((s >> 32) & 3u) : 0u;
}

// Waits for the word at ``p`` of this epoch; its value.
__device__ __forceinline__ uint32_t wait_value(const unsigned long long* p, unsigned epoch) {
  unsigned long long s = load_word(p);
  while (flag_of(s, epoch) == 0) {
    __nanosleep(32);
    s = load_word(p);
  }
  return static_cast<uint32_t>(s);
}

// Tiles a lane reads in one round of the look-back: a warp's window is
// 32 * kLookBackPer tiles.  One a lane measured fastest on H3 (17.3 us on
// road-1024's widest call against 20.0 at four a lane and 25.2 at eight;
// NVIDIA H100 80GB HBM3, 700 W, chip_probe_scan.py): more loads a spin
// only add L2 traffic while the tiles before are still counting.
constexpr int kLookBackPer = 1;

// One warp, all 32 lanes: the exclusive prefix of tile t > 0.  Lane l
// reads tiles end - 1 - (l * kLookBackPer + j), j = 0 .. kLookBackPer - 1
// (nearest first); the window is consumed up to its nearest inclusive
// prefix once every tile up to it has published, else whole.
__device__ __forceinline__ uint32_t look_back(const unsigned long long* status, long long t,
                                              unsigned epoch) {
  const int lane = threadIdx.x & 31;
  uint32_t excl = 0;
  for (long long end = t;; end -= 32 * kLookBackPer) {
    unsigned flag[kLookBackPer];
    uint32_t value[kLookBackPer];
    int near;  // this lane's nearest prefix, kLookBackPer if it has none
    int nearest;  // the warp's nearest lane with a prefix, 32 if none
    while (true) {
#pragma unroll
      for (int j = 0; j < kLookBackPer; ++j) {
        const long long i = end - 1 - (lane * kLookBackPer + j);
        flag[j] = kPrefix;
        value[j] = 0;
        if (i >= 0) {
          const unsigned long long s = load_word(status + i);
          flag[j] = flag_of(s, epoch);
          value[j] = static_cast<uint32_t>(s);
        }
      }
      near = kLookBackPer;
      bool waiting = false;
#pragma unroll
      for (int j = 0; j < kLookBackPer; ++j) {
        if (near == kLookBackPer) {
          if (flag[j] == kPrefix) near = j;
          else if (flag[j] == 0) waiting = true;
        }
      }
      const unsigned prefixes = __ballot_sync(kWarpFull, near < kLookBackPer);
      nearest = prefixes ? __ffs(prefixes) - 1 : 32;
      const unsigned need = nearest < 32 ? (2u << nearest) - 1u : kWarpFull;
      if ((__ballot_sync(kWarpFull, waiting) & need) == 0) break;
    }
    uint32_t part = 0;
    if (lane <= nearest) {
#pragma unroll
      for (int j = 0; j < kLookBackPer; ++j) {
        if (j <= near) part += value[j];
      }
    }
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) part += __shfl_xor_sync(kWarpFull, part, d);
    excl += part;
    if (nearest < 32) return excl;
  }
}

// A block's shared state across its tiles.
struct TileShared {
  unsigned long long warp[32];
  unsigned long long agg;  // the tile's packed total
  long long ticket;
  uint32_t excl;  // the tile's first output slot
  uint32_t first;  // the first sentinel slot (helpers)
};

// The next tile of this block (every thread calls it).
__device__ __forceinline__ long long next_tile(unsigned long long* ticket, TileShared& sh) {
  if (threadIdx.x == 0) sh.ticket = static_cast<long long>(atomicAdd(ticket, 1ull));
  __syncthreads();
  return sh.ticket;
}

// After the block's failing ticket t (>= tiles): the launch's last
// ticket (every block takes exactly one failing ticket) sets the counter
// back to 0 for the next launch on this scratch.
__device__ __forceinline__ void release_ticket(unsigned long long* ticket, long long t,
                                               long long tiles) {
  if (threadIdx.x == 0 && t == tiles + static_cast<long long>(gridDim.x) - 1) {
    atomicExch(ticket, 0ull);
  }
}

// Every thread of a block of kThreads: ``v`` its packed counts (the low
// 32 bits entries to place, the high 32 a second sum).  Places tile t:
// returns the thread's exclusive packed prefix inside the tile; sh.excl
// is the tile's first output slot and sh.agg its packed total.
template <int kThreads>
__device__ __forceinline__ unsigned long long place_tile(unsigned long long v, long long t,
                                                         unsigned epoch,
                                                         unsigned long long* status,
                                                         TileShared& sh) {
  constexpr int kWarps = kThreads / 32;
  static_assert(kThreads % 32 == 0 && kWarps <= 32, "a block of 32 to 1024 threads");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned long long x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const unsigned long long y = __shfl_up_sync(kWarpFull, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) sh.warp[warp] = x;
  __syncthreads();
  if (warp == 0) {
    const unsigned long long own = lane < kWarps ? sh.warp[lane] : 0ull;
    unsigned long long w = own;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const unsigned long long y = __shfl_up_sync(kWarpFull, w, d);
      if (lane >= d) w += y;
    }
    const unsigned long long agg = __shfl_sync(kWarpFull, w, kWarps - 1);
    const uint32_t count = static_cast<uint32_t>(agg);
    uint32_t excl = 0;
    if (t == 0) {
      if (lane == 0) store_word(status, status_word(epoch, kPrefix, count));
    } else {
      if (lane == 0) store_word(status + t, status_word(epoch, kAggregate, count));
      excl = look_back(status, t, epoch);
      if (lane == 0) store_word(status + t, status_word(epoch, kPrefix, excl + count));
    }
    if (lane < kWarps) sh.warp[lane] = w - own;
    if (lane == 0) {
      sh.excl = excl;
      sh.agg = agg;
    }
  }
  __syncthreads();
  return sh.warp[warp] + x - v;
}

// Blocks that help the finalizer write ``elements`` sentinel values: none
// (the finalizer writes them itself, no hand-off) up to kFinalizerSentinels,
// else one a kSentinelChunk, at most the grid.
constexpr long long kFinalizerSentinels = 8192;
constexpr long long kSentinelChunk = 2048;

__device__ __forceinline__ long long sentinel_helpers(long long elements) {
  if (elements <= kFinalizerSentinels) return 0;
  const long long want = (elements + kSentinelChunk - 1) / kSentinelChunk;
  return want < gridDim.x ? want : gridDim.x;
}

// The sentinel writers: the blocks whose failing ticket index f = t -
// tiles is below ``helpers`` wait for the finalizer's first sentinel slot
// and return it (every thread), else return -1.
__device__ __forceinline__ long long sentinel_start(const unsigned long long* published,
                                                    long long f, long long helpers,
                                                    unsigned epoch, TileShared& sh) {
  if (f >= helpers) return -1;
  if (threadIdx.x == 0) sh.first = wait_value(published, epoch);
  __syncthreads();
  return sh.first;
}

}  // namespace scan
}  // namespace msbfs

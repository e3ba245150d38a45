// The 2D mesh engine's wire kernels (parallel/partition2d.py).
//
// M1 chunk_merge — the combine of the JAX package's col-axis
//   reduce-scatter, parallel/partition2d.py:571 _or_reduce_scatter with its
//   :558 _merge_op (and the ring / halving / one-shot trees that apply it
//   hop by hop): C chunks of ``words`` int32 values (a shard's (Lsub, W)
//   segment as every col-axis peer computed it) folded into one by OR (bit
//   planes, read as uint32) or by MAX (the async drive's int32
//   neg-distance planes: OR and MAX agree only on 0/1 lanes).  The chunks'
//   pointers travel in the launch's parameters (at most kMaxChunks).
//   With the commit epilogue (MAX only; ops/bitbell.py:193 neg_commit,
//   neg_commit.cuh):
//       delta[e] = merged[e] > neg[e];  neg[e] = max(neg[e], merged[e])
//   in place, ``acc`` ORed with delta (or set to it), the next local wave's
//   send ``send[e] = delta[e] ? merged[e] : 0`` written when given (the
//   exchange's commit writes the first wave's send in its own launch), and
//   ``*flag`` set to the caller's tag when some delta is set (never cleared
//   here), so the merged chunk itself is never stored.
//
// M2 wire_encode — partition2d.py:291 active_word_count and :305
//   encode_words_sparse: of a plane of ``total`` int32 words, the count of
//   its nonzero elements (words, or with lanes = 4 the nonzero bytes of a
//   byte-lane plane: the JAX package's uint8 elements) into ``count``
//   (int64), and the first ``budget`` flat indices of its nonzero words in
//   ascending order with their words; slots past the nonzero words hold
//   the sentinel ``total`` and 0.  The count is whole even when the list is
//   cut, so an overflow is detectable: the list is exact iff count <=
//   budget (a nonzero word holds at least one nonzero byte).  One launch:
//   blocks take tiles of kEncodeTile words by ticket (a grid of at most
//   kEncodeBlocksPerSm blocks an SM), each thread kEncodeWords
//   consecutive words in registers (two 16-byte loads where the plane is
//   aligned), counted once; the tile's first output slot comes from the
//   decoupled look-back of ordered_scan.cuh and its entries below the
//   budget are written from the registers.  The tile of the last word
//   writes the count (at lanes = 4 the sum of every tile's byte count,
//   published beside its status) and the sentinels, or on a long run of
//   them publishes the first sentinel slot to a few blocks that write them
//   after their last tile.
//   Deterministic: no atomic places an entry.
//
// The decode (partition2d.py:323 decode_words_sparse) is H1 halo_pair_or
// (halo_exchange.cu) over the flat buffer viewed as (total, 1) rows: real
// indices are unique and the sentinel falls outside the buffer, so an OR
// into zeros is JAX's scatter-max.
//
// Bound: bytes.  M1 reads C chunks and writes one (or reads and writes the
// neg plane and writes delta); M2 reads the plane once and writes the
// pairs.  M2's parent read the plane twice in two launches (0.0119 ms on a
// 262,144-word plane against a 0.000391 ms bound, NVIDIA H100 80GB HBM3,
// 700 W, chip_compare.py); in one launch it takes 0.0090 ms, the rest
// above the launch floor the look-back across its 128 tiles.
#include "msbfs_common.cuh"
#include "neg_commit.cuh"
#include "ordered_scan.cuh"

namespace {

constexpr int kMaxChunks = 16;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kOpOr = 0;
constexpr int kOpMax = 1;

struct Chunks {
  const int* p[kMaxChunks];
};

template <int kOp>
__device__ __forceinline__ int combine(int a, int b) {
  if constexpr (kOp == kOpOr) {
    return a | b;
  } else {
    return max(a, b);
  }
}

template <int kOp>
__device__ __forceinline__ int4 combine4(int4 a, int4 b) {
  return make_int4(combine<kOp>(a.x, b.x), combine<kOp>(a.y, b.y), combine<kOp>(a.z, b.z),
                   combine<kOp>(a.w, b.w));
}

// Element e's fold over the chunks: K chunks unrolled (the pointers stay
// in the parameter bank), or n of them when K is 0.  kVec: e indexes
// 16-byte groups of four elements.
template <int kOp, int K, bool kVec>
__device__ __forceinline__ auto fold_at(const Chunks& c, int n, long long e) {
  if constexpr (kVec) {
    int4 v = __ldcs(reinterpret_cast<const int4*>(c.p[0]) + e);
    if constexpr (K > 0) {
#pragma unroll
      for (int i = 1; i < K; ++i) {
        v = combine4<kOp>(v, __ldcs(reinterpret_cast<const int4*>(c.p[i]) + e));
      }
    } else {
      for (int i = 1; i < n; ++i) {
        v = combine4<kOp>(v, __ldcs(reinterpret_cast<const int4*>(c.p[i]) + e));
      }
    }
    return v;
  } else {
    int v = __ldcs(c.p[0] + e);
    if constexpr (K > 0) {
#pragma unroll
      for (int i = 1; i < K; ++i) v = combine<kOp>(v, __ldcs(c.p[i] + e));
    } else {
      for (int i = 1; i < n; ++i) v = combine<kOp>(v, __ldcs(c.p[i] + e));
    }
    return v;
  }
}

template <int kOp, int K, bool kVec>
__global__ void __launch_bounds__(msbfs::kThreads)
chunk_merge_kernel(Chunks chunks, int n, long long items, int* __restrict__ out) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long e = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       e < items; e += stride) {
    const auto v = fold_at<kOp, K, kVec>(chunks, n, e);
    if constexpr (kVec) {
      reinterpret_cast<int4*>(out)[e] = v;
    } else {
      out[e] = v;
    }
  }
}

template <int K, bool kVec>
__global__ void __launch_bounds__(msbfs::kThreads)
chunk_commit_kernel(Chunks chunks, int n, long long items, const msbfs::NegCommit c) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  bool any = false;
  for (long long e = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       e < items; e += stride) {
    const auto cand = fold_at<kOpMax, K, kVec>(chunks, n, e);
    if constexpr (kVec) {
      any |= msbfs::commit_quad(c, cand, e);
    } else {
      any |= msbfs::commit_lane(c, cand, e);
    }
  }
  msbfs::commit_flag(c, any);
}

template <int K, bool kVec>
void launch_merge(const Chunks& c, int n, long long items, int op, void* out,
                  const msbfs::NegCommit* commit, cudaStream_t s) {
  const int grid = msbfs::grid_for(items, msbfs::kThreads);
  if (commit != nullptr) {
    chunk_commit_kernel<K, kVec><<<grid, msbfs::kThreads, 0, s>>>(c, n, items, *commit);
  } else if (op == kOpOr) {
    chunk_merge_kernel<kOpOr, K, kVec><<<grid, msbfs::kThreads, 0, s>>>(
        c, n, items, static_cast<int*>(out));
  } else {
    chunk_merge_kernel<kOpMax, K, kVec><<<grid, msbfs::kThreads, 0, s>>>(
        c, n, items, static_cast<int*>(out));
  }
}

template <bool kVec>
void launch_merge_k(const Chunks& c, int n, long long items, int op, void* out,
                    const msbfs::NegCommit* commit, cudaStream_t s) {
  switch (n) {
    case 1: launch_merge<1, kVec>(c, n, items, op, out, commit, s); break;
    case 2: launch_merge<2, kVec>(c, n, items, op, out, commit, s); break;
    case 3: launch_merge<3, kVec>(c, n, items, op, out, commit, s); break;
    case 4: launch_merge<4, kVec>(c, n, items, op, out, commit, s); break;
    default: launch_merge<0, kVec>(c, n, items, op, out, commit, s); break;
  }
}

// Nonzero elements of one word: the word, or its nonzero bytes.
__device__ __forceinline__ int lanes_of(uint32_t x, int lanes) {
  if (lanes == 1) return x != 0u;
  return ((x & 0xffu) != 0u) + ((x & 0xff00u) != 0u) + ((x & 0xff0000u) != 0u) +
         ((x >> 24) != 0u);
}

constexpr int kEncodeThreads = 256;
// Consecutive words a thread takes a tile (two 16-byte groups).
constexpr int kEncodeWords = 8;
constexpr long long kEncodeTile = kEncodeThreads * kEncodeWords;
constexpr int kEncodeBlocksPerSm = 2;

// The sentinels (total, 0) over slots [first, budget): thread ``me`` of
// ``stride``.
__device__ __forceinline__ void fill_encoded(long long first, long long budget, long long total,
                                             int* idx, int* vals, long long me,
                                             long long stride) {
  for (long long at = first + me; at < budget; at += stride) {
    idx[at] = static_cast<int>(total);
    vals[at] = 0;
  }
}

// M2.  kVec: the plane is 16-byte aligned (groups of four words wholly
// inside it load as one uint4).
template <bool kVec>
__global__ void __launch_bounds__(kEncodeThreads)
encode_kernel(const uint32_t* __restrict__ plane, long long total, int lanes, long long budget,
              int* __restrict__ idx, int* __restrict__ vals, long long* __restrict__ count,
              unsigned long long* __restrict__ scratch, long long tiles, unsigned epoch) {
  namespace scan = msbfs::scan;
  __shared__ scan::TileShared sh;
  __shared__ unsigned long long s_sum[kEncodeThreads / 32];
  unsigned long long* ticket = scratch;
  unsigned long long* published = scratch + 1;
  unsigned long long* status = scratch + scan::kHeader;
  unsigned long long* bytes = status + tiles;
  const long long helpers = scan::sentinel_helpers(2 * budget);
  long long t;
  while ((t = scan::next_tile(ticket, sh)) < tiles) {
    const long long w0 = t * kEncodeTile + static_cast<long long>(threadIdx.x) * kEncodeWords;
    uint32_t x[kEncodeWords];
#pragma unroll
    for (int g = 0; g < kEncodeWords; g += 4) {
      const long long e = w0 + g;
      if (kVec && e + 4 <= total) {
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(plane + e));
        x[g] = v.x;
        x[g + 1] = v.y;
        x[g + 2] = v.z;
        x[g + 3] = v.w;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) x[g + j] = e + j < total ? __ldg(plane + e + j) : 0u;
      }
    }
    unsigned nz = 0;
    unsigned elements = 0;
#pragma unroll
    for (int j = 0; j < kEncodeWords; ++j) {
      nz |= static_cast<unsigned>(x[j] != 0u) << j;
      elements += lanes_of(x[j], lanes);
    }
    const unsigned long long before = scan::place_tile<kEncodeThreads>(
        __popc(nz) | (static_cast<unsigned long long>(elements) << 32), t, epoch, status, sh);
    const long long excl = sh.excl;
    const unsigned long long agg = sh.agg;
    if (lanes != 1 && threadIdx.x == 0) {
      scan::store_word(bytes + t, scan::status_word(epoch, scan::kPrefix,
                                                       static_cast<uint32_t>(agg >> 32)));
    }
    long long at = excl + static_cast<uint32_t>(before);
#pragma unroll
    for (int j = 0; j < kEncodeWords; ++j) {
      if ((nz >> j) & 1u) {
        if (at < budget) {
          idx[at] = static_cast<int>(w0 + j);
          vals[at] = static_cast<int>(x[j]);
        }
        ++at;
      }
    }
    if (t == tiles - 1) {
      // The finalizer: the whole count, then the first sentinel slot.
      const long long words = excl + static_cast<uint32_t>(agg);
      unsigned long long sum = 0;
      if (lanes == 1) {
        sum = threadIdx.x == 0 ? static_cast<unsigned long long>(words) : 0ull;
      } else {
        for (long long i = threadIdx.x; i < tiles; i += kEncodeThreads) {
          sum += scan::wait_value(bytes + i, epoch);
        }
      }
#pragma unroll
      for (int d = 16; d > 0; d >>= 1) sum += __shfl_xor_sync(kFull, sum, d);
      if ((threadIdx.x & 31) == 0) s_sum[threadIdx.x >> 5] = sum;
      __syncthreads();
      const long long first = min(words, budget);
      if (threadIdx.x == 0) {
        unsigned long long all = 0;
        for (int w = 0; w < kEncodeThreads / 32; ++w) all += s_sum[w];
        *count = static_cast<long long>(all);
        if (helpers) {
          scan::store_word(published, scan::status_word(epoch, scan::kPrefix,
                                                        static_cast<uint32_t>(first)));
        }
      }
      if (!helpers) fill_encoded(first, budget, total, idx, vals, threadIdx.x, kEncodeThreads);
    }
  }
  scan::release_ticket(ticket, t, tiles);
  // Past kFinalizerSentinels, helpers write the sentinels (total, 0) over
  // [min(words, budget), budget).
  const long long first = scan::sentinel_start(published, t - tiles, helpers, epoch, sh);
  if (first < 0) return;
  fill_encoded(first, budget, total, idx, vals, (t - tiles) * kEncodeThreads + threadIdx.x,
               helpers * kEncodeThreads);
}

}  // namespace

// M1.  chunk_ptrs: ``chunks`` device pointers (host memory, int64) to
// int32 arrays of ``words`` elements.  op 0 OR, 1 MAX.  Without commit
// (neg == null) the fold is written to ``out``; with it (op 1 only) neg is
// updated in place, delta (words uint8) written, acc (uint8, or null) ORed
// with delta (acc_set 0) or set to it (acc_set 1), send (words int32, or
// null) written delta ? merged : 0, and flag (int32, or null) set to
// ``tag`` on any delta.
extern "C" int msbfs_chunk_merge(int device, const long long* chunk_ptrs, int chunks,
                                 long long words, int op, void* out, void* neg,
                                 void* delta, void* acc, void* flag, int acc_set, int tag,
                                 void* send, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool commit = neg != nullptr;
  if (chunks < 1 || chunks > kMaxChunks || words < 0 || (op != kOpOr && op != kOpMax) ||
      (commit && (op != kOpMax || delta == nullptr)) || (!commit && out == nullptr) ||
      (acc_set != 0 && acc_set != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (words == 0) return static_cast<int>(cudaSuccess);
  Chunks c{};
  bool aligned = words % 4 == 0;
  for (int i = 0; i < chunks; ++i) {
    c.p[i] = reinterpret_cast<const int*>(chunk_ptrs[i]);
    aligned &= chunk_ptrs[i] % 16 == 0;
  }
  msbfs::NegCommit nc{static_cast<int*>(neg), static_cast<uint8_t*>(delta),
                      static_cast<uint8_t*>(acc), static_cast<int*>(send),
                      static_cast<int*>(flag), acc_set, tag};
  aligned &= commit ? msbfs::quad_aligned(nc) : reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const msbfs::NegCommit* pc = commit ? &nc : nullptr;
  const auto s = static_cast<cudaStream_t>(stream);
  if (aligned) {
    launch_merge_k<true>(c, chunks, words / 4, op, out, pc, s);
  } else {
    launch_merge_k<false>(c, chunks, words, op, out, pc, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// M2.  plane: ``total`` int32 words; lanes 1 (count words) or 4 (count
// nonzero bytes); idx and vals: ``budget`` int32 each; count: one int64;
// scratch: 2 + 2 * ceil(total / kEncodeTile) int64 of ordered_scan.cuh,
// ``epoch`` in [1, 2^30), new for every launch on that scratch.
extern "C" int msbfs_wire_encode(int device, const void* plane, long long total, int lanes,
                                 long long budget, void* idx, void* vals, void* count,
                                 void* scratch, unsigned epoch, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (total < 1 || total >= (1LL << 31) || budget < 0 || (lanes != 1 && lanes != 4) ||
      scratch == nullptr || epoch == 0 || epoch >= msbfs::scan::kEpochs) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int sms = 0;
  err = msbfs::sm_count(device, &sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tiles = (total + kEncodeTile - 1) / kEncodeTile;
  const long long most = static_cast<long long>(sms) * kEncodeBlocksPerSm;
  const int grid = static_cast<int>(tiles < most ? tiles : most);
  const auto s = static_cast<cudaStream_t>(stream);
  auto* sc = static_cast<unsigned long long*>(scratch);
  if (reinterpret_cast<uintptr_t>(plane) % 16 == 0) {
    encode_kernel<true><<<grid, kEncodeThreads, 0, s>>>(
        static_cast<const uint32_t*>(plane), total, lanes, budget, static_cast<int*>(idx),
        static_cast<int*>(vals), static_cast<long long*>(count), sc, tiles, epoch);
  } else {
    encode_kernel<false><<<grid, kEncodeThreads, 0, s>>>(
        static_cast<const uint32_t*>(plane), total, lanes, budget, static_cast<int*>(idx),
        static_cast<int*>(vals), static_cast<long long*>(count), sc, tiles, epoch);
  }
  return static_cast<int>(cudaGetLastError());
}

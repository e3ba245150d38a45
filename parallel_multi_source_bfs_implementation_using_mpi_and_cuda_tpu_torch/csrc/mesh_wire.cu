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
//   With the commit epilogue (MAX only; ops/bitbell.py:193 neg_commit):
//       delta[e] = merged[e] > neg[e];  neg[e] = max(neg[e], merged[e])
//   in place, ``acc[e] |= delta[e]`` when ``acc`` is given, and ``*flag``
//   set to 1 when some delta is set (never cleared here), so the merged
//   chunk itself is never stored.
//
// M2 wire_encode — partition2d.py:291 active_word_count and :305
//   encode_words_sparse: of a plane of ``total`` int32 words, the count of
//   its nonzero elements (words, or with lanes = 4 the nonzero bytes of a
//   byte-lane plane: the JAX package's uint8 elements) into ``count``
//   (int64), and the first ``budget`` flat indices of its nonzero words in
//   ascending order with their words; slots past the nonzero words hold
//   the sentinel ``total`` and 0.  The count is whole even when the list is
//   cut, so an overflow is detectable: the list is exact iff count <=
//   budget (a nonzero word holds at least one nonzero byte).  Two
//   launches: each block counts its contiguous range of words into the
//   scratch; then each block sums the counts before its range (its first
//   output slot), scans its range a tile at a time (ballots and a
//   block-wide prefix of the warps' sums) and writes its entries that fall
//   below the budget, and the grid writes the sentinels.  Deterministic:
//   no atomics place an entry.
//
// The decode (partition2d.py:323 decode_words_sparse) is H1 halo_pair_or
// (halo_exchange.cu) over the flat buffer viewed as (total, 1) rows: real
// indices are unique and the sentinel falls outside the buffer, so an OR
// into zeros is JAX's scatter-max.
//
// Bound: bytes.  M1 reads C chunks and writes one (or reads and writes the
// neg plane and writes delta); M2 reads the plane twice (count, then
// write) and writes the pairs.
#include "msbfs_common.cuh"

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

// The commit of one element: neg[e] = max(neg[e], cand), delta, acc.
__device__ __forceinline__ bool commit_one(int cand, int* neg, uint8_t* delta, uint8_t* acc,
                                           long long e) {
  const int old = neg[e];
  const bool d = cand > old;
  if (d) neg[e] = cand;
  delta[e] = d ? 1 : 0;
  if (acc != nullptr && d) acc[e] = 1;
  return d;
}

template <int K, bool kVec>
__global__ void __launch_bounds__(msbfs::kThreads)
chunk_commit_kernel(Chunks chunks, int n, long long items, int* __restrict__ neg,
                    uint8_t* __restrict__ delta, uint8_t* __restrict__ acc,
                    int* __restrict__ flag) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  bool any = false;
  for (long long e = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       e < items; e += stride) {
    const auto cand = fold_at<kOpMax, K, kVec>(chunks, n, e);
    if constexpr (kVec) {
      any |= commit_one(cand.x, neg, delta, acc, 4 * e);
      any |= commit_one(cand.y, neg, delta, acc, 4 * e + 1);
      any |= commit_one(cand.z, neg, delta, acc, 4 * e + 2);
      any |= commit_one(cand.w, neg, delta, acc, 4 * e + 3);
    } else {
      any |= commit_one(cand, neg, delta, acc, e);
    }
  }
  if (flag != nullptr && __any_sync(kFull, any) && (threadIdx.x & 31) == 0) {
    atomicExch(flag, 1);
  }
}

template <int K, bool kVec>
void launch_merge(const Chunks& c, int n, long long items, int op, void* out, void* neg,
                  void* delta, void* acc, void* flag, cudaStream_t s) {
  const int grid = msbfs::grid_for(items, msbfs::kThreads);
  if (neg != nullptr) {
    chunk_commit_kernel<K, kVec><<<grid, msbfs::kThreads, 0, s>>>(
        c, n, items, static_cast<int*>(neg), static_cast<uint8_t*>(delta),
        static_cast<uint8_t*>(acc), static_cast<int*>(flag));
  } else if (op == kOpOr) {
    chunk_merge_kernel<kOpOr, K, kVec><<<grid, msbfs::kThreads, 0, s>>>(
        c, n, items, static_cast<int*>(out));
  } else {
    chunk_merge_kernel<kOpMax, K, kVec><<<grid, msbfs::kThreads, 0, s>>>(
        c, n, items, static_cast<int*>(out));
  }
}

template <bool kVec>
void launch_merge_k(const Chunks& c, int n, long long items, int op, void* out, void* neg,
                    void* delta, void* acc, void* flag, cudaStream_t s) {
  switch (n) {
    case 1: launch_merge<1, kVec>(c, n, items, op, out, neg, delta, acc, flag, s); break;
    case 2: launch_merge<2, kVec>(c, n, items, op, out, neg, delta, acc, flag, s); break;
    case 3: launch_merge<3, kVec>(c, n, items, op, out, neg, delta, acc, flag, s); break;
    case 4: launch_merge<4, kVec>(c, n, items, op, out, neg, delta, acc, flag, s); break;
    default: launch_merge<0, kVec>(c, n, items, op, out, neg, delta, acc, flag, s); break;
  }
}

// Nonzero elements of one word: the word, or its nonzero bytes.
__device__ __forceinline__ int lanes_of(uint32_t x, int lanes) {
  if (lanes == 1) return x != 0u;
  return ((x & 0xffu) != 0u) + ((x & 0xff00u) != 0u) + ((x & 0xff0000u) != 0u) +
         ((x >> 24) != 0u);
}

// Launch 1: block b's nonzero words and elements over words [b*span, ...).
__global__ void __launch_bounds__(msbfs::kThreads)
encode_count_kernel(const uint32_t* __restrict__ plane, long long total, long long span,
                    int lanes, long long* __restrict__ scratch) {
  __shared__ long long s_sum[2];
  if (threadIdx.x < 2) s_sum[threadIdx.x] = 0;
  __syncthreads();
  const long long lo = blockIdx.x * span;
  const long long hi = min(total, lo + span);
  long long nz = 0, el = 0;
  for (long long e = lo + threadIdx.x; e < hi; e += blockDim.x) {
    const uint32_t x = __ldcg(plane + e);
    nz += x != 0u;
    el += lanes_of(x, lanes);
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    nz += __shfl_xor_sync(kFull, nz, d);
    el += __shfl_xor_sync(kFull, el, d);
  }
  if ((threadIdx.x & 31) == 0 && (nz | el)) {
    atomicAdd(reinterpret_cast<unsigned long long*>(s_sum), static_cast<unsigned long long>(nz));
    atomicAdd(reinterpret_cast<unsigned long long*>(s_sum + 1),
              static_cast<unsigned long long>(el));
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    scratch[blockIdx.x] = s_sum[0];
    scratch[gridDim.x + blockIdx.x] = s_sum[1];
  }
}

// Launch 2: block b writes its entries below the budget; every block
// writes its share of the sentinels; block 0 publishes the count.
__global__ void __launch_bounds__(msbfs::kThreads)
encode_write_kernel(const uint32_t* __restrict__ plane, long long total, long long span,
                    long long budget, const long long* __restrict__ scratch,
                    int* __restrict__ idx, int* __restrict__ vals,
                    long long* __restrict__ count) {
  __shared__ long long s_red[3];
  __shared__ int s_warp[msbfs::kThreads / 32];
  if (threadIdx.x < 3) s_red[threadIdx.x] = 0;
  __syncthreads();
  // Words before this block's range, all words, all elements.
  long long before = 0, words = 0, elements = 0;
  for (int b = threadIdx.x; b < gridDim.x; b += blockDim.x) {
    const long long c = scratch[b];
    words += c;
    elements += scratch[gridDim.x + b];
    if (b < static_cast<int>(blockIdx.x)) before += c;
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    before += __shfl_xor_sync(kFull, before, d);
    words += __shfl_xor_sync(kFull, words, d);
    elements += __shfl_xor_sync(kFull, elements, d);
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
    atomicAdd(reinterpret_cast<unsigned long long*>(s_red), static_cast<unsigned long long>(before));
    atomicAdd(reinterpret_cast<unsigned long long*>(s_red + 1),
              static_cast<unsigned long long>(words));
    atomicAdd(reinterpret_cast<unsigned long long*>(s_red + 2),
              static_cast<unsigned long long>(elements));
  }
  __syncthreads();
  before = s_red[0];
  words = s_red[1];
  if (blockIdx.x == 0 && threadIdx.x == 0) *count = s_red[2];
  const long long lo = blockIdx.x * span;
  const long long hi = min(total, lo + span);
  long long pos = before;  // the slot of the tile's first entry
  for (long long t0 = lo; t0 < hi && pos < budget; t0 += blockDim.x) {
    const long long e = t0 + threadIdx.x;
    const uint32_t x = e < hi ? __ldcg(plane + e) : 0u;
    const unsigned ballot = __ballot_sync(kFull, x != 0u);
    if (lane == 0) s_warp[warp] = __popc(ballot);
    __syncthreads();
    int off = 0, tile = 0;
    for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) {
      if (w < warp) off += s_warp[w];
      tile += s_warp[w];
    }
    if (x != 0u) {
      const long long at = pos + off + __popc(ballot & ((1u << lane) - 1u));
      if (at < budget) {
        idx[at] = static_cast<int>(e);
        vals[at] = static_cast<int>(x);
      }
    }
    pos += tile;
    __syncthreads();  // s_warp is rewritten by the next tile
  }
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long at = min(words, budget) + blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
       at < budget; at += stride) {
    idx[at] = static_cast<int>(total);
    vals[at] = 0;
  }
}

}  // namespace

// M1.  chunk_ptrs: ``chunks`` device pointers (host memory, int64) to
// int32 arrays of ``words`` elements.  op 0 OR, 1 MAX.  Without commit
// (neg == null) the fold is written to ``out``; with it (op 1 only) neg is
// updated in place, delta (words uint8) written, acc (uint8, or null)
// ORed with delta and flag (int32, or null) set to 1 on any delta.
extern "C" int msbfs_chunk_merge(int device, const long long* chunk_ptrs, int chunks,
                                 long long words, int op, void* out, void* neg,
                                 void* delta, void* acc, void* flag, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool commit = neg != nullptr;
  if (chunks < 1 || chunks > kMaxChunks || words < 0 || (op != kOpOr && op != kOpMax) ||
      (commit && (op != kOpMax || delta == nullptr)) || (!commit && out == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (words == 0) return static_cast<int>(cudaSuccess);
  Chunks c{};
  bool aligned = words % 4 == 0;
  for (int i = 0; i < chunks; ++i) {
    c.p[i] = reinterpret_cast<const int*>(chunk_ptrs[i]);
    aligned &= chunk_ptrs[i] % 16 == 0;
  }
  aligned &= reinterpret_cast<uintptr_t>(commit ? neg : out) % 16 == 0;
  const auto s = static_cast<cudaStream_t>(stream);
  if (aligned) {
    launch_merge_k<true>(c, chunks, words / 4, op, out, neg, delta, acc, flag, s);
  } else {
    launch_merge_k<false>(c, chunks, words, op, out, neg, delta, acc, flag, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// M2.  plane: ``total`` int32 words; lanes 1 (count words) or 4 (count
// nonzero bytes); idx and vals: ``budget`` int32 each; count: one int64;
// scratch: 2 * blocks int64 (any contents).
extern "C" int msbfs_wire_encode(int device, const void* plane, long long total, int lanes,
                                 long long budget, void* idx, void* vals, void* count,
                                 void* scratch, int blocks, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (total < 1 || total >= (1LL << 31) || budget < 0 || (lanes != 1 && lanes != 4) ||
      blocks < 1 || blocks > msbfs::kMaxBlocks) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long span = (total + blocks - 1) / blocks;
  const auto s = static_cast<cudaStream_t>(stream);
  auto* sc = static_cast<long long*>(scratch);
  const auto* p = static_cast<const uint32_t*>(plane);
  encode_count_kernel<<<blocks, msbfs::kThreads, 0, s>>>(p, total, span, lanes, sc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  encode_write_kernel<<<blocks, msbfs::kThreads, 0, s>>>(
      p, total, span, budget, sc, static_cast<int*>(idx), static_cast<int*>(vals),
      static_cast<long long*>(count));
  return static_cast<int>(cudaGetLastError());
}

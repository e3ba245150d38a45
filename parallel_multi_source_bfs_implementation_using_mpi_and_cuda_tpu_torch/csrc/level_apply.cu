// Kernel C — the bit-plane level apply with per-query popcount.
//
// Replaces the XLA ops of the JAX package's ops/bitbell.py:333
// bit_level_apply and :123 unpack_counts (one BFS level's accounting over
// the 7-tuple carry).  For a (rows, W) plane and K = 32W queries:
//
//   new      = hits & ~visited
//   visited |= new;  frontier = new
//   count[q] = number of vertices with bit q of new set   (popcount per query)
//   then, in the last block to finish:
//     f[q] += count[q] * (level + 1)      (int64, reference main.cu:75-89)
//     levels[q] = level + 2 where count[q] > 0
//     reached[q] += count[q]
//     updated = any(count > 0);  level += 1
//
// torch has no popcount; the JAX version unpacks every word into 32 lanes.
//
// Bound: bytes.  Per level it must read hits and visited and write visited
// and frontier: rows * 16W bytes (the visited write is skipped where nothing
// is new).  The per-query count is the operation-heavy part: 32 bit tests
// per word.  Design: each warp owns 32 consecutive vertices of one word
// column, so bit b of the warp's 32 words is one __ballot_sync and its count
// one __popc — 32 ballots per 32 words, done only when some word of the
// warp is nonzero.  Lane b keeps query b's count, blocks reduce in shared
// memory and add once per query to a (K,) device vector; the block that
// takes the last ticket folds those counts into the per-query counters and
// advances the device-side level control, so a level costs one launch and
// no host round trip.
#include "msbfs_common.cuh"

namespace {

__global__ void __launch_bounds__(msbfs::kThreads)
level_apply_kernel(const uint32_t* __restrict__ hits,
                   uint32_t* __restrict__ visited,
                   uint32_t* __restrict__ frontier, long long rows, int W,
                   int* __restrict__ counts, long long* __restrict__ f,
                   int* __restrict__ levels, int* __restrict__ reached,
                   int* __restrict__ ctrl, int max_levels) {
  extern __shared__ int s_counts[];  // K = 32 * W per-query partials
  __shared__ int s_last;
  if (!msbfs::level_go(ctrl, max_levels)) return;
  const int level = __ldcg(ctrl + 1);
  const int K = 32 * W;
  for (int q = threadIdx.x; q < K; q += blockDim.x) s_counts[q] = 0;
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const long long groups = (rows + 31) / 32;
  const long long total_warps = groups * W;
  for (long long g = static_cast<long long>(blockIdx.x) * warps +
                     (threadIdx.x >> 5);
       g < total_warps; g += static_cast<long long>(gridDim.x) * warps) {
    // g is uniform across the warp, so the ballots below see every lane.
    const int w = static_cast<int>(g % W);
    const long long v = (g / W) * 32 + lane;
    uint32_t x = 0;
    if (v < rows) {
      const long long i = v * W + w;
      const uint32_t vis = visited[i];
      x = __ldg(hits + i) & ~vis;
      if (x) visited[i] = vis | x;
      frontier[i] = x;
    }
    if (__any_sync(0xffffffffu, x != 0)) {
      int mine = 0;
#pragma unroll
      for (int b = 0; b < 32; ++b) {
        const unsigned bal = __ballot_sync(0xffffffffu, (x >> b) & 1u);
        if (lane == b) mine = __popc(bal);
      }
      if (mine) atomicAdd(s_counts + w * 32 + lane, mine);
    }
  }
  __syncthreads();
  for (int q = threadIdx.x; q < K; q += blockDim.x) {
    const int c = s_counts[q];
    if (c) atomicAdd(counts + q, c);
  }
  // Last-block tail: make this block's count atomics visible before it
  // takes a ticket; the block that takes the last ticket sees them all.
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    s_last = atomicAdd(ctrl + 2, 1) == static_cast<int>(gridDim.x) - 1;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const long long dist = static_cast<long long>(level) + 1;
  int found = 0;
  for (int q = threadIdx.x; q < K; q += blockDim.x) {
    const int c = atomicExch(counts + q, 0);
    if (c > 0) {
      found = 1;
      f[q] += static_cast<long long>(c) * dist;
      levels[q] = level + 2;
      reached[q] += c;
    }
  }
  found = __syncthreads_or(found);
  if (threadIdx.x == 0) {
    ctrl[0] = found;
    ctrl[1] = level + 1;
    ctrl[2] = 0;
  }
}

}  // namespace

extern "C" int msbfs_level_apply(int device, const void* hits, void* visited,
                                 void* frontier, long long rows, int W,
                                 void* counts, void* f, void* levels,
                                 void* reached, void* ctrl, int max_levels,
                                 void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (W < 1 || rows < 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long warps = ((rows + 31) / 32) * W;
  const int grid = msbfs::grid_for(warps, msbfs::kThreads / 32);
  const size_t shmem = static_cast<size_t>(32) * W * sizeof(int);
  level_apply_kernel<<<grid, msbfs::kThreads, shmem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(hits), static_cast<uint32_t*>(visited),
      static_cast<uint32_t*>(frontier), rows, W, static_cast<int*>(counts),
      static_cast<long long*>(f), static_cast<int*>(levels),
      static_cast<int*>(reached), static_cast<int*>(ctrl), max_levels);
  return static_cast<int>(cudaGetLastError());
}

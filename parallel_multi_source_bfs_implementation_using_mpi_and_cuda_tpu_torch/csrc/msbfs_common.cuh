// Shared by the port's hand-written kernels (one shared library per .cu,
// each with a plain C interface loaded through ctypes).
//
// Bit planes are int32 tensors on the PyTorch side and uint32 here: query
// 32w+b is bit b of word w of a vertex's row, so shifts are logical and bit
// 31 needs no masking.
//
// Level-loop control lives on the device, so the host can enqueue a whole
// chunk of levels without waiting on any of them:
//   ctrl[0] = updated  (the previous level discovered something)
//   ctrl[1] = level    (levels applied so far)
//   ctrl[2] = blocks of the running level_apply (or batch_start) launch that
//             have finished
//   ctrl[3] = the next level's expansion direction on a direction-switched
//             route: kDirMatmul / kDirPull (tile_hits or forest_or runs) or
//             kDirPush (the push runs), written by the level apply that
//             made the frontier (for the sources, by the batch start,
//             batch_start.cu); the stencil kernels never read it
// The switch state of a direction-switched route (level_apply.cu and
// batch_start.cu write it, the push walk of push_walk.cuh reads it) is a
// (kSwitchWords,) int64 vector, a
// (2, capacity) int32 worklist — row 0 the active frontier rows that have
// out-edges, row 1 each one's exclusive prefix of out-degrees in list
// order (its first edge in the push's edge space) — and the push's own
// hit plane, all zero between levels.
//   state[kListed]      = worklist length, min(appended rows, capacity)
//   state[kListedEdges] = out-edges of the appended rows
//   state[kActiveRows], state[kActiveEdges] = the frontier's active rows
//                         and their out-edges: the predicate's inputs
//   state[kAppend]      = (rows << 32) | edges appended so far (scratch)
//   state[kOtherRows], state[kOtherEdges] = active rows (and their edges)
//                         counted without an append (scratch)
// The apply's last block moves the scratch into the first four and
// clears it, so every level starts from zero.
// The ELL route keeps its own per-query control (ell_hits.cu).
// A launch whose level must not run (converged, or level >= max_levels)
// returns at once, which is what makes launches after convergence no-ops.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace msbfs {

constexpr int kThreads = 256;
// Grid-stride loops over at most this many blocks: enough resident warps
// to stream device memory on 132 SMs, and cheap to launch when the level
// is gated off.
constexpr long long kMaxBlocks = 132 * 8;

__device__ __forceinline__ bool level_go(const int* ctrl, int max_levels) {
  // __ldcg: read through L2 — ctrl is rewritten by the previous launch.
  return __ldcg(ctrl) != 0 && __ldcg(ctrl + 1) < max_levels;
}

constexpr int kDirMatmul = 0;
constexpr int kDirPull = 0;  // the forest route's name for direction 0
constexpr int kDirPush = 1;

// level_go, and the level's direction (ctrl[3]) is ``dir``.
__device__ __forceinline__ bool direction_go(const int* ctrl, int max_levels,
                                             int dir) {
  return level_go(ctrl, max_levels) && __ldcg(ctrl + 3) == dir;
}

constexpr int kListed = 0;
constexpr int kListedEdges = 1;
constexpr int kActiveRows = 2;
constexpr int kActiveEdges = 3;
constexpr int kAppend = 4;
constexpr int kOtherRows = 5;
constexpr int kOtherEdges = 6;
constexpr int kSwitchWords = 8;

inline int grid_for(long long items, int per_block) {
  long long blocks = (items + per_block - 1) / per_block;
  if (blocks < 1) blocks = 1;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  return static_cast<int>(blocks);
}

// Device ordinals whose per-device launch settings are cached.
constexpr int kMaxDevices = 64;

// Streaming multiprocessors of ``device`` (cached after the first query).
inline cudaError_t sm_count(int device, int* out) {
  static int cache[kMaxDevices] = {};
  const bool cached = device >= 0 && device < kMaxDevices;
  if (cached && cache[device]) {
    *out = cache[device];
    return cudaSuccess;
  }
  const cudaError_t err =
      cudaDeviceGetAttribute(out, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess && cached) cache[device] = *out;
  return err;
}

// Lets ``kernel`` take ``bytes`` of dynamic shared memory (above 48 KB only
// after cudaFuncSetAttribute); ``allowed`` is the caller's per-device
// record of what it already set for this kernel.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, int bytes, int* allowed,
                              int device) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  const bool cached = device >= 0 && device < kMaxDevices;
  if (cached && allowed[device] >= bytes) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && cached) allowed[device] = bytes;
  return err;
}

// Asynchronous global -> shared copies (sm_80+): 16 bytes (both addresses
// 16-byte aligned, L2 only) or 4 bytes.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Waits until at most N of this thread's newest cp.async groups are
// still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace msbfs

extern "C" const char* msbfs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Kernel K12 — one relaxation pass of the weighted route (delta-stepping).
//
// Replaces the XLA scatter-min of the JAX package's weighted/deltastep.py:84
// _relax_scatter_min, ``tent.at[:, v].min(where(active[:, u] & sel,
// tent[:, u] + w, INF))``, whose torch form (scatter_reduce_ "amin" over a
// (K, slots) candidate array) needs 12 bytes of intermediates per query and
// slot: 24 GB a pass at RMAT-20 with K = 64.  For the slots s in [lo, hi) of
// the (u, v, w) slot arrays and every query k:
//
//   if active[k, u_s] and slot s is on the pass's side of delta
//   (light: w_s <= delta, heavy: w_s > delta):
//     out[k, v_s] = min(out[k, v_s], tent[k, u_s] + w_s)
//
// ``out`` enters as a copy of ``tent`` (the wrapper's device-to-device copy
// on the same stream) and the kernel reads candidates from ``tent`` only:
// the Jacobi pass of the JAX engine, so the improved sets, the light passes
// and the relaxation counters of the drive loop equal JAX's, whichever
// slots a flavor hands in.  No candidate is formed where active does not
// hold, so INF + w never exists.  Commits are int32 atomicMin, which is
// exact in any order.
//
// Bound: bytes.  A pass must read w over the range (4 bytes a slot), u and
// v of the selected side's slots (8 bytes), the active plane at the rows
// those slots leave, tent where those rows are active, and write the cells
// of out that improve (``out``'s copy of ``tent`` is the caller's).
// Design: a thread a slot, with u, v, w in registers, walking the K
// queries; the dedup slots are sorted by u, so a warp's slots share a few
// rows and its active/tent reads of one query fall in one or two sectors;
// the random part is the commit, which is read first and taken only when
// the candidate improves on what ``out`` holds (``out`` only falls, so a
// skipped commit is never needed).  Slots of the other side cost their w
// read alone.  Redesign left for later: a per-row
// "some query active" bit, so that slots of idle rows cost a bit test.
#include "msbfs_common.cuh"

namespace {

__global__ void __launch_bounds__(msbfs::kThreads)
weighted_relax_kernel(const int* __restrict__ tent, int* __restrict__ out,
                      const unsigned char* __restrict__ active,
                      long long n_state, int K, const int* __restrict__ u,
                      const int* __restrict__ v, const int* __restrict__ w,
                      long long lo, long long hi, int delta, int light) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long s = lo + static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       s < hi; s += stride) {
    const int ws = __ldg(w + s);
    if ((ws <= delta) != (light != 0)) continue;
    const long long us = __ldg(u + s);
    const long long vs = __ldg(v + s);
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      const long long row = static_cast<long long>(k) * n_state;
      if (!__ldg(active + row + us)) continue;
      const int cand = __ldg(tent + row + us) + ws;
      int* dst = out + row + vs;
      if (cand < __ldcg(dst)) atomicMin(dst, cand);
    }
  }
}

}  // namespace

// tent, out: (K, n_state) int32, out a copy of tent; active: (K, n_state)
// bool (one byte a cell); u, v, w: int32 slot arrays, of which [lo, hi) is
// relaxed; light: 1 for the slots with w <= delta, 0 for the others.
extern "C" int msbfs_weighted_relax(int device, const void* tent, void* out,
                                    const void* active, long long n_state,
                                    int K, const void* u, const void* v,
                                    const void* w, long long lo, long long hi,
                                    int delta, int light, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (K < 1 || n_state < 1 || lo < 0 || hi <= lo || delta < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int sms = 0;
  err = msbfs::sm_count(device, &sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  long long blocks = (hi - lo + msbfs::kThreads - 1) / msbfs::kThreads;
  const long long most = static_cast<long long>(sms) * 16;
  if (blocks > most) blocks = most;
  weighted_relax_kernel<<<static_cast<int>(blocks), msbfs::kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(tent), static_cast<int*>(out),
      static_cast<const unsigned char*>(active), n_state, K,
      static_cast<const int*>(u), static_cast<const int*>(v),
      static_cast<const int*>(w), lo, hi, delta, light);
  return static_cast<int>(cudaGetLastError());
}

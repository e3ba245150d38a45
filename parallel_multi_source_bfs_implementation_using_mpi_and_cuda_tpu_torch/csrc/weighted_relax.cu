// Kernel K12 — one relaxation pass of the weighted route (delta-stepping).
//
// Replaces the XLA scatter-min of the JAX package's weighted/deltastep.py:84
// _relax_scatter_min, ``tent.at[:, v].min(where(active[:, u] & sel,
// tent[:, u] + w, INF))``, whose torch form (scatter_reduce_ "amin" over a
// (slots, K) candidate array) needs 12 bytes of intermediates per query and
// slot.  The port carries the planes query-minor, (n_state, K): row x's K
// queries are contiguous.  For the slots (u, v, w) of one side of delta (the
// engine keeps the light slots, w <= delta, and the heavy ones apart) and
// every query k:
//
//   if active[u, k]:  out[v, k] = min(out[v, k], tent[u, k] + w)
//
// ``out`` enters as a copy of ``tent`` (the wrapper's device-to-device copy
// on the same stream) and the kernel reads candidates from ``tent`` only:
// the Jacobi pass of the JAX engine, so the improved sets, the light passes
// and the relaxation counters of the drive loop equal JAX's, whichever
// slots a flavor hands in.  No candidate is formed where active does not
// hold, so INF + w never exists.  Commits are int32 atomicMin, which is
// exact in any order.
//
// Bound: bytes.  A pass must read v and w of its side's selected slots, the
// entries of its run of pieces, the active runs of the rows those pieces
// own, tent where those rows are active, and write the cells of out that
// improve (chip_smoke.py counts them on a real pass).  A thread a slot
// walking the K queries on (K, n) planes would make each of a slot's K
// offers read a cell of a different row of out: K scattered 32-byte sectors
// a slot in a plane five times the L2.
//
// Design.  The slots of a side come in pieces (start, end, owner) of at most
// 64 slots of one row (ops/cuda_weighted.py make_side), in row order.  A
// group of G lanes takes a piece (persistent blocks over the launch's piece
// range), each lane ``vec`` consecutive queries (4 as one 16-byte access
// where K % 4 == 0, else 1), a query chunk of G * vec at a time:
//   - the group loads the owner row's active bytes (one K-byte run) and
//     ballots; a row that no query of the chunk has active costs nothing
//     more.  Lanes with an active query load their tent words;
//   - the group loads the piece's (v, w) a chunk of slots at a time, one or
//     more a lane, coalesced, and shuffles them across the group; for
//     kInFlight slots at once each lane with an active query reads its
//     out[v, q..q+vec) (through L2: out is committed to in this launch), so
//     a slot's K offers are one 4K-byte run, then commits atomicMin only
//     where the candidate beats the value read (out only falls, so a
//     skipped commit is never needed).
// G is the power of two that covers K / vec, at most 32
// (ops/cuda_weighted.py relax_plan): K = 64 is 16 lanes of 16 bytes, two
// pieces a warp; K = 8 two lanes, K = 1 a lane a piece.
#include "msbfs_common.cuh"

namespace {

// Slots whose out runs a lane has in flight.
constexpr int kInFlight = 4;

template <int V>
struct Lanes;

template <>
struct Lanes<1> {
  // One query: its active byte, then its tent word.
  __device__ static uint32_t active(const unsigned char* p) { return __ldg(p); }
  __device__ static void tent(int (&t)[1], const int* p) { t[0] = __ldg(p); }
  __device__ static void read(int (&c)[1], const int* p) { c[0] = __ldcg(p); }
};

template <>
struct Lanes<4> {
  // Four queries: their active bytes as one word, their tent words as one
  // 16-byte load (rows aligned: K % 4 == 0 and aligned bases).
  __device__ static uint32_t active(const unsigned char* p) {
    return __ldg(reinterpret_cast<const unsigned int*>(p));
  }
  __device__ static void tent(int (&t)[4], const int* p) {
    const int4 x = __ldg(reinterpret_cast<const int4*>(p));
    t[0] = x.x; t[1] = x.y; t[2] = x.z; t[3] = x.w;
  }
  __device__ static void read(int (&c)[4], const int* p) {
    const int4 x = __ldcg(reinterpret_cast<const int4*>(p));
    c[0] = x.x; c[1] = x.y; c[2] = x.z; c[3] = x.w;
  }
};

template <int V, int G>
__global__ void __launch_bounds__(msbfs::kThreads)
weighted_relax_kernel(const int* __restrict__ tent, int* __restrict__ out,
                      const unsigned char* __restrict__ active, int K,
                      const int* __restrict__ pieces,
                      const int* __restrict__ v, const int* __restrict__ w,
                      long long p0, long long p1) {
  // Slots a lane loads a chunk (G < kInFlight: several), and the chunk.
  constexpr int R = G >= kInFlight ? 1 : kInFlight / G;
  constexpr int C = G * R;
  const int lane = threadIdx.x % G;
  const unsigned mask =
      G == 32 ? 0xffffffffu
              : ((1u << G) - 1u) << ((threadIdx.x & 31) & ~(G - 1));
  const long long groups = static_cast<long long>(gridDim.x) * (blockDim.x / G);
  for (long long p = p0 + (static_cast<long long>(blockIdx.x) * blockDim.x +
                           threadIdx.x) / G;
       p < p1; p += groups) {
    const int start = __ldg(pieces + 3 * p);
    const int end = __ldg(pieces + 3 * p + 1);
    const long long row = static_cast<long long>(__ldg(pieces + 3 * p + 2)) * K;
    for (int q0 = 0; q0 < K; q0 += G * V) {
      const int q = q0 + lane * V;
      uint32_t act = 0;
      int t[V];
      if (q < K) {
        act = Lanes<V>::active(active + row + q);
        if (act) Lanes<V>::tent(t, tent + row + q);
      }
      if (!(__ballot_sync(mask, act != 0) & mask)) continue;  // an idle row
      for (int s0 = start; s0 < end; s0 += C) {
        int vs[R], ws[R];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int s = s0 + r * G + lane;
          vs[r] = s < end ? __ldg(v + s) : 0;
          ws[r] = s < end ? __ldg(w + s) : 0;
        }
        const int m = min(C, end - s0);
#pragma unroll
        for (int b = 0; b < C; b += kInFlight) {
          if (b >= m) break;  // group-uniform
          int vj[kInFlight], wj[kInFlight];
#pragma unroll
          for (int j = 0; j < kInFlight; ++j) {
            vj[j] = __shfl_sync(mask, vs[(b + j) / G], (b + j) % G, G);
            wj[j] = __shfl_sync(mask, ws[(b + j) / G], (b + j) % G, G);
          }
          if (!act) continue;
          int cur[kInFlight][V];
#pragma unroll
          for (int j = 0; j < kInFlight; ++j) {
            if (b + j < m) {
              Lanes<V>::read(cur[j], out + static_cast<long long>(vj[j]) * K + q);
            }
          }
#pragma unroll
          for (int j = 0; j < kInFlight; ++j) {
            if (b + j >= m) continue;
            int* dst = out + static_cast<long long>(vj[j]) * K + q;
#pragma unroll
            for (int i = 0; i < V; ++i) {
              if ((act >> (8 * i)) & 0xffu) {
                const int cand = t[i] + wj[j];
                if (cand < cur[j][i]) atomicMin(dst + i, cand);
              }
            }
          }
        }
      }
    }
  }
}

// Persistent blocks: at most those resident at once (queried once a
// device and instance), so no block waits for a second wave.
template <int V, int G>
cudaError_t launch_group(int device, int sms, const int* tent, int* out,
                         const unsigned char* active, int K, const int* pieces,
                         const int* v, const int* w, long long p0,
                         long long p1, cudaStream_t stream) {
  static int resident[msbfs::kMaxDevices] = {};
  int per_sm = device >= 0 && device < msbfs::kMaxDevices ? resident[device] : 0;
  if (!per_sm) {
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, weighted_relax_kernel<V, G>, msbfs::kThreads, 0);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) per_sm = 1;
    if (device >= 0 && device < msbfs::kMaxDevices) resident[device] = per_sm;
  }
  constexpr int per_block = msbfs::kThreads / G;
  long long blocks = (p1 - p0 + per_block - 1) / per_block;
  const long long most = static_cast<long long>(sms) * per_sm;
  if (blocks > most) blocks = most;
  weighted_relax_kernel<V, G><<<static_cast<int>(blocks), msbfs::kThreads, 0,
                                stream>>>(tent, out, active, K, pieces, v, w,
                                          p0, p1);
  return cudaGetLastError();
}

template <int V>
cudaError_t launch_vec(int group, int device, int sms, const int* tent, int* out,
                       const unsigned char* active, int K, const int* pieces,
                       const int* v, const int* w, long long p0, long long p1,
                       cudaStream_t stream) {
  switch (group) {
    case 1: return launch_group<V, 1>(device, sms, tent, out, active, K, pieces, v, w, p0, p1, stream);
    case 2: return launch_group<V, 2>(device, sms, tent, out, active, K, pieces, v, w, p0, p1, stream);
    case 4: return launch_group<V, 4>(device, sms, tent, out, active, K, pieces, v, w, p0, p1, stream);
    case 8: return launch_group<V, 8>(device, sms, tent, out, active, K, pieces, v, w, p0, p1, stream);
    case 16: return launch_group<V, 16>(device, sms, tent, out, active, K, pieces, v, w, p0, p1, stream);
    case 32: return launch_group<V, 32>(device, sms, tent, out, active, K, pieces, v, w, p0, p1, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// tent, out: (n_state, K) int32, out a copy of tent; active: (n_state, K)
// bool (one byte a cell); pieces: (R, 3) int32 (start, end, owner) over the
// side's v, w int32 slot arrays, of which pieces [p0, p1) are relaxed; vec:
// queries a lane reads at once (4 needs K % 4 == 0 and 16-byte aligned
// planes); group: lanes a piece (1, 2, 4, ..., 32).
extern "C" int msbfs_weighted_relax(int device, const void* tent, void* out,
                                    const void* active, int K,
                                    const void* pieces, const void* v,
                                    const void* w, long long p0, long long p1,
                                    int vec, int group, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (K < 1 || p0 < 0 || p1 <= p0 || (vec != 1 && vec != 4) ||
      (vec == 4 && K % 4 != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int sms = 0;
  err = msbfs::sm_count(device, &sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto* t = static_cast<const int*>(tent);
  auto* o = static_cast<int*>(out);
  const auto* a = static_cast<const unsigned char*>(active);
  const auto* pc = static_cast<const int*>(pieces);
  const auto* vv = static_cast<const int*>(v);
  const auto* ww = static_cast<const int*>(w);
  const auto s = static_cast<cudaStream_t>(stream);
  err = vec == 4 ? launch_vec<4>(group, device, sms, t, o, a, K, pc, vv, ww, p0, p1, s)
                 : launch_vec<1>(group, device, sms, t, o, a, K, pc, vv, ww, p0, p1, s);
  return static_cast<int>(err);
}

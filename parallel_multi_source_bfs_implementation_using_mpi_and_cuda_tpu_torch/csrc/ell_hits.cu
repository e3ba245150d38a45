// Kernel K8 — one level of the ELL route for all K queries, with its consumer.
//
// Replaces the TPU kernel ops/pallas_bfs.py:44 _ell_hits_kernel (its
// pallas_call at :72, entered through ell_hits :52) together with its
// consumer ops/pallas_bfs.py:86 ell_expand and the level update of the
// vmapped distance loop (ops/bfs.py:173 distance_chunk), all in the JAX
// package.  For distances dist (K, n) int32 and the ELL slab (cols (width,
// R), sorted vrow_vertex (R,), sentinel n in both):
//
//   frontier_q   = dist[q] == level[q]                 (queries that may run)
//   hits[r]      = OR over j of frontier[cols[j, r]]   (sentinel n reads 0)
//   reached[v]   = OR over the virtual rows r of v     (sentinel owner dropped)
//   new          = dist == -1 & reached;  dist = level + 1 where new
//   updated[q]   = any(new[q]);  level[q] += 1         (running queries only)
//
// A query "may run" while updated[q] and level[q] < stop[q]: stop is the
// chunk's per-query level bound (ops/bfs.py arm_chunk), so a converged
// query's row is a fixed point and the host can enqueue a whole chunk.
// ctrl[0] = some query may run; every launch returns at once when it is 0,
// and the last block of a level recomputes it (ctrl[2] is its ticket).
//
// The TPU kernel kept one query's whole int8 frontier in VMEM and streamed
// (width, 512) cols tiles past it; Mosaic could not lower its gather, so it
// only ever ran in interpret mode.  Here the K per-query states are bit
// planes, W = ceil(K / 32) words per vertex (query 32w+b in bit b of word
// w): 8 MB a plane at n = 2^20, K = 64, small enough to stay in the 50 MB
// L2 while the gather reads it at random.
//
// Bound: bytes.  From dist alone a level must read the distances of all K
// queries (4Kn bytes, 268 MB at n = 2^20, K = 64), write those that change,
// and read cols and vrow_vertex once (4(width + 1)R bytes, 163 MB at
// RMAT-20).  Design: the carry keeps three (n, W) planes beside dist for as
// long as this kernel owns it — frontier (labelled by the previous level),
// visited (dist != -1) and a hit plane that is zero between levels — and W
// words of running-query mask, so a steady level never reads dist and
// writes it once per new label:
//   pack    (only when the planes are stale: the first level of a chunk, or
//           after anyone else wrote the carry): one pass over dist builds
//           frontier, visited and the mask, and zeroes the hit plane; one
//           thread per (vertex, word), vertex fastest, so the 32 dist reads
//           of a word are each coalesced across the warp;
//   gather: one thread per virtual row.  It first reads its owner's visited
//           row (vrow_vertex is sorted: coalesced) and skips the row's cols
//           when every running query has already reached the owner — the
//           bottom-up early exit, which saves the slab bytes of late levels;
//           else it ORs the W frontier words of its 16 slots as one vector
//           load each (W = 2, 4, 8), keeps only bits that can be new, ORs
//           the consecutive rows of one owner across the warp (segmented
//           shuffle scan) and issues one atomicOr per owner, word and warp;
//   apply:  one thread per vertex over its W words: new = hits & ~visited
//           & running; visited |= new; frontier = new; the hit word is
//           zeroed for the next level; then dist[q, v] = level[q] + 1 for
//           each new bit, looping over the warp's OR of a word so that the
//           lanes that store for one query write neighbouring addresses.
//           A block ORs its new words into found; the block that takes the
//           last ticket folds found into updated/level, rewrites the mask
//           and ctrl[0]: two launches per steady level, three on a stale one.
// The hit plane differs from the plain version's where nothing could be
// new; the contract is the carry (dist, level, updated, found, ctrl).
#include "msbfs_common.cuh"

namespace {

constexpr int kWordsPerPass = 8;
constexpr unsigned kFullMask = 0xffffffffu;
// The launches of a level, as bits of the entry's ``phases``.
constexpr int kPhasePack = 1;
constexpr int kPhaseGather = 2;
constexpr int kPhaseApply = 4;

__device__ __forceinline__ bool may_run(const int* updated, const int* level,
                                        const int* stop, int q) {
  return __ldcg(updated + q) != 0 && __ldcg(level + q) < __ldcg(stop + q);
}

// P words at p through the read-only path: one vector load where the row
// is 8 or 16 bytes wide (rows of 16-byte aligned planes are then aligned).
template <int P>
__device__ __forceinline__ void ldg_words(uint32_t (&out)[P],
                                          const uint32_t* p) {
  if constexpr (P % 4 == 0) {
#pragma unroll
    for (int i = 0; i < P; i += 4) {
      const uint4 x = __ldg(reinterpret_cast<const uint4*>(p + i));
      out[i] = x.x; out[i + 1] = x.y; out[i + 2] = x.z; out[i + 3] = x.w;
    }
  } else if constexpr (P == 2) {
    const uint2 x = __ldg(reinterpret_cast<const uint2*>(p));
    out[0] = x.x; out[1] = x.y;
  } else {
#pragma unroll
    for (int i = 0; i < P; ++i) out[i] = __ldg(p + i);
  }
}

// aux: the running-query mask in words [0, W), found in words [W, 2W).
__global__ void __launch_bounds__(msbfs::kThreads)
ell_pack_kernel(const int* __restrict__ dist, const int* __restrict__ level,
                const int* __restrict__ updated, const int* __restrict__ stop,
                uint32_t* __restrict__ frontier, uint32_t* __restrict__ visited,
                uint32_t* __restrict__ hits, uint32_t* __restrict__ aux,
                long long n, int K, int W, const int* __restrict__ ctrl) {
  if (__ldcg(ctrl) == 0) return;
  extern __shared__ int s_level[];  // level of a running query, else -2
  for (int q = threadIdx.x; q < 32 * W; q += blockDim.x) {
    s_level[q] =
        q < K && may_run(updated, level, stop, q) ? __ldcg(level + q) : -2;
  }
  __syncthreads();
  if (blockIdx.x == 0) {
    for (int w = threadIdx.x; w < W; w += blockDim.x) {
      uint32_t word = 0u;
      for (int b = 0; b < 32; ++b) {
        word |= static_cast<uint32_t>(s_level[w * 32 + b] != -2) << b;
      }
      aux[w] = word;
      aux[W + w] = 0u;
    }
  }
  const long long total = n * W;
  for (long long t = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       t < total; t += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int w = static_cast<int>(t / n);
    const long long v = t - static_cast<long long>(w) * n;
    const int q0 = w * 32;
    const int nb = min(32, K - q0);
    uint32_t fr = 0u, vis = 0u;
    const int* const col = dist + static_cast<long long>(q0) * n + v;
    if (nb == 32) {
      // A whole word: the 32 loads are issued together, not one by one.
      int d[32];
#pragma unroll
      for (int b = 0; b < 32; ++b) d[b] = __ldg(col + b * n);
#pragma unroll
      for (int b = 0; b < 32; ++b) {
        fr |= static_cast<uint32_t>(d[b] == s_level[q0 + b]) << b;
        vis |= static_cast<uint32_t>(d[b] != -1) << b;
      }
    } else {
      for (int b = 0; b < nb; ++b) {
        const int d = __ldg(col + b * n);
        fr |= static_cast<uint32_t>(d == s_level[q0 + b]) << b;
        vis |= static_cast<uint32_t>(d != -1) << b;
      }
    }
    frontier[v * W + w] = fr;
    visited[v * W + w] = vis;
    hits[v * W + w] = 0u;
  }
}

// W = 1, 2, 4, 8: the whole row in registers, vector loads.  W = 0: any
// width w_rt, in passes of kWordsPerPass words.
template <int W>
__global__ void __launch_bounds__(msbfs::kThreads)
ell_gather_kernel(const int* __restrict__ cols,
                  const int* __restrict__ vrow_vertex,
                  const uint32_t* __restrict__ frontier,
                  const uint32_t* __restrict__ visited,
                  uint32_t* __restrict__ hits,
                  const uint32_t* __restrict__ aux, long long n, long long R,
                  int width, int w_rt, const int* __restrict__ ctrl) {
  if (__ldcg(ctrl) == 0) return;
  constexpr int P = W ? W : kWordsPerPass;
  const int Wd = W ? W : w_rt;
  const int lane = threadIdx.x & 31;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  // Whole warps walk together (the shuffles below need every lane).
  for (long long base = blockIdx.x * static_cast<long long>(blockDim.x) +
                        (threadIdx.x & ~31);
       base < R; base += stride) {
    const long long r = base + lane;
    const long long u = r < R ? __ldg(vrow_vertex + r) : n;
    // Rows of one owner are neighbours: is this lane's owner also the
    // previous lane's, anywhere in the warp?
    const long long u_prev = __shfl_up_sync(kFullMask, u, 1);
    const long long u_next = __shfl_down_sync(kFullMask, u, 1);
    const bool shared_owner =
        __ballot_sync(kFullMask, lane > 0 && u_prev == u && u < n) != 0u;
    const bool tail = lane == 31 || u_next != u;
    // Has the owner anything left to reach, in any word?  (The same answer
    // for every row of the owner.)
    bool live = false;
    if (u < n) {
      for (int w = 0; w < Wd; ++w) {
        live |= (~__ldg(visited + u * Wd + w) & __ldcg(aux + w)) != 0u;
      }
    }
    for (int w0 = 0; w0 < Wd; w0 += P) {
      const int nw = min(P, Wd - w0);
      uint32_t acc[P];
#pragma unroll
      for (int i = 0; i < P; ++i) acc[i] = 0u;
      if (live) {
        // kSlots slots at a time: their cols loads go out together, then
        // their frontier loads, instead of one dependent pair after another.
        constexpr int kSlots = P >= 8 ? 4 : 8;
        for (int j = 0; j < width; j += kSlots) {
          long long c[kSlots];
#pragma unroll
          for (int a = 0; a < kSlots; ++a) {
            c[a] = j + a < width ? __ldg(cols + (j + a) * R + r) : n;
          }
#pragma unroll
          for (int a = 0; a < kSlots; ++a) {
            if (c[a] >= n) continue;  // sentinel slot reads 0
            if constexpr (W != 0) {
              uint32_t x[P];
              ldg_words<P>(x, frontier + c[a] * W);
#pragma unroll
              for (int i = 0; i < P; ++i) acc[i] |= x[i];
            } else {
              const uint32_t* row = frontier + c[a] * Wd + w0;
#pragma unroll
              for (int i = 0; i < P; ++i) {
                if (i < nw) acc[i] |= __ldg(row + i);
              }
            }
          }
        }
        // Only bits that can be new: unreached by a running query.
#pragma unroll
        for (int i = 0; i < P; ++i) {
          if (i < nw) {
            acc[i] &= ~__ldg(visited + u * Wd + w0 + i) & __ldcg(aux + w0 + i);
          }
        }
      }
      if (shared_owner) {
        // Inclusive OR-scan within runs of equal owners (sorted, so equal
        // owners d lanes apart mean one run in between).
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
          const long long uo = __shfl_up_sync(kFullMask, u, d);
          const bool join = lane >= d && uo == u;
#pragma unroll
          for (int i = 0; i < P; ++i) {
            const uint32_t ao = __shfl_up_sync(kFullMask, acc[i], d);
            if (join) acc[i] |= ao;
          }
        }
      }
      if (live && tail) {
#pragma unroll
        for (int i = 0; i < P; ++i) {
          if (i < nw && acc[i]) atomicOr(hits + u * Wd + w0 + i, acc[i]);
        }
      }
    }
  }
}

template <int W>
__global__ void __launch_bounds__(msbfs::kThreads)
ell_apply_kernel(int* __restrict__ dist, int* __restrict__ level,
                 int* __restrict__ updated, const int* __restrict__ stop,
                 uint32_t* __restrict__ frontier,
                 uint32_t* __restrict__ visited, uint32_t* __restrict__ hits,
                 uint32_t* __restrict__ aux, long long n, int K, int w_rt,
                 int* __restrict__ ctrl) {
  if (__ldcg(ctrl) == 0) return;
  const int Wd = W ? W : w_rt;
  extern __shared__ int s_mem[];
  int* const s_next = s_mem;  // level + 1 of each query
  uint32_t* const s_mask = reinterpret_cast<uint32_t*>(s_mem + 32 * Wd);
  uint32_t* const s_found = s_mask + Wd;
  __shared__ int s_last;
  for (int q = threadIdx.x; q < 32 * Wd; q += blockDim.x) {
    s_next[q] = q < K ? __ldcg(level + q) + 1 : 0;
  }
  for (int w = threadIdx.x; w < Wd; w += blockDim.x) {
    s_mask[w] = __ldcg(aux + w);
    s_found[w] = 0u;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long base = blockIdx.x * static_cast<long long>(blockDim.x) +
                        (threadIdx.x & ~31);
       base < n; base += stride) {
    const long long v = base + lane;
    const bool valid = v < n;
    constexpr int P = W ? W : 1;
    for (int w0 = 0; w0 < Wd; w0 += P) {
      uint32_t h[P];
#pragma unroll
      for (int i = 0; i < P; ++i) h[i] = 0u;
      if (valid) {
        const uint32_t* src = hits + v * Wd + w0;
        if constexpr (P % 4 == 0) {
#pragma unroll
          for (int i = 0; i < P; i += 4) {
            const uint4 x = *reinterpret_cast<const uint4*>(src + i);
            h[i] = x.x; h[i + 1] = x.y; h[i + 2] = x.z; h[i + 3] = x.w;
          }
        } else if constexpr (P == 2) {
          const uint2 x = *reinterpret_cast<const uint2*>(src);
          h[0] = x.x; h[1] = x.y;
        } else {
          h[0] = src[0];
        }
      }
      uint32_t fresh[P];
#pragma unroll
      for (int i = 0; i < P; ++i) {
        fresh[i] = 0u;
        if (h[i]) {
          const long long at = v * Wd + w0 + i;
          hits[at] = 0u;  // the plane is zero again for the next level
          const uint32_t vis = visited[at];
          fresh[i] = h[i] & ~vis & s_mask[w0 + i];
          if (fresh[i]) visited[at] = vis | fresh[i];
        }
      }
      if (valid) {
        uint32_t* dst = frontier + v * Wd + w0;
        if constexpr (P % 4 == 0) {
#pragma unroll
          for (int i = 0; i < P; i += 4) {
            *reinterpret_cast<uint4*>(dst + i) =
                make_uint4(fresh[i], fresh[i + 1], fresh[i + 2], fresh[i + 3]);
          }
        } else if constexpr (P == 2) {
          *reinterpret_cast<uint2*>(dst) = make_uint2(fresh[0], fresh[1]);
        } else {
          dst[0] = fresh[0];
        }
      }
      // The new labels, a query at a time over the warp's 32 vertices: the
      // lanes that store for query q write neighbouring words of row q.
#pragma unroll
      for (int i = 0; i < P; ++i) {
        uint32_t bits = __reduce_or_sync(kFullMask, fresh[i]);
        if (bits == 0u) continue;
        if (lane == 0) atomicOr(s_found + w0 + i, bits);
        const int q0 = (w0 + i) * 32;
        while (bits) {
          const int b = __ffs(bits) - 1;
          bits &= bits - 1u;
          if ((fresh[i] >> b) & 1u) {
            dist[static_cast<long long>(q0 + b) * n + v] = s_next[q0 + b];
          }
        }
      }
    }
  }
  __syncthreads();
  for (int w = threadIdx.x; w < Wd; w += blockDim.x) {
    if (s_found[w]) atomicOr(aux + Wd + w, s_found[w]);
  }
  // Last-block tail: this block's found bits are visible before it takes a
  // ticket; the block that takes the last one sees them all.
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    s_last = atomicAdd(ctrl + 2, 1) == static_cast<int>(gridDim.x) - 1;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  // Advance: every running query moves to the next level and keeps running
  // if it found something and its bound allows; the mask follows.
  int go = 0;
  for (int base = 0; base < 32 * Wd; base += blockDim.x) {
    const int q = base + threadIdx.x;
    bool run_next = false;
    if (q < K) {
      int up = __ldcg(updated + q);
      int lv = __ldcg(level + q);
      const int st = __ldcg(stop + q);
      if (up != 0 && lv < st) {
        up = static_cast<int>((__ldcg(aux + Wd + (q >> 5)) >> (q & 31)) & 1u);
        lv += 1;
        updated[q] = up;
        level[q] = lv;
      }
      run_next = up != 0 && lv < st;
    }
    const uint32_t word = __ballot_sync(kFullMask, run_next);
    if (lane == 0 && q < 32 * Wd) aux[q >> 5] = word;
    go |= run_next;
  }
  go = __syncthreads_or(go);  // also: every found word has been read
  for (int w = threadIdx.x; w < Wd; w += blockDim.x) aux[Wd + w] = 0u;
  if (threadIdx.x == 0) {
    ctrl[0] = go;
    ctrl[2] = 0;
  }
}

template <int W>
cudaError_t launch_level(cudaStream_t s, int phases, const int* cols,
                         const int* vrow_vertex, int* dist, int* level,
                         int* updated, const int* stop, uint32_t* frontier,
                         uint32_t* visited, uint32_t* hits, uint32_t* aux,
                         long long n, long long R, int width, int K, int w_rt,
                         int* ctrl) {
  if (phases & kPhaseGather) {
    ell_gather_kernel<W><<<msbfs::grid_for(R, msbfs::kThreads),
                           msbfs::kThreads, 0, s>>>(
        cols, vrow_vertex, frontier, visited, hits, aux, n, R, width, w_rt,
        ctrl);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (phases & kPhaseApply) {
    const size_t shmem = static_cast<size_t>(34 * w_rt) * sizeof(int);
    ell_apply_kernel<W><<<msbfs::grid_for(n, msbfs::kThreads), msbfs::kThreads,
                          shmem, s>>>(dist, level, updated, stop, frontier,
                                      visited, hits, aux, n, K, w_rt, ctrl);
  }
  return cudaGetLastError();
}

}  // namespace

// One level on the carry's planes (frontier, visited, hits: (n, W) words;
// aux: 2 W words).  phases: the launches to make — pack (1: rebuild the
// planes from dist, for a stale carry), gather (2), apply (4); a level is
// 6 or 7, a single bit serves per-launch timing.
extern "C" int msbfs_ell_hits(int device, const void* cols,
                              const void* vrow_vertex, void* dist, void* level,
                              void* updated, const void* stop, void* frontier,
                              void* visited, void* hits, void* aux,
                              long long n, long long R, int width, int K,
                              int W, int phases, void* ctrl, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  // K is bounded by the kernels' shared per-query levels (34 W ints).
  if (K < 1 || W != (K + 31) / 32 || width < 1 || n < 0 || R < 0 ||
      K > 8192 || phases < 1 || phases > 7) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* const c = static_cast<int*>(ctrl);
  int* const d = static_cast<int*>(dist);
  int* const lv = static_cast<int*>(level);
  int* const up = static_cast<int*>(updated);
  const int* const st = static_cast<const int*>(stop);
  uint32_t* const fr = static_cast<uint32_t*>(frontier);
  uint32_t* const vis = static_cast<uint32_t*>(visited);
  uint32_t* const h = static_cast<uint32_t*>(hits);
  uint32_t* const ax = static_cast<uint32_t*>(aux);
  const int* const cl = static_cast<const int*>(cols);
  const int* const vv = static_cast<const int*>(vrow_vertex);

  if (phases & kPhasePack) {
    ell_pack_kernel<<<msbfs::grid_for(n * W, msbfs::kThreads), msbfs::kThreads,
                      32 * W * sizeof(int), s>>>(d, lv, up, st, fr, vis, h, ax,
                                                 n, K, W, c);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  switch (W) {
    case 1:
      err = launch_level<1>(s, phases, cl, vv, d, lv, up, st, fr, vis, h, ax, n, R,
                            width, K, W, c);
      break;
    case 2:
      err = launch_level<2>(s, phases, cl, vv, d, lv, up, st, fr, vis, h, ax, n, R,
                            width, K, W, c);
      break;
    case 4:
      err = launch_level<4>(s, phases, cl, vv, d, lv, up, st, fr, vis, h, ax, n, R,
                            width, K, W, c);
      break;
    case 8:
      err = launch_level<8>(s, phases, cl, vv, d, lv, up, st, fr, vis, h, ax, n, R,
                            width, K, W, c);
      break;
    default:
      err = launch_level<0>(s, phases, cl, vv, d, lv, up, st, fr, vis, h, ax, n, R,
                            width, K, W, c);
  }
  return static_cast<int>(err);
}

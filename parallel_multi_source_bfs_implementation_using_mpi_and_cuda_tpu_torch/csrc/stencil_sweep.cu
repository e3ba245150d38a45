// Kernel A — the stencil masked-shift sweep, with the residual edges.
//
// Replaces the TPU kernel ops/pallas_stencil.py:75 make_kernel (the gridless
// pallas_call chain entered through pallas_hits, :126) and its XLA twin
// ops/stencil.py:285 _xla_shift_hits, together with the XLA residual chain
// of ops/stencil.py:319-340 (the gather, segment_max, re-pack and row merge
// inside stencil_hits, :304), all in the JAX package.  For every vertex v
// and word w of a (rows, W) plane:
//
//   hits[v, w] = OR over offsets i of  frontier[v - d_i, w]
//                where 0 <= v - d_i < rows and bit i of mask[v - d_i] is set
//              | OR over residual edges e with dst[e] == v of frontier[src[e], w]
//
// i.e. the frontier of every source u whose edge (u, u + d_i) exists is
// shifted onto u + d_i, with zero fill past either end of the plane (a
// window of rows is zero-filled at its own ends, exactly as the JAX window
// slices it), and the few edges off the offsets (the residual, sorted by
// destination) are ORed in.  The residual needs the whole plane: the
// engines window only residual-free graphs.
//
// Bound: bytes.  Per level it must read the frontier plane (4W bytes per
// vertex) and write the hit plane (4W), and read the mask word of every row
// whose frontier is nonzero, and the residual's two index arrays (8 bytes an
// edge); at most 32 offsets cost a few integer operations each.  A thread
// per (vertex, word) that loads its sources from L1/L2 would move about 16
// four-byte loads through L1/L2 per output word, most of them from rows
// max|d| away that another block owns.
//
// Design, two variants picked on the host by ops/cuda_stencil.py
// sweep_plan (a pure function of rows, W, the offsets and whether every base
// pointer is 16-byte aligned):
//
// * ring — persistent blocks (one of 1024 threads per SM) each walk one
//   contiguous run of tiles of T rows.  A block keeps the mask word and the
//   W frontier words of rows [t0 - halo_lo, t0 + S*T + halo_hi) in a
//   shared-memory ring (S = kRingStages): the current tile's sources plus
//   the new rows of the next S - 1 tiles.  Two producer warps fetch them
//   with cp.async (16-byte copies where the plan allows) while the other
//   thirty warps sweep the current tile out of shared memory, so S - 1
//   tiles of loads are in flight behind the sweep and a copy that stalls
//   its issuing warp never holds the sweep up.  Every frontier and mask
//   word leaves L2 about once per block walk (plus the halo of each walk);
//   rows outside [0, rows) are zero-filled in the ring, so the sweep needs
//   no range check.  Every mask word is copied: fetching only those beside
//   a nonzero frontier row would need the frontier to land first, which
//   leaves the mask copies one tile of slack in this ring.
//   A thread owns a row: per offset one mask read and the row's W words as
//   one vector read (W = 2, 4, 8), and one vector store.  The offset loop
//   is unrolled in groups (eight offsets at W <= 2), so each shift and mask
//   bit is an operand from the constant bank and a group's frontier reads
//   are in flight together; the mask word is read only where the frontier
//   word read is nonzero; and a row's slot is lifted once so that one
//   unsigned min wraps every offset's source slot: about six instructions
//   a row and offset at W = 1.
// * l2 — where the ring does not fit in the shared memory chosen (wide
//   planes with long offsets): direct reads through L1/L2, with 32-bit
//   indices, whole rows per thread, vector frontier loads, and four rows
//   per thread in flight.
//
// The residual rides the same launch: on its own it would pay a launch
// and a launch gap a level for almost no bytes.  The host cuts the sorted
// edges by the tile that owns their destination (a (tiles + 1) range
// table per plan: ring tiles, or the l2 variant's 256-row block steps), so
// the rows an edge writes belong to the block that swept them.  Once the
// rows are stored (a block barrier later), the edges OR their source rows
// in with one atomicOr per nonzero word.  A ring block does it after its
// walk, with the whole block: its producer warps stage the walk's edge
// ends in shared memory with cp.async while the ring fills, so only the
// source row is waited on at the end, and the tile loop carries nothing
// for the residual (work or registers inside it slowed every tile of the
// walk by more than the separate launch cost).  l2 does it after each
// step.  Without residual edges none of this runs.
//
// W is a template parameter for 1, 2, 4 and 8, with a generic instance
// (W = 0, runtime width) for the others.  Offsets with |d| >= rows never
// land inside the plane and are dropped on the host side of this file, with
// each kept offset's mask bit carried beside it.  Indices are 32-bit: the
// wrapper refuses planes of rows * W >= 2^31 words.
#include "msbfs_common.cuh"

namespace {

constexpr int kRingThreads = 1024;
constexpr int kRingBlocksPerSm = 1;
constexpr int kRingStages = 4;  // tiles the ring holds beside the halos
constexpr int kProducerThreads = 64;  // two warps fill the ring
constexpr int kL2Rows = 4;  // rows per thread per step of the l2 variant
constexpr int kMaxSmem = 232448;  // bytes of shared memory a block may use
// Residual edges a ring block stages in shared memory (source and
// destination, 4 KB); a block's edges past these take the longer path.
constexpr int kResStage = 512;
constexpr int kRingMaxDynSmem = kMaxSmem - 2 * kResStage * 4 - 16;

constexpr int kMaxOffsets = 32;
constexpr int kGroup = 8;  // the host pads the offsets to a multiple of this

struct Offsets {
  int count;  // offsets with |d| < rows, in mask-bit order
  int d[kMaxOffsets];
  int d4[kMaxOffsets];            // 4 * d: the shift in ring bytes
  uint32_t bit[kMaxOffsets];      // the mask bit of each kept offset, as 1 << i
};

// The residual edges, sorted by destination and cut by table tile: the
// edges of tile t (rows [t * tile, (t + 1) * tile)) are [ptr[t], ptr[t + 1]).
// count == 0: no residual (the pointers are never read).
struct Residual {
  const int* src;
  const int* dst;
  const int* ptr;
  int count;
};

// The W words at p (p is W-word aligned within a 16-byte aligned plane
// when kVec16).
template <int W, bool kVec16>
__device__ __forceinline__ void load_row(uint32_t (&out)[W],
                                         const uint32_t* p) {
  if constexpr (kVec16 && W % 4 == 0) {
#pragma unroll
    for (int i = 0; i < W; i += 4) {
      const uint4 x = *reinterpret_cast<const uint4*>(p + i);
      out[i] = x.x; out[i + 1] = x.y; out[i + 2] = x.z; out[i + 3] = x.w;
    }
  } else if constexpr (kVec16 && W == 2) {
    const uint2 x = *reinterpret_cast<const uint2*>(p);
    out[0] = x.x; out[1] = x.y;
  } else {
#pragma unroll
    for (int i = 0; i < W; ++i) out[i] = p[i];
  }
}

template <int W, bool kVec16>
__device__ __forceinline__ void ldg_row(uint32_t (&out)[W],
                                        const uint32_t* p) {
  if constexpr (kVec16 && W % 4 == 0) {
#pragma unroll
    for (int i = 0; i < W; i += 4) {
      const uint4 x = __ldg(reinterpret_cast<const uint4*>(p + i));
      out[i] = x.x; out[i + 1] = x.y; out[i + 2] = x.z; out[i + 3] = x.w;
    }
  } else if constexpr (kVec16 && W == 2) {
    const uint2 x = __ldg(reinterpret_cast<const uint2*>(p));
    out[0] = x.x; out[1] = x.y;
  } else {
#pragma unroll
    for (int i = 0; i < W; ++i) out[i] = __ldg(p + i);
  }
}

template <int W, bool kVec16>
__device__ __forceinline__ void store_row(uint32_t* p,
                                          const uint32_t (&in)[W]) {
  if constexpr (kVec16 && W % 4 == 0) {
#pragma unroll
    for (int i = 0; i < W; i += 4) {
      *reinterpret_cast<uint4*>(p + i) =
          make_uint4(in[i], in[i + 1], in[i + 2], in[i + 3]);
    }
  } else if constexpr (kVec16 && W == 2) {
    *reinterpret_cast<uint2*>(p) = make_uint2(in[0], in[1]);
  } else {
#pragma unroll
    for (int i = 0; i < W; ++i) p[i] = in[i];
  }
}

// hits[d] |= frontier[s] (one residual edge; s < 0: none), one atomicOr per
// nonzero word.
template <int W, bool kVec16>
__device__ __forceinline__ void residual_edge(const uint32_t* __restrict__ frontier,
                                              uint32_t* __restrict__ hits,
                                              int Wd, int s, int d) {
  if (s < 0) return;
  if constexpr (W != 0) {
    uint32_t x[W];
    ldg_row<W, kVec16>(x, frontier + s * W);
#pragma unroll
    for (int i = 0; i < W; ++i) {
      if (x[i]) atomicOr(hits + d * W + i, x[i]);
    }
  } else {
    for (int w = 0; w < Wd; ++w) {
      const uint32_t x = __ldg(frontier + s * Wd + w);
      if (x) atomicOr(hits + d * Wd + w, x);
    }
  }
}

// hits[dst[e]] |= frontier[src[e]] for the residual edges [e0, e1), by
// threads tid of nthreads, a few edges a thread with their loads in flight
// together; one atomicOr per nonzero word (an edge's destination row was
// stored by this block before a barrier, and no other block writes it).
template <int W, bool kVec16>
__device__ __forceinline__ void residual_or(const uint32_t* __restrict__ frontier,
                                            uint32_t* __restrict__ hits,
                                            const Residual& res, int Wd,
                                            int e0, int e1, int tid,
                                            int nthreads) {
  constexpr int kBatch = W == 0 ? 1 : (W <= 2 ? 4 : 8 / W);
  for (int e = e0 + tid; e < e1; e += kBatch * nthreads) {
    int s[kBatch], d[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int i = e + b * nthreads;
      s[b] = i < e1 ? __ldg(res.src + i) : -1;
      d[b] = i < e1 ? __ldg(res.dst + i) : 0;
    }
    if constexpr (W != 0) {
      uint32_t x[kBatch][W];
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        if (s[b] >= 0) {
          ldg_row<W, kVec16>(x[b], frontier + s[b] * W);
        } else {
#pragma unroll
          for (int i = 0; i < W; ++i) x[b][i] = 0u;
        }
      }
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
#pragma unroll
        for (int i = 0; i < W; ++i) {
          if (x[b][i]) atomicOr(hits + d[b] * W + i, x[b][i]);
        }
      }
    } else {
      if (s[0] < 0) continue;
      for (int w = 0; w < Wd; ++w) {
        const uint32_t x = __ldg(frontier + s[0] * Wd + w);
        if (x) atomicOr(hits + d[0] * Wd + w, x);
      }
    }
  }
}

// Block-wide copy of n words from src to dst in shared memory.  With
// kVec16, and where dst and src agree modulo 16 bytes (the ring's layout
// makes them agree when every base pointer is 16-byte aligned), the body
// goes as 16-byte cp.async and only a head and tail of at most three words
// each as 4-byte ones.
template <bool kVec16>
__device__ __forceinline__ void copy_words(uint32_t* dst, const uint32_t* src,
                                           int n, int tid, int nthreads) {
  int head = n;
  if (kVec16 && ((reinterpret_cast<uintptr_t>(dst) ^
                  reinterpret_cast<uintptr_t>(src)) & 15) == 0) {
    head = min(n, static_cast<int>(
                      (-(reinterpret_cast<uintptr_t>(src) >> 2)) & 3));
    const int quads = (n - head) >> 2;
    for (int i = tid; i < quads; i += nthreads) {
      msbfs::cp_async16(dst + head + 4 * i, src + head + 4 * i);
    }
    for (int i = head + 4 * quads + tid; i < n; i += nthreads) {
      msbfs::cp_async4(dst + i, src + i);
    }
  }
  for (int i = tid; i < head; i += nthreads) {
    msbfs::cp_async4(dst + i, src + i);
  }
}

// Rows [a, b) into ring slots (row - org) mod R: copies for rows inside the
// plane, zeros outside it, by threads tid of nthreads.  b - a <= R.
template <bool kVec16>
__device__ void ring_fill(uint32_t* ring_f, uint32_t* ring_m,
                          const uint32_t* frontier, const uint32_t* mask,
                          long long a, long long b, long long org, int R,
                          int Wd, int rows, int tid, int nthreads) {
  while (a < b) {
    const int s = static_cast<int>((a - org) % R);
    const long long lim = a + (R - s);  // the ring wraps after this row
    long long e = b < lim ? b : lim;
    if (a < 0 && e > 0) e = 0;
    if (a < rows && e > rows) e = rows;
    const int n = static_cast<int>(e - a);
    if (a < 0 || a >= rows) {
      for (int i = tid; i < n * Wd; i += nthreads) ring_f[s * Wd + i] = 0;
      for (int i = tid; i < n; i += nthreads) ring_m[s + i] = 0;
    } else {
      const int r = static_cast<int>(a);
      copy_words<kVec16>(ring_f + s * Wd, frontier + r * Wd, n * Wd, tid,
                         nthreads);
      copy_words<kVec16>(ring_m + s, mask + r, n, tid, nthreads);
    }
    a = e;
  }
}

template <int W, bool kVec16>
__global__ void __launch_bounds__(kRingThreads, kRingBlocksPerSm)
sweep_ring_kernel(const uint32_t* __restrict__ frontier,
                  const uint32_t* __restrict__ mask,
                  uint32_t* __restrict__ hits, int rows, int w_rt,
                  Offsets off, int tile, int R, int halo_lo, int halo_hi,
                  Residual res, const int* __restrict__ ctrl, int max_levels) {
  if (!msbfs::level_go(ctrl, max_levels)) return;
  extern __shared__ __align__(16) uint32_t smem[];
  const int Wd = W ? W : w_rt;
  uint32_t* ring_f = smem;            // R * Wd frontier words
  uint32_t* ring_m = smem + R * Wd;   // R mask words (R % 4 == 0: aligned)
  const long long tiles = (static_cast<long long>(rows) + tile - 1) / tile;
  const long long tb = blockIdx.x * tiles / gridDim.x;
  const long long te = (blockIdx.x + 1) * tiles / gridDim.x;
  if (tb >= te) return;  // block-uniform, before any barrier
  const long long r0 = tb * tile;
  const long long r1 = te * tile < rows ? te * tile : rows;
  // Ring slot 0 holds row org; org, R and every tile start are multiples
  // of 4, so a row's slot and its index agree modulo 4 (16-byte copies).
  const long long org = r0 - halo_lo;
  long long loaded = org;  // rows [org, loaded) are in the ring or in flight
  // The rows tile t0 needs last: its own end plus the upper halo.
  auto span_end = [&](long long t0) {
    return (t0 + tile < r1 ? t0 + tile : r1) + halo_hi;
  };
  // The first kProducerThreads threads (two warps) fill the ring; the
  // others sweep.
  const bool producer = threadIdx.x < kProducerThreads;
  auto fill_to = [&](long long want) {  // producers only
    if (want > loaded) {
      ring_fill<kVec16>(ring_f, ring_m, frontier, mask, loaded, want, org, R,
                        Wd, rows, threadIdx.x, kProducerThreads);
      loaded = want;
    }
    msbfs::cp_async_commit();  // one group per tile, empty past the walk
  };
  // The residual edges of the walk's tiles: [s_span[0], s_span[1]), the
  // first kResStage of them staged in shared memory while the ring fills.
  __shared__ int s_res[2 * kResStage];
  __shared__ int s_span[2];
  // Prologue: tile 0's span, then the new rows of tiles 1 .. S - 2; then
  // the staged edge ends, a group of their own (one more group only makes
  // the waits below stronger).
  if (producer) {
#pragma unroll 1
    for (int i = 0; i < kRingStages - 1; ++i) {
      fill_to(span_end(r0 + static_cast<long long>(i) * tile));
    }
    if (res.count) {
      const int e0 = __ldg(res.ptr + tb), e1 = __ldg(res.ptr + te);
      if (threadIdx.x == 0) {
        s_span[0] = e0;
        s_span[1] = e1;
      }
      for (int i = threadIdx.x; i < min(e1 - e0, kResStage); i += kProducerThreads) {
        msbfs::cp_async4(s_res + i, res.src + e0 + i);
        msbfs::cp_async4(s_res + kResStage + i, res.dst + e0 + i);
      }
      msbfs::cp_async_commit();
    }
    msbfs::cp_async_wait<kRingStages - 2>();  // tile 0 has landed
  }
  __syncthreads();

  int tslot = halo_lo;  // ring slot of the tile's first row
  for (long long t0 = r0; t0 < r1; t0 += tile) {
    // Here tile t0 has landed and no thread reads rows below t0 - halo_lo
    // any more.  The producers fill the new rows of tile t0 + (S - 1) T,
    // over rows below t0 - halo_lo, and wait for tile t0 + T, while the
    // other warps sweep tile t0.
    if (producer) {
      fill_to(span_end(t0 + (kRingStages - 1) * static_cast<long long>(tile)));
      msbfs::cp_async_wait<kRingStages - 2>();
    } else {
      const int n = static_cast<int>((t0 + tile < r1 ? t0 + tile : r1) - t0);
      const int base = static_cast<int>(t0);
      constexpr int kSweepThreads = kRingThreads - kProducerThreads;
      const int first = static_cast<int>(threadIdx.x) - kProducerThreads;
      if constexpr (W != 0) {
        const char* ring_fb = reinterpret_cast<const char*>(ring_f);
        const char* ring_mb = reinterpret_cast<const char*>(ring_m);
        const unsigned rb = 4u * R;  // the ring in bytes of its mask array
        for (int j = first; j < n; j += kSweepThreads) {
          // The row's slot in bytes, lifted into [4 halo_lo, 4 (R + halo_lo))
          // so that every source slot 4 (slot - d) lies in [0, 2 rb): one
          // unsigned min wraps it.
          unsigned tj = 4u * static_cast<unsigned>(tslot + j);
          tj = min(tj, tj - rb);
          tj += tj < 4u * halo_lo ? rb : 0u;
          uint32_t acc[W] = {};
          // Offsets in groups of G (the host pads the offsets to a multiple
          // of kGroup with d = 0, bit = 0): a group's frontier reads are in
          // flight together, and its mask reads happen only where the
          // frontier words read are nonzero — on a thin frontier, almost
          // nowhere.
          constexpr int G = W <= 2 ? kGroup : 2 * kGroup / W;
#pragma unroll
          for (int g = 0; g < kMaxOffsets; g += G) {
            if (g >= off.count) break;
            unsigned sb[G];
            uint32_t x[G][W];
#pragma unroll
            for (int q = 0; q < G; ++q) {
              sb[q] = tj - off.d4[g + q];
              sb[q] = min(sb[q], sb[q] - rb);
              load_row<W, true>(x[q], reinterpret_cast<const uint32_t*>(ring_fb + sb[q] * W));
            }
#pragma unroll
            for (int q = 0; q < G; ++q) {
              uint32_t any = 0;
#pragma unroll
              for (int i = 0; i < W; ++i) any |= x[q][i];
              if (any && (*reinterpret_cast<const uint32_t*>(ring_mb + sb[q]) &
                          off.bit[g + q])) {
#pragma unroll
                for (int i = 0; i < W; ++i) acc[i] |= x[q][i];
              }
            }
          }
          store_row<W, kVec16>(hits + (base + j) * W, acc);
        }
      } else {
        for (int j = first; j < n; j += kSweepThreads) {
          for (int w = 0; w < Wd; ++w) {
            uint32_t acc = 0;
            for (int k = 0; k < off.count; ++k) {
              int s = tslot + j - off.d[k];
              s += s < 0 ? R : 0;
              s -= s >= R ? R : 0;
              if (ring_m[s] & off.bit[k]) acc |= ring_f[s * Wd + w];
            }
            hits[(base + j) * Wd + w] = acc;
          }
        }
      }
    }
    __syncthreads();  // tile t0 + T has landed; tile t0 is swept
    tslot += tile;
    tslot -= tslot >= R ? R : 0;
  }
  if (producer) msbfs::cp_async_wait<0>();  // no copy outlives the block
  if (res.count) {
    // Every row of the walk was stored before the last barrier; this one
    // makes the staged edge ends visible.  One dependent load (the source
    // row) per staged edge, then the rest of the walk's edges.
    __syncthreads();
    const int e0 = s_span[0], e1 = s_span[1];
    for (int i = threadIdx.x; i < min(e1 - e0, kResStage); i += kRingThreads) {
      residual_edge<W, kVec16>(frontier, hits, Wd, s_res[i], s_res[kResStage + i]);
    }
    if (e1 - e0 > kResStage) {
      residual_or<W, kVec16>(frontier, hits, res, Wd, e0 + kResStage, e1,
                             threadIdx.x, kRingThreads);
    }
  }
}

template <int W, bool kVec16>
__global__ void __launch_bounds__(msbfs::kThreads)
sweep_l2_kernel(const uint32_t* __restrict__ frontier,
                const uint32_t* __restrict__ mask,
                uint32_t* __restrict__ hits, int rows, int w_rt, Offsets off,
                Residual res, const int* __restrict__ ctrl, int max_levels) {
  if (!msbfs::level_go(ctrl, max_levels)) return;
  const int Wd = W ? W : w_rt;
  const unsigned stride = gridDim.x * blockDim.x;
  // Block-uniform steps (the residual's barrier needs every thread): a
  // step sweeps rows base + c * stride + threadIdx.x, c < kL2Rows, i.e.
  // the residual table's tiles base / blockDim.x + c * gridDim.x.
  for (unsigned base = blockIdx.x * blockDim.x;
       base < static_cast<unsigned>(rows); base += kL2Rows * stride) {
    const unsigned v0 = base + threadIdx.x;
    if constexpr (W != 0) {
      uint32_t acc[kL2Rows][W] = {};
      for (int k = 0; k < off.count; ++k) {
        const int d = off.d[k];
        const uint32_t bit = off.bit[k];
#pragma unroll
        for (int c = 0; c < kL2Rows; ++c) {
          const int u = static_cast<int>(v0 + c * stride) - d;
          if (v0 + c * stride < static_cast<unsigned>(rows) &&
              static_cast<unsigned>(u) < static_cast<unsigned>(rows) &&
              (__ldg(mask + u) & bit)) {
            uint32_t x[W];
            ldg_row<W, kVec16>(x, frontier + u * W);
#pragma unroll
            for (int i = 0; i < W; ++i) acc[c][i] |= x[i];
          }
        }
      }
#pragma unroll
      for (int c = 0; c < kL2Rows; ++c) {
        const unsigned v = v0 + c * stride;
        if (v < static_cast<unsigned>(rows)) {
          store_row<W, kVec16>(hits + static_cast<int>(v) * W, acc[c]);
        }
      }
    } else {
      for (int c = 0; c < kL2Rows; ++c) {
        const unsigned v = v0 + c * stride;
        if (v >= static_cast<unsigned>(rows)) break;
        for (int w = 0; w < Wd; ++w) {
          uint32_t acc = 0;
          for (int k = 0; k < off.count; ++k) {
            const int u = static_cast<int>(v) - off.d[k];
            if (static_cast<unsigned>(u) < static_cast<unsigned>(rows) &&
                (__ldg(mask + u) & off.bit[k])) {
              acc |= __ldg(frontier + u * Wd + w);
            }
          }
          hits[static_cast<int>(v) * Wd + w] = acc;
        }
      }
    }
    if (res.count) {
      __syncthreads();  // the step's rows are stored
      const int tiles = static_cast<int>((static_cast<unsigned>(rows) + blockDim.x - 1) / blockDim.x);
#pragma unroll 1
      for (int c = 0; c < kL2Rows; ++c) {
        const int t = static_cast<int>(base / blockDim.x) + c * static_cast<int>(gridDim.x);
        if (t >= tiles) break;
        residual_or<W, kVec16>(frontier, hits, res, Wd, __ldg(res.ptr + t),
                               __ldg(res.ptr + t + 1), threadIdx.x, blockDim.x);
      }
    }
  }
}

struct Launch {
  const uint32_t* frontier;
  const uint32_t* mask;
  uint32_t* hits;
  int rows, W;
  Offsets off;
  int tile, R, halo_lo, halo_hi;
  Residual res;
  const int* ctrl;
  int max_levels;
  int device;
  cudaStream_t stream;
};

template <int W, bool kVec16>
cudaError_t launch_ring(const Launch& a) {
  static int allowed[msbfs::kMaxDevices] = {};
  auto kernel = sweep_ring_kernel<W, kVec16>;
  const int smem = a.R * (a.W + 1) * static_cast<int>(sizeof(uint32_t));
  cudaError_t err = msbfs::allow_smem(kernel, smem, allowed, a.device);
  if (err != cudaSuccess) return err;
  int sms = 0;
  err = msbfs::sm_count(a.device, &sms);
  if (err != cudaSuccess) return err;
  const long long tiles = (static_cast<long long>(a.rows) + a.tile - 1) / a.tile;
  long long grid = static_cast<long long>(kRingBlocksPerSm) * sms;
  if (grid > tiles) grid = tiles;
  if (grid < 1) grid = 1;
  kernel<<<static_cast<int>(grid), kRingThreads, smem, a.stream>>>(
      a.frontier, a.mask, a.hits, a.rows, a.W, a.off, a.tile, a.R, a.halo_lo,
      a.halo_hi, a.res, a.ctrl, a.max_levels);
  return cudaGetLastError();
}

template <int W, bool kVec16>
cudaError_t launch_l2(const Launch& a) {
  const long long steps = (static_cast<long long>(a.rows) + kL2Rows - 1) / kL2Rows;
  const int grid = msbfs::grid_for(steps, msbfs::kThreads);
  sweep_l2_kernel<W, kVec16><<<grid, msbfs::kThreads, 0, a.stream>>>(
      a.frontier, a.mask, a.hits, a.rows, a.W, a.off, a.res, a.ctrl,
      a.max_levels);
  return cudaGetLastError();
}

template <bool kVec16>
cudaError_t dispatch(const Launch& a, bool ring) {
  switch (a.W) {
    case 1: return ring ? launch_ring<1, kVec16>(a) : launch_l2<1, kVec16>(a);
    case 2: return ring ? launch_ring<2, kVec16>(a) : launch_l2<2, kVec16>(a);
    case 4: return ring ? launch_ring<4, kVec16>(a) : launch_l2<4, kVec16>(a);
    case 8: return ring ? launch_ring<8, kVec16>(a) : launch_l2<8, kVec16>(a);
    default: return ring ? launch_ring<0, kVec16>(a) : launch_l2<0, kVec16>(a);
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// variant: 0 = ring (tile, ring_rows, halo_lo, halo_hi from the host's
// plan), 1 = l2 (those four ignored).  vec16: every base pointer is 16-byte
// aligned, so copies, loads and stores may be 16 bytes wide.  The residual:
// res_count edges (res_src, res_dst sorted by destination, both (count,))
// and res_ptr, the (tiles + 1,) range table over tiles of res_tile rows —
// the ring's tile, or kThreads rows for l2; res_count == 0: none.
extern "C" int msbfs_stencil_sweep(int device, const void* frontier,
                                   const void* mask, void* hits,
                                   long long rows, int W,
                                   const int* offsets, int num_offsets,
                                   const void* ctrl, int max_levels,
                                   int variant, int tile, int ring_rows,
                                   int halo_lo, int halo_hi,
                                   const void* res_src, const void* res_dst,
                                   const void* res_ptr, long long res_count,
                                   int res_tile, int vec16, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  if (num_offsets < 0 || num_offsets > 32 || W < 1 || rows < 0 ||
      rows * W >= (1LL << 31) || (variant != 0 && variant != 1)) {
    return invalid;
  }
  if (vec16 && !(aligned16(frontier) && aligned16(mask) && aligned16(hits))) {
    return invalid;
  }
  if (res_count < 0 || res_count >= (1LL << 31) ||
      (res_count && (!res_src || !res_dst || !res_ptr ||
                     res_tile != (variant == 0 ? tile : msbfs::kThreads)))) {
    return invalid;
  }
  Launch a;
  a.off.count = 0;
  int lo = 0, hi = 0;  // rows below / above a tile that its sources reach
  for (int k = 0; k < num_offsets; ++k) {
    const long long d = offsets[k];
    if (d >= rows || -d >= rows) continue;  // never inside the plane
    a.off.d[a.off.count] = static_cast<int>(d);
    a.off.d4[a.off.count] = 4 * static_cast<int>(d);
    a.off.bit[a.off.count] = 1u << k;
    ++a.off.count;
    if (d > lo) lo = static_cast<int>(d);
    if (-d > hi) hi = static_cast<int>(-d);
  }
  for (int k = a.off.count; k < kMaxOffsets; ++k) {
    a.off.d[k] = a.off.d4[k] = 0;
    a.off.bit[k] = 0;
  }
  if (variant == 0) {
    const long long smem = static_cast<long long>(ring_rows) * (W + 1) * 4;
    if (tile < 32 || tile % 32 || halo_lo < lo || halo_hi < hi ||
        halo_lo % 4 || halo_hi % 4 ||
        ring_rows < static_cast<long long>(kRingStages) * tile + halo_lo + halo_hi || ring_rows % 4 ||
        smem > kRingMaxDynSmem) {
      return invalid;
    }
  }
  a.frontier = static_cast<const uint32_t*>(frontier);
  a.mask = static_cast<const uint32_t*>(mask);
  a.hits = static_cast<uint32_t*>(hits);
  a.rows = static_cast<int>(rows);
  a.W = W;
  a.tile = tile;
  a.R = ring_rows;
  a.halo_lo = halo_lo;
  a.halo_hi = halo_hi;
  a.res.src = static_cast<const int*>(res_src);
  a.res.dst = static_cast<const int*>(res_dst);
  a.res.ptr = static_cast<const int*>(res_ptr);
  a.res.count = static_cast<int>(res_count);
  a.ctrl = static_cast<const int*>(ctrl);
  a.max_levels = max_levels;
  a.device = device;
  a.stream = static_cast<cudaStream_t>(stream);
  err = vec16 ? dispatch<true>(a, variant == 0) : dispatch<false>(a, variant == 0);
  return static_cast<int>(err);
}

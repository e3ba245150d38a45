// Kernel K7 — the mxu tile matmul with its consumer, one level's hit planes.
//
// Replaces the TPU kernel ops/pallas_mxu.py:48 make_tile_kernel (the
// gridless pallas_call chain entered through pallas_tile_products, :95)
// together with its consumer ops/mxu.py:270 tile_matmul_hits, both in the
// JAX package: the per-tile products A[b] @ F[col(b)], the sorted
// segment-sum over tile_row, "count > 0", and the pack back to bit words.
// For nonzero adjacency tiles A[b] (T x T, int8 0/1; row i, column j set
// iff vertex row(b)*T + i has dedup neighbour col(b)*T + j) and a
// (ntr*T, W) frontier plane:
//
//   hits[r*T + i, w] bit q = OR over tiles b of row tile r, over j, of
//                            A[b][i][j] & bit q of frontier[col(b)*T + j, w]
//
// computed as an int8 product with int32 accumulation, exact since every
// count is at most T times the number of tiles in the row.
//
// Bound: bytes.  One level must read every nonzero tile once (nt * T^2
// bytes: 268 MB at RMAT-14, T = 128), the tile index and the frontier, and
// write the hit plane; its 2 * nt * T^2 * 32W int8 tensor operations take
// a fifth of that time at the card's int8 rate.  So the design is about
// keeping tile bytes in flight and moving each tile from L2 to an SM once.
//
// Two variants, picked on the host by ops/cuda_mxu.py tile_plan (a pure
// function of ntr, nt, T, W and the pointers' alignment):
//
// * pipe — one block per unit = (row tile, group of up to 4 words, part of
//   the row tile's tile list).  All words of a group share one copy of each
//   tile (N = 32 * words query columns per product), so at W <= 4 a tile
//   crosses from L2 to an SM once.  The block is warp-specialised: two
//   producer warps keep a ring of `stages` stages in flight, each stage one
//   tile and the T x W frontier words of its column block, fetched with
//   16-byte cp.async; a stage's arrival is an mbarrier the copies
//   themselves complete (cp.async.mbarrier.arrive.noinc), its release a
//   second mbarrier the eight consumer warps arrive on, so the producers
//   never wait on the products and no block-wide barrier sits in the loop.
//   A tile row takes 128 bytes of shared memory with its 16-byte chunks
//   XOR-swizzled by (row mod 8): unpadded, and every mma.sync fragment load
//   of a warp falls on 32 distinct banks; the unpacked operand uses the
//   same layout.  The consumers unpack a stage's words once for the whole
//   word group into a K-major (32 * words, T) int8 operand (double
//   buffered, one consumer-only named barrier per tile; a shift, a mask and
//   a 4 x 4 byte transpose turn four words into four operand words), then
//   warp m multiplies rows 16m..16m+15 with mma.sync m16n8k32 s8, its
//   fragments loaded four at a time with ldmatrix: the loop is bound by
//   instruction issue, not by the ring's depth.  The plan cuts a
//   row tile's list into `split` parts where whole row tiles are too few
//   units for the card (RMAT-14: 128 row tiles of 128 tiles for 132 SMs);
//   the parts' epilogues then atomicOr into hits — OR is order-free, the
//   result stays deterministic — after a zeroing launch gated on the device
//   exactly like the kernel, so a level the control turns away leaves hits
//   untouched.  Without a split the epilogue keeps plain stores.
// * simple — for shapes the ring cannot hold (a frontier row block too
//   wide for two stages) and for frontier planes that are not 16-byte
//   aligned: one block per (row tile, word), two cp.async stages, three
//   block-wide barriers per tile, padded rows, 4-byte frontier copies.
//
// Both write every row of every row tile (a row tile without nonzero tiles
// writes zeros) and are gated on the device control: level_go and ctrl[3]
// == kDirMatmul.
#include "msbfs_common.cuh"

namespace {

// D = A (16x32 s8, row-major) * B (32x8 s8, column-major) + D, s32.
__device__ __forceinline__ void mma_s8(int* d, uint32_t a0, uint32_t a1,
                                       uint32_t a2, uint32_t a3, uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__global__ void __launch_bounds__(msbfs::kThreads)
tile_hits_simple_kernel(const int8_t* __restrict__ tiles,
                        const int* __restrict__ row_ptr,
                        const int* __restrict__ tile_col,
                        const uint32_t* __restrict__ frontier,
                        uint32_t* __restrict__ hits, int T, int W,
                        const int* __restrict__ ctrl, int max_levels) {
  if (!msbfs::direction_go(ctrl, max_levels, msbfs::kDirMatmul)) return;
  extern __shared__ __align__(16) unsigned char smem[];
  // Rows padded by 16 bytes: the fragment loads of a warp then fall on 32
  // distinct banks.
  const int ld = T + 16;
  // Stage s: tile rows at s_a + s * T * ld, frontier words at
  // s_raw + s * T; then the unpacked block s_b[32][ld].
  int8_t* const s_a = reinterpret_cast<int8_t*>(smem);
  uint32_t* const s_raw = reinterpret_cast<uint32_t*>(s_a + 2 * T * ld);
  int8_t* const s_b = reinterpret_cast<int8_t*>(s_raw + 2 * T);

  const int r = blockIdx.x / W;
  const int w = blockIdx.x - r * W;
  const int b0 = __ldg(row_ptr + r);
  const int b1 = __ldg(row_ptr + r + 1);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;  // mma groupID
  const int t = lane & 3;   // mma thread in group
  const bool mine = warp < T / 16;  // this warp owns rows 16*warp..+15
  const int chunks = T / 16;        // 16-byte chunks per tile row

  auto stage = [&](int b, int s) {
    const int8_t* src = tiles + static_cast<long long>(b) * T * T;
    for (int c = tid; c < T * chunks; c += blockDim.x) {
      const int row = c / chunks;
      const int col = (c - row * chunks) * 16;
      msbfs::cp_async16(s_a + (s * T + row) * ld + col,
                        src + static_cast<long long>(row) * T + col);
    }
    const long long base = static_cast<long long>(__ldg(tile_col + b)) * T;
    for (int j = tid; j < T; j += blockDim.x) {
      msbfs::cp_async4(s_raw + s * T + j, frontier + (base + j) * W + w);
    }
  };

  int acc[4][4];
#pragma unroll
  for (int nb = 0; nb < 4; ++nb) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nb][e] = 0;
  }

  if (b0 < b1) stage(b0, 0);
  msbfs::cp_async_commit();
  for (int b = b0; b < b1; ++b) {
    const int s = (b - b0) & 1;
    if (b + 1 < b1) stage(b + 1, s ^ 1);
    msbfs::cp_async_commit();
    msbfs::cp_async_wait<1>();  // every group but the newest: tile b has landed
    __syncthreads();
    // Unpack the source block transposed: s_b[q][j] = bit q of word j, so
    // a B fragment's four consecutive k are one 32-bit load.
    const int quads = T / 4;
    for (int x = tid; x < 32 * quads; x += blockDim.x) {
      const int q = x / quads;
      const int j = (x - q * quads) * 4;
      const uint32_t* raw = s_raw + s * T + j;
      const uint32_t v = ((raw[0] >> q) & 1u) | (((raw[1] >> q) & 1u) << 8) |
                         (((raw[2] >> q) & 1u) << 16) |
                         (((raw[3] >> q) & 1u) << 24);
      *reinterpret_cast<uint32_t*>(s_b + q * ld + j) = v;
    }
    __syncthreads();
    if (mine) {
      const int8_t* a_row = s_a + (s * T + warp * 16 + g) * ld + 4 * t;
      for (int k = 0; k < T; k += 32) {
        const uint32_t a0 = ld32(a_row + k);
        const uint32_t a1 = ld32(a_row + 8 * ld + k);
        const uint32_t a2 = ld32(a_row + k + 16);
        const uint32_t a3 = ld32(a_row + 8 * ld + k + 16);
#pragma unroll
        for (int nb = 0; nb < 4; ++nb) {
          const int8_t* b_col = s_b + (nb * 8 + g) * ld + 4 * t + k;
          mma_s8(acc[nb], a0, a1, a2, a3, ld32(b_col), ld32(b_col + 16));
        }
      }
    }
    __syncthreads();  // stage s is refilled by the next iteration's copy
  }

  if (!mine) return;
  // acc[nb][e]: row g (e < 2) or g + 8 (e >= 2), query nb*8 + 2t + (e & 1).
  uint32_t lo = 0u, hi = 0u;
#pragma unroll
  for (int nb = 0; nb < 4; ++nb) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int bit = nb * 8 + 2 * t + e;
      lo |= static_cast<uint32_t>(acc[nb][e] > 0) << bit;
      hi |= static_cast<uint32_t>(acc[nb][e + 2] > 0) << bit;
    }
  }
  lo |= __shfl_xor_sync(0xffffffffu, lo, 1);
  lo |= __shfl_xor_sync(0xffffffffu, lo, 2);
  hi |= __shfl_xor_sync(0xffffffffu, hi, 1);
  hi |= __shfl_xor_sync(0xffffffffu, hi, 2);
  if (t == 0) {
    const long long row = static_cast<long long>(r) * T + warp * 16 + g;
    hits[row * W + w] = lo;
    hits[(row + 8) * W + w] = hi;
  }
}


// ---- the pipe variant ----------------------------------------------------

constexpr int kConsumerWarps = 8;
constexpr int kConsumerThreads = kConsumerWarps * 32;
constexpr int kProducerThreads = 64;  // two warps fill the ring
constexpr int kPipeThreads = kConsumerThreads + kProducerThreads;
constexpr int kRowBytes = 128;  // shared-memory row of a tile and of the operand
constexpr int kMaxStages = 8;
constexpr int kMaxSmem = 232448;  // bytes of shared memory a block may use

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count));
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n"
      ".reg .b64 state;\n"
      "mbarrier.arrive.shared::cta.b64 state, [%0];\n"
      "}\n" ::"r"(smem_u32(bar))
      : "memory");
}

// One arrival once every cp.async this thread issued so far has landed; the
// barrier's count already includes it (noinc).
__device__ __forceinline__ void mbar_arrive_on_copies(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// Four 8 x 16-byte matrices from shared memory: lane l gives the address of
// row l & 7 of matrix l >> 3, and receives of matrix i the four bytes
// 4 (l & 3) .. + 3 of row l >> 2 — the int8 mma fragment layout.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__global__ void __launch_bounds__(msbfs::kThreads)
tile_hits_zero_kernel(uint32_t* __restrict__ hits, long long words,
                      const int* __restrict__ ctrl, int max_levels) {
  if (!msbfs::direction_go(ctrl, max_levels, msbfs::kDirMatmul)) return;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < words; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    hits[i] = 0u;
  }
}

// Shared memory: `stages` x (tile: T rows of kRowBytes | the column block's
// T x W frontier words), then two (32 WG, kRowBytes) unpacked operands, then
// the full and empty barriers.  Chunk c of row i sits at chunk c ^ (i & 7).
template <int T, int WG>
__global__ void __launch_bounds__(kPipeThreads, WG <= 2 ? 2 : 1)
tile_hits_pipe_kernel(const int8_t* __restrict__ tiles,
                      const int* __restrict__ row_ptr,
                      const int* __restrict__ tile_col,
                      const uint32_t* __restrict__ frontier,
                      uint32_t* __restrict__ hits, int W, int groups,
                      int split, int stages, const int* __restrict__ ctrl,
                      int max_levels) {
  if (!msbfs::direction_go(ctrl, max_levels, msbfs::kDirMatmul)) return;
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int kTileBytes = T * kRowBytes;
  constexpr int kOperandBytes = 32 * WG * kRowBytes;
  constexpr int kChunks = T / 16;  // 16-byte chunks per tile row
  const int raw_bytes = T * W * 4;
  const int stage_bytes = kTileBytes + raw_bytes;
  unsigned char* const s_stage = smem;
  unsigned char* const s_b = smem + stages * stage_bytes;
  uint64_t* const full = reinterpret_cast<uint64_t*>(s_b + 2 * kOperandBytes);
  uint64_t* const empty = full + kMaxStages;

  // The unit: row tile r, words [w0, w0 + nw), tiles [b0, b1) of r's list.
  int unit = blockIdx.x;
  const int part = unit % split;
  unit /= split;
  const int grp = unit % groups;
  const int r = unit / groups;
  const int w0 = grp * W / groups;
  const int nw = (grp + 1) * W / groups - w0;
  const int rb0 = __ldg(row_ptr + r);
  const long long len = __ldg(row_ptr + r + 1) - rb0;
  const int b0 = rb0 + static_cast<int>(len * part / split);
  const int ntiles = rb0 + static_cast<int>(len * (part + 1) / split) - b0;
  // A part without tiles has nothing to OR in; without a split the unit
  // still owns its rows and writes zeros below.
  if (split > 1 && ntiles == 0) return;

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + s, kProducerThreads);
      mbar_init(empty + s, kConsumerWarps);
    }
  }
  __syncthreads();

  if (tid >= kConsumerThreads) {
    // Producers: stage i goes into slot i % stages once the consumers have
    // released the slot's previous tile (a fresh barrier passes parity 1).
    const int ptid = tid - kConsumerThreads;
    int s = 0;
    unsigned ph = 0;
    for (int i = 0; i < ntiles; ++i) {
      mbar_wait(empty + s, ph ^ 1u);
      unsigned char* const dst = s_stage + s * stage_bytes;
      const int8_t* const src =
          tiles + static_cast<long long>(b0 + i) * (T * T);
      // T * kChunks is a multiple of kProducerThreads for every T taken.
#pragma unroll
      for (int it = 0; it < T * kChunks / kProducerThreads; ++it) {
        const int c = ptid + it * kProducerThreads;
        const int row = c / kChunks;
        const int ch = c % kChunks;
        msbfs::cp_async16(dst + row * kRowBytes + ((ch ^ (row & 7)) << 4),
                          src + row * T + ch * 16);
      }
      const char* const fsrc = reinterpret_cast<const char*>(
          frontier + static_cast<long long>(__ldg(tile_col + b0 + i)) * T * W);
      for (int c = ptid * 16; c < raw_bytes; c += kProducerThreads * 16) {
        msbfs::cp_async16(dst + kTileBytes + c, fsrc + c);
      }
      mbar_arrive_on_copies(full + s);
      if (++s == stages) {
        s = 0;
        ph ^= 1u;
      }
    }
    msbfs::cp_async_wait<0>();  // no copy outlives the block
    return;
  }

  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;  // mma groupID
  const int t = lane & 3;   // mma thread in group
  const bool mine = warp < T / 16;  // this warp owns rows 16*warp..+15
  int acc[4 * WG][4];
#pragma unroll
  for (int nb = 0; nb < 4 * WG; ++nb) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nb][e] = 0;
  }

  int s = 0;
  unsigned ph = 0;
  for (int i = 0; i < ntiles; ++i) {
    mbar_wait(full + s, ph);
    const unsigned char* const st = s_stage + s * stage_bytes;
    const uint32_t* const raw =
        reinterpret_cast<const uint32_t*>(st + kTileBytes);
    unsigned char* const b = s_b + (i & 1) * kOperandBytes;
    // Unpack the column block's words for the whole word group: operand row
    // n = 32 * (word in group) + query bit, b[n][j] = bit of word j.  A warp
    // item is one word of the group x one 16-byte chunk: lane (g, t) reads
    // the word of rows j = 16 c + 4 t .. + 3, keeps bit 8 h + g of each in
    // byte h, and a 4 x 4 byte transpose gives the four bytes j .. j + 3 of
    // operand rows 8 h + g, h = 0 .. 3 (each store on 32 distinct banks).
    for (int it = warp; it < nw * kChunks; it += kConsumerWarps) {
      const int wl = it / kChunks;
      const int c = it % kChunks;
      const uint32_t* const p = raw + (c * 16 + t * 4) * W + w0 + wl;
      const uint32_t m0 = (p[0] >> g) & 0x01010101u;
      const uint32_t m1 = (p[W] >> g) & 0x01010101u;
      const uint32_t m2 = (p[2 * W] >> g) & 0x01010101u;
      const uint32_t m3 = (p[3 * W] >> g) & 0x01010101u;
      const uint32_t t0 = __byte_perm(m0, m1, 0x5140);
      const uint32_t t1 = __byte_perm(m2, m3, 0x5140);
      const uint32_t t2 = __byte_perm(m0, m1, 0x7362);
      const uint32_t t3 = __byte_perm(m2, m3, 0x7362);
      unsigned char* const out =
          b + (wl * 32 + g) * kRowBytes + ((c ^ g) << 4) + t * 4;
      *reinterpret_cast<uint32_t*>(out) = __byte_perm(t0, t1, 0x5410);
      *reinterpret_cast<uint32_t*>(out + 8 * kRowBytes) =
          __byte_perm(t0, t1, 0x7632);
      *reinterpret_cast<uint32_t*>(out + 16 * kRowBytes) =
          __byte_perm(t2, t3, 0x5410);
      *reinterpret_cast<uint32_t*>(out + 24 * kRowBytes) =
          __byte_perm(t2, t3, 0x7632);
    }
    // The operand is complete; the other buffer is free again, since every
    // consumer finished the previous tile's products before it came here.
    asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumerThreads) : "memory");
    if (mine) {
      // ldmatrix lanes: row lrow of matrix lmat.  A's four matrices are rows
      // +0 / +8 of chunk k / k + 1 (a0..a3); B's are chunks k / k + 1 of
      // n-blocks nb / nb + 1 (b0, b1 of each).  Every row's low three bits
      // are lrow, the swizzle key.
      const int lrow = lane & 7;
      const int lmat = lane >> 3;
      const unsigned char* const a_lane =
          st + (warp * 16 + lrow + (lmat & 1) * 8) * kRowBytes;
      const unsigned char* const b_lane =
          b + ((lmat >> 1) * 8 + lrow) * kRowBytes;
#pragma unroll
      for (int k = 0; k < T; k += 32) {
        uint32_t a[4];
        ldmatrix_x4(a, a_lane + ((((k >> 4) + (lmat >> 1)) ^ lrow) << 4));
        const int cb = (((k >> 4) + (lmat & 1)) ^ lrow) << 4;
#pragma unroll
        for (int nb = 0; nb < 4 * WG; nb += 2) {
          if (nb < 4 * nw) {
            uint32_t bb[4];
            ldmatrix_x4(bb, b_lane + nb * 8 * kRowBytes + cb);
            mma_s8(acc[nb], a[0], a[1], a[2], a[3], bb[0], bb[1]);
            mma_s8(acc[nb + 1], a[0], a[1], a[2], a[3], bb[2], bb[3]);
          }
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + s);  // tile and words are consumed
    if (++s == stages) {
      s = 0;
      ph ^= 1u;
    }
  }

  if (!mine) return;
  // acc[nb][e]: row g (e < 2) or g + 8 (e >= 2), query nb*8 + 2t + (e & 1)
  // of the group's word nb / 4.
  const long long row = static_cast<long long>(r) * T + warp * 16 + g;
#pragma unroll
  for (int wl = 0; wl < WG; ++wl) {
    if (wl >= nw) break;
    uint32_t lo = 0u, hi = 0u;
#pragma unroll
    for (int nb = 0; nb < 4; ++nb) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int bit = nb * 8 + 2 * t + e;
        lo |= static_cast<uint32_t>(acc[wl * 4 + nb][e] > 0) << bit;
        hi |= static_cast<uint32_t>(acc[wl * 4 + nb][e + 2] > 0) << bit;
      }
    }
    lo |= __shfl_xor_sync(0xffffffffu, lo, 1);
    lo |= __shfl_xor_sync(0xffffffffu, lo, 2);
    hi |= __shfl_xor_sync(0xffffffffu, hi, 1);
    hi |= __shfl_xor_sync(0xffffffffu, hi, 2);
    if (t == 0) {
      uint32_t* const out = hits + row * W + w0 + wl;
      if (split > 1) {
        if (lo) atomicOr(out, lo);
        if (hi) atomicOr(out + 8 * W, hi);
      } else {
        out[0] = lo;
        out[8 * W] = hi;
      }
    }
  }
}

template <int T, int WG>
cudaError_t launch_pipe(int device, unsigned blocks, int smem,
                        cudaStream_t stream, const int8_t* tiles,
                        const int* row_ptr, const int* tile_col,
                        const uint32_t* frontier, uint32_t* hits, int W,
                        int groups, int split, int stages, const int* ctrl,
                        int max_levels) {
  static int allowed[msbfs::kMaxDevices] = {};
  const cudaError_t err = msbfs::allow_smem(tile_hits_pipe_kernel<T, WG>,
                                            smem, allowed, device);
  if (err != cudaSuccess) return err;
  tile_hits_pipe_kernel<T, WG><<<blocks, kPipeThreads, smem, stream>>>(
      tiles, row_ptr, tile_col, frontier, hits, W, groups, split, stages,
      ctrl, max_levels);
  return cudaGetLastError();
}

template <int T, typename... Args>
cudaError_t launch_pipe_wg(int wg, Args... args) {
  switch (wg) {
    case 1: return launch_pipe<T, 1>(args...);
    case 2: return launch_pipe<T, 2>(args...);
    case 3: return launch_pipe<T, 3>(args...);
    case 4: return launch_pipe<T, 4>(args...);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// variant 0 = pipe (wg words per unit at most, `groups` word groups, each row
// tile's list cut into `split` parts, `stages` ring stages), 1 = simple.
extern "C" int msbfs_tile_hits(int device, const void* tiles,
                               const void* row_ptr, const void* tile_col,
                               const void* frontier, void* hits, int ntr,
                               int T, int W, const void* ctrl, int max_levels,
                               int variant, int wg, int groups, int split,
                               int stages, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (T < 32 || T > 128 || T % 32 || W < 1 || ntr < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* const a = static_cast<const int8_t*>(tiles);
  const int* const rp = static_cast<const int*>(row_ptr);
  const int* const tc = static_cast<const int*>(tile_col);
  const uint32_t* const fr = static_cast<const uint32_t*>(frontier);
  uint32_t* const h = static_cast<uint32_t*>(hits);
  const int* const c = static_cast<const int*>(ctrl);
  if (variant == 1) {
    const size_t shmem = static_cast<size_t>(2 * T * (T + 16) + 8 * T +
                                             32 * (T + 16));
    const long long blocks = static_cast<long long>(ntr) * W;
    if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    tile_hits_simple_kernel<<<static_cast<unsigned>(blocks), msbfs::kThreads,
                              shmem, s>>>(a, rp, tc, fr, h, T, W, c,
                                          max_levels);
    return static_cast<int>(cudaGetLastError());
  }
  if (variant != 0 || wg < 1 || wg > 4 || groups < 1 || split < 1 ||
      stages < 2 || stages > kMaxStages ||
      static_cast<long long>(groups) * wg < W) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long smem = static_cast<long long>(stages) *
                             (T * kRowBytes + static_cast<long long>(T) * W * 4) +
                         2 * 32 * wg * kRowBytes + 2 * kMaxStages * 8;
  const long long blocks = static_cast<long long>(ntr) * groups * split;
  if (smem > kMaxSmem || blocks > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (split > 1) {
    const long long words = static_cast<long long>(ntr) * T * W;
    tile_hits_zero_kernel<<<msbfs::grid_for(words, msbfs::kThreads),
                            msbfs::kThreads, 0, s>>>(h, words, c, max_levels);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const unsigned nb = static_cast<unsigned>(blocks);
  const int sm = static_cast<int>(smem);
  switch (T) {
    case 32:
      err = launch_pipe_wg<32>(wg, device, nb, sm, s, a, rp, tc, fr, h, W,
                               groups, split, stages, c, max_levels);
      break;
    case 64:
      err = launch_pipe_wg<64>(wg, device, nb, sm, s, a, rp, tc, fr, h, W,
                               groups, split, stages, c, max_levels);
      break;
    case 96:
      err = launch_pipe_wg<96>(wg, device, nb, sm, s, a, rp, tc, fr, h, W,
                               groups, split, stages, c, max_levels);
      break;
    default:
      err = launch_pipe_wg<128>(wg, device, nb, sm, s, a, rp, tc, fr, h, W,
                                groups, split, stages, c, max_levels);
  }
  return static_cast<int>(err);
}

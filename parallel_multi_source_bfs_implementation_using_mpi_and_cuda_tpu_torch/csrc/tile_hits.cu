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
// a fifth of that time at the card's int8 rate.  Design: one block of 8
// warps per (row tile, word) — the two words of a row tile are neighbouring
// blocks, so the second reads the tiles from L2 — looping over the row
// tile's nonzero tiles (a host-built row pointer over the sorted
// tile_row).  Each tile and its source block's T frontier words are
// staged into shared memory with cp.async, double-buffered so the next
// tile's copy overlaps this tile's products; the words are unpacked to a
// (32 queries x T) int8 block, and warp m multiplies rows 16m..16m+15 on
// the tensor cores with mma.sync m16n8k32 s8 (four 8-query column blocks).
// The epilogue ORs "count > 0" across each quad of lanes into one word per
// row and writes it: every row of the row tile is written (a row tile
// without nonzero tiles writes zeros), with no atomics, so the result is
// deterministic.  Gated on the device control: level_go and ctrl[3] ==
// kDirMatmul.  A fast wgmma/TMA pipeline is later work.
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
tile_hits_kernel(const int8_t* __restrict__ tiles,
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

}  // namespace

extern "C" int msbfs_tile_hits(int device, const void* tiles,
                               const void* row_ptr, const void* tile_col,
                               const void* frontier, void* hits, int ntr,
                               int T, int W, const void* ctrl, int max_levels,
                               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (T < 32 || T > 128 || T % 32 || W < 1 || ntr < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t shmem = static_cast<size_t>(2 * T * (T + 16) + 8 * T +
                                           32 * (T + 16));
  const long long blocks = static_cast<long long>(ntr) * W;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  tile_hits_kernel<<<static_cast<unsigned>(blocks), msbfs::kThreads, shmem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(tiles), static_cast<const int*>(row_ptr),
      static_cast<const int*>(tile_col),
      static_cast<const uint32_t*>(frontier), static_cast<uint32_t*>(hits), T,
      W, static_cast<const int*>(ctrl), max_levels);
  return static_cast<int>(cudaGetLastError());
}

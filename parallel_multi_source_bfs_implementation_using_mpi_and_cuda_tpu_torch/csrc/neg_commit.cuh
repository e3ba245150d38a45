// The async drive's commit of candidate neg-distance lanes, shared by M1
// chunk_merge's commit epilogue (mesh_wire.cu) and M4's commit form
// (forest_max.cu): the JAX package's ops/bitbell.py:193 ``neg_commit`` and,
// for a local wave, the next wave's send of ``neg_relax_chunk`` (:200,
// ``jnp.where(delta, merged, 0)``).  For each lane e of a committed row:
//   delta[e] = cand > neg[e];  neg[e] = max(neg[e], cand)
//   acc[e] = delta[e] (acc_set) or acc[e] |= delta[e]   (when acc is given)
//   send[e] = delta[e] ? cand : 0                         (when send is given)
// and *flag = tag once some lane of the launch improved (never cleared: a
// caller that gives every wave a new tag reads "this wave improved
// something" as flag == tag, with no zero fill between waves).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace msbfs {

struct NegCommit {
  int* neg;        // (rows, W) int32
  uint8_t* delta;  // (rows, W) bool
  uint8_t* acc;    // (rows, W) bool, or null
  int* send;       // (rows, W) int32, or null
  int* flag;       // (1,) int32, or null
  int acc_set;     // 1: acc = delta; 0: acc |= delta
  int tag;
};

// Lane e.
__device__ __forceinline__ bool commit_lane(const NegCommit& c, int cand, long long e) {
  const int old = c.neg[e];
  const bool d = cand > old;
  if (d) c.neg[e] = cand;
  c.delta[e] = d ? 1 : 0;
  if (c.acc != nullptr) {
    if (c.acc_set) {
      c.acc[e] = d ? 1 : 0;
    } else if (d) {
      c.acc[e] = 1;
    }
  }
  if (c.send != nullptr) c.send[e] = d ? cand : 0;
  return d;
}

// Lanes 4i .. 4i + 3 at once: neg and send 16-byte aligned, delta and acc
// 4-byte aligned (a byte a lane, little-endian in one 32-bit word).
__device__ __forceinline__ bool commit_quad(const NegCommit& c, int4 cand, long long i) {
  int4* neg = reinterpret_cast<int4*>(c.neg) + i;
  const int4 old = *neg;
  const bool dx = cand.x > old.x, dy = cand.y > old.y, dz = cand.z > old.z,
             dw = cand.w > old.w;
  const uint32_t bits = static_cast<uint32_t>(dx) | static_cast<uint32_t>(dy) << 8 |
                        static_cast<uint32_t>(dz) << 16 | static_cast<uint32_t>(dw) << 24;
  if (bits) {
    *neg = make_int4(max(old.x, cand.x), max(old.y, cand.y), max(old.z, cand.z),
                     max(old.w, cand.w));
  }
  reinterpret_cast<uint32_t*>(c.delta)[i] = bits;
  if (c.acc != nullptr) {
    uint32_t* acc = reinterpret_cast<uint32_t*>(c.acc) + i;
    if (c.acc_set) {
      *acc = bits;
    } else if (bits) {
      *acc |= bits;
    }
  }
  if (c.send != nullptr) {
    reinterpret_cast<int4*>(c.send)[i] =
        make_int4(dx ? cand.x : 0, dy ? cand.y : 0, dz ? cand.z : 0, dw ? cand.w : 0);
  }
  return bits != 0;
}

// The launch's flag, from each thread's ``any``: every lane of the warp
// calls it together.
__device__ __forceinline__ void commit_flag(const NegCommit& c, bool any) {
  if (c.flag != nullptr && __any_sync(0xffffffffu, any) && (threadIdx.x & 31) == 0) {
    atomicExch(c.flag, c.tag);
  }
}

// The pointers commit_quad needs aligned.
inline bool quad_aligned(const NegCommit& c) {
  const auto at = [](const void* p, uintptr_t n) {
    return p == nullptr || reinterpret_cast<uintptr_t>(p) % n == 0;
  };
  return at(c.neg, 16) && at(c.send, 16) && at(c.delta, 4) && at(c.acc, 4);
}

}  // namespace msbfs

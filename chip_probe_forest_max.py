#!/usr/bin/env python3
"""What M4 ``forest_max`` spends its time on, on one card.

    python3 chip_probe_forest_max.py [--out DIR] [--reps 20]

Builds the checkout's ``csrc/forest_max.cu`` and variants of it with one
part changed, each a text substitution checked to apply, built by nvcc
into a directory of its own under DIR.  Records the take-form calls
(``ops/cuda_mesh.py`` ``forest_max_take``) of one run of the 2D mesh's
async drive on road-1024 K = 16 (``chip_smoke.py``'s seed-0 graph and
groups, ``MSBFS_MESH=2x2 MSBFS_ASYNC_LEVELS=4`` over a logical mesh of
four entries on cuda:0), and times each variant on the widest tile's call
(with the take, in 16-byte vectors and in int32 lanes; and its level
alone, without the take) and on the thinnest tile's: CUDA events around
one call behind a queued device sleep, median of ``--reps``, each
variant's output compared bit for bit with the plain version's (``ok``).
Variants:

- ``blocks8``: the compiler held to 32 registers a thread (eight
  256-thread blocks an SM);
- ``unroll<u>``: u source rows of one output row in flight instead of 2;
- ``ldcg``: source rows read through L2 only, not the read-only cache;
- ``resident``: the grid at the blocks that stay resident at once (an
  occupancy query a launch), not at ``msbfs::kMaxBlocks`` (1056 blocks).

Needs one CUDA card and nvcc; imports nothing of JAX.  Prints one JSON
line per variant and, last, the card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

MESH_SHARDS = 4
INT32_MAX = 2**31 - 1


def _sub(text: str, old: str, new: str) -> str:
    assert old in text, old
    return text.replace(old, new)


def _const(text: str, name: str, value: int) -> str:
    out, n = re.subn(rf"(constexpr int {name} = )\d+;", rf"\g<1>{value};", text)
    assert n == 1, name
    return out


def _variants(src: str) -> dict:
    bounds = "__launch_bounds__(msbfs::kThreads) forest_max_kernel"
    out = {"checkout": src,
           "blocks8": _sub(src, bounds,
                           "__launch_bounds__(msbfs::kThreads, 8) forest_max_kernel")}
    for u in (1, 4, 8):
        out[f"unroll{u}"] = _const(src, "kUnroll", u)
    out["ldcg"] = _sub(src, "return __ldg(p);", "return __ldcg(p);")
    out["resident"] = _sub(src, "<<<msbfs::grid_for(a.rows, rows_a_block), msbfs::kThreads",
                           "<<<resident_grid(forest_max_kernel<kVec, kCand, kTake>, a.rows, "
                           "rows_a_block), msbfs::kThreads")
    out["resident"] = _sub(out["resident"], "template <bool kVec, bool kCand, bool kTake>\nvoid",
                           _RESIDENT + "template <bool kVec, bool kCand, bool kTake>\nvoid")
    return out


_RESIDENT = """template <typename Kernel>
int resident_grid(Kernel kernel, long long rows, int rows_a_block) {
  int device = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, msbfs::kThreads, 0);
  const long long blocks = (rows + rows_a_block - 1) / rows_a_block;
  const long long cap = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  return static_cast<int>(blocks < cap ? (blocks > 0 ? blocks : 1) : cap);
}

"""


def _build(kernels, out_dir: str, variants: dict) -> dict:
    procs = {}
    for name, text in variants.items():
        d = os.path.join(out_dir, name)
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "forest_max.cu"), "w") as fh:
            fh.write(text)
        cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-I", str(kernels.CSRC_DIR),
               "-o", os.path.join(d, "forest_max.so"), os.path.join(d, "forest_max.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    libs = {}
    symbol, argtypes = kernels.KERNELS["forest_max"][:2]
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"{name} failed to build:\n{log}")
        fn = getattr(ctypes.CDLL(os.path.join(out_dir, name, "forest_max.so")), symbol)
        fn.argtypes = [ctypes.c_int, *argtypes, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        libs[name] = fn
        regs = re.findall(r"Function properties for \S+?forest_max_kernelILb(\d)ELb(\d)ELb(\d)"
                          r".*?Used (\d+) registers", log, re.S)
        print(f"ptxas {name} (vec, cand, take, registers): " + json.dumps(regs))
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="build/chip_probe_forest_max")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_probe_forest_max: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.models import (
        generators,
    )
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.models.csr import (
        CSRGraph,
    )
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.ops import (
        cuda_mesh,
    )
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.parallel import (
        mesh, partition2d,
    )
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.runtime import (
        kernels,
    )
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.utils import (
        io as tio,
    )

    os.makedirs(args.out, exist_ok=True)
    libs = _build(kernels, args.out, _variants((kernels.CSRC_DIR / "forest_max.cu").read_text()))
    kernels.library()
    dev = torch.device("cuda", 0)
    n, e = generators.road_edges(1024, 1024, seed=1)
    g = CSRGraph.from_edges(n, e)
    q = tio.pad_queries(generators.random_queries(n, 16, seed=3))

    # -- the recorded calls: the first call on the widest and on the thinnest
    # tile (by slots)
    real = cuda_mesh.forest_max_take
    calls = {}

    def rec(prev, prev_rows, cols, tables, i, scratch, last_off, final_slot, hits, go,
            floor=None):
        slots = sum(r * c for r, c in tables.pieces[i])
        for which, better in (("widest", lambda a, b: a > b), ("thin", lambda a, b: a < b)):
            if which not in calls or better(slots, calls[which][0]):
                calls[which] = (slots, (prev.clone(), prev_rows, cols, tables, i, scratch,
                                        last_off, final_slot, hits.clone(), go.clone(), floor))
        return real(prev, prev_rows, cols, tables, i, scratch, last_off, final_slot, hits, go,
                    floor)

    cuda_mesh.forest_max_take = rec
    try:
        partition2d.Mesh2DEngine(mesh.make_mesh2d(2, 2, devices=[dev] * MESH_SHARDS), g,
                                 async_levels=4).f_values(q)
    finally:
        cuda_mesh.forest_max_take = real
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731

    def timed(fn):
        times = []
        for i in range(args.reps + 2):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            torch.cuda._sleep(1_000_000)
            ev[0].record()
            fn()
            ev[1].record()
            ev[1].synchronize()
            if i >= 2:
                times.append(ev[0].elapsed_time(ev[1]))
        return sorted(times)[len(times) // 2]

    def case(snap, take=True, vec=True):
        prev, prev_rows, cols, tables, i, scratch, last_off, final_slot, hits, go, floor = snap
        pieces = tables.pieces[i]
        rows = sum(r for r, _ in pieces)
        w = prev.shape[1]
        table, buckets, _ = tables.entry(i, 2)
        if take:
            want = hits.clone()
            cuda_mesh.forest_max_take_plain(prev, prev_rows, cols, pieces, scratch, last_off,
                                            final_slot, want, go, floor)
            out = hits.clone()
        else:
            want = torch.empty((rows, w), dtype=torch.int32, device=dev)
            cuda_mesh.forest_max_plain(prev, prev_rows, cols[: sum(r * c for r, c in pieces)],
                                       pieces, want, floor)
            out = torch.empty_like(want)
        vec = int(vec and w % 4 == 0)
        kept = scratch if take and last_off else None

        def run(fn):
            rc = fn(0, prev.data_ptr(), prev_rows, cols.data_ptr(), table, buckets,
                    out.shape[0], out.data_ptr(), w, int(floor is not None),
                    0 if floor is None else floor, vec,
                    final_slot.data_ptr() if take else None,
                    None if kept is None else kept.data_ptr(), last_off if take else 0,
                    last_off + rows if take else 0, go.data_ptr() if take else None,
                    INT32_MAX, stream())
            assert rc == 0, rc

        info = dict(slots=sum(r * c for r, c in pieces), live=int((cols < prev_rows).sum()),
                    level_rows=rows, out_rows=out.shape[0], w=w, take=take, vec=bool(vec))
        return want, out, run, info

    cases = {"take widest": case(calls["widest"][1]),
             "take widest int32": case(calls["widest"][1], vec=False),
             "level widest": case(calls["widest"][1], take=False),
             "take thin": case(calls["thin"][1])}
    for name, (_, _, _, info) in cases.items():
        print(f"case {name}: " + json.dumps(info))
    for variant, fn in libs.items():
        row = {}
        for name, (want, out, run, _) in cases.items():
            out.fill_(-7)
            run(fn)
            torch.cuda.synchronize()
            row[name] = dict(ms=timed(lambda: run(fn)), ok=torch.equal(out, want))
        print(f"variant {variant}: " + json.dumps(row))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())

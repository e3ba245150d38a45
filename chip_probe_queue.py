#!/usr/bin/env python3
"""What K10 and K11's queue mode spend their time on, on one card.

    python3 chip_probe_queue.py [--out DIR]

Builds the checkout's ``csrc/queue_push.cu`` and variants of it with one
part changed (each variant a text substitution checked to apply, built by
nvcc into its own library under DIR), then times each on road-4096 K = 16
(``chip_smoke.py``'s seed-0 graph and groups) on the push BFS's levels 0,
60, 132 (the widest), 250 and 400, at the engine's final capacity: CUDA
events around one call behind a queued device sleep, median of 7, the
carry restored between calls.  Variants:

- ``k10_no_hit_store`` / ``k10_no_flag_store``: K10 without its hit-byte
  or its tile-flag stores (so the loads' share shows);
- ``k11_no_apply_store``: the count pass without its visited and hit
  stores;
- ``k11_flags_contiguous``: a block's 64 flags side by side instead of a
  grid apart (the late levels' frontier lies in few queries);
- ``k11_group<g>_list<l>``: g tiles in flight a block, l flags a block.

Each variant's output is compared with the plain version (``ok``; the
partial variants are expected to differ).  Also the per-launch device
times of the checkout's kernels (torch.profiler) and a torch read of the
hit plane.  Needs one CUDA card and nvcc; imports nothing of JAX.  Prints
one JSON line per level and, last, the card.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import os
import re
import subprocess
import sys

LEVELS = (0, 60, 132, 250, 400)
CAPACITY = 571072  # the push engine's final capacity on road-4096 K = 16


def _variants(src: str) -> dict:
    k10_hit = "        h[v] = 1;\n"
    k10_flag = "        flag[v >> kTileShift] = 1;  // a warp's stores to one flag merge\n"
    a_visited = """          *reinterpret_cast<uint4*>(visited + at[k]) =
              make_uint4(v[k].x | nw.x, v[k].y | nw.y, v[k].z | nw.z, v[k].w | nw.w);"""
    a_hit = "          *reinterpret_cast<uint4*>(hit + at[k]) = nw;"
    stride = ("    const long long u = base + blockIdx.x + "
              "static_cast<long long>(threadIdx.x) * gridDim.x;")
    for part in (k10_hit, k10_flag, a_visited, a_hit, stride):
        assert part in src, part
    out = {
        "k10_no_hit_store": src.replace(k10_hit, ""),
        "k10_no_flag_store": src.replace(k10_flag, ""),
        "k11_no_apply_store": src.replace(a_visited, "          ;").replace(a_hit, "          ;"),
        "k11_flags_contiguous": src.replace(
            stride, "    const long long u = base + blockIdx.x * kListTiles + threadIdx.x;"),
    }
    for g, lt in ((2, 32), (4, 32), (8, 64), (4, 128)):
        s = re.sub(r"constexpr int kGroup = \d+;", f"constexpr int kGroup = {g};", src)
        out[f"k11_group{g}_list{lt}"] = re.sub(
            r"constexpr int kListTiles = \d+;", f"constexpr int kListTiles = {lt};", s)
    return out


def _build(kernels, out_dir: str, sources: dict) -> dict:
    procs = {}
    for name, text in sources.items():
        path = os.path.join(out_dir, f"{name}.cu")
        with open(path, "w") as fh:
            fh.write(text)
        cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-I", str(kernels.CSRC_DIR),
               "-o", path[:-3] + ".so", path]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"{name} failed to build:\n{log}")
        lib = ctypes.CDLL(os.path.join(out_dir, f"{name}.so"))
        fns = []
        for kernel in ("queue_expand", "queue_compact"):
            symbol, argtypes = kernels.KERNELS[kernel][:2]
            fn = getattr(lib, symbol)
            fn.argtypes = [ctypes.c_int, *argtypes, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            fns.append(fn)
        libs[name] = fns
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="build/chip_probe_queue")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_probe_queue: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile

    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.models import (
        generators,
    )
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.models.csr import (
        CSRGraph,
    )
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.ops import (
        bfs, cuda_push, push,
    )
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.runtime import (
        kernels,
    )
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.utils import (
        io as tio,
    )

    os.makedirs(args.out, exist_ok=True)
    src = (kernels.CSRC_DIR / "queue_push.cu").read_text()
    libs = _build(kernels, args.out, {"checkout": src, **_variants(src)})
    kernels.library()
    dev = torch.device("cuda", 0)
    n, e = generators.road_edges(4096, 4096, seed=0)
    q = tio.pad_queries(generators.random_queries(n, 16, seed=2))
    adj = push.PaddedAdjacency.from_host(CSRGraph.from_edges(n, e), dev)
    start, vals, _ = push.table_csr(adj)
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731

    def expand(fn, c):
        rc = fn(0, start.data_ptr(), vals.data_ptr(), c.n, c.queue.shape[0], c.hit.shape[1],
                c.hit.data_ptr(), c.touched.data_ptr(), c.touched.shape[1], c.queue.data_ptr(),
                c.capacity, c.count.data_ptr(), c.level.data_ptr(), c.updated.data_ptr(),
                c.stop.data_ptr(), c.ctrl.data_ptr(), stream())
        assert rc == 0, rc

    def compact(fn, c):
        k, pitch = c.hit.shape
        rc = fn(0, cuda_push.MODE_QUEUE, c.hit.data_ptr(), c.visited.data_ptr(), None, c.n, k,
                pitch, c.queue.data_ptr(), c.capacity, c.count.data_ptr(), c.f.data_ptr(),
                c.levels.data_ptr(), c.reached.data_ptr(), c.level.data_ptr(),
                c.updated.data_ptr(), c.stop.data_ptr(), c.max_count.data_ptr(), None,
                c.offsets.data_ptr(), c.offsets.shape[1], c.touched.shape[1],
                c.touched.data_ptr(), c.nonzero.data_ptr(), None, None, c.ctrl.data_ptr(),
                bfs.INT32_MAX, stream())
        assert rc == 0, rc

    def clone(c):
        return type(c)(**{f.name: (v.clone() if isinstance(v, torch.Tensor) else v)
                          for f in dataclasses.fields(c) for v in [getattr(c, f.name)]})

    def restore(dst, src_):
        for f in dataclasses.fields(src_):
            if isinstance(getattr(src_, f.name), torch.Tensor):
                getattr(dst, f.name).copy_(getattr(src_, f.name))

    def timed(fn, reset, reps=7):
        times = []
        for i in range(reps + 2):
            reset()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(2_000_000)
            e0.record()
            fn()
            e1.record()
            e1.synchronize()
            if i >= 2:
                times.append(e0.elapsed_time(e1))
        return sorted(times)[len(times) // 2]

    def split(fn, reset, reps=5):
        """Median device µs of each kernel of ``fn`` (torch.profiler)."""
        names = {}
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(100_000)
            torch.cuda.synchronize()
            for _ in range(reps):
                reset()
                torch.cuda._sleep(1_000_000)
                fn()
            torch.cuda.synchronize()
        for evt in prof.events():
            name = evt.name.replace("(anonymous namespace)::", "").replace("void ", "")
            name = name.split("(")[0].split("<")[0]
            if evt.device_type == torch.autograd.DeviceType.CUDA and name.startswith("queue"):
                names.setdefault(name, []).append(evt.time_range.elapsed_us())
        return {k: sorted(v)[len(v) // 2] for k, v in names.items()}

    fields = ("visited", "hit", "touched", "count", "f", "levels", "reached", "level",
              "updated", "max_count")
    carry = cuda_push.queue_carry_init(n, adj.rows, q, CAPACITY)
    bfs.arm_chunk(carry, None, None)
    for level in range(max(LEVELS) + 1):
        if level in LEVELS:
            snap = clone(carry)
            post = clone(snap)
            cuda_push.queue_expand(adj.rows, post, push.table_csr(adj))
            want = clone(post)
            cuda_push.queue_compact_plain(want)
            work = clone(snap)

            def clear():
                work.hit.zero_()
                work.touched.zero_()

            row = dict(level=level, touched_tiles=int(post.touched.sum()),
                       new=int(want.count.sum()), expand_ms={}, compact_ms={}, compact_ok={})
            for name, (ex, co) in libs.items():
                row["expand_ms"][name] = timed(lambda: expand(ex, work), clear)
                restore(work, post)
                compact(co, work)
                torch.cuda.synchronize()
                row["compact_ok"][name] = all(torch.equal(getattr(work, f), getattr(want, f))
                                              for f in fields)
                row["compact_ms"][name] = timed(lambda: compact(co, work),
                                                lambda: restore(work, post))
            row["expand_split_us"] = split(lambda: cuda_push.queue_expand(
                adj.rows, work, push.table_csr(adj)), clear)
            row["compact_split_us"] = split(lambda: cuda_push.queue_compact(work),
                                            lambda: restore(work, post))
            row["torch_hit_plane_int64_sum_ms"] = timed(
                lambda: work.hit.view(torch.int64).sum(), lambda: restore(work, post))
            print(json.dumps(row))
            del snap, post, want, work
            torch.cuda.empty_cache()
        push.push_level(adj, carry)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

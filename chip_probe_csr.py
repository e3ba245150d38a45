#!/usr/bin/env python3
"""What K9's walk and apply spend their time on, on one card.

    python3 chip_probe_csr.py [--out DIR]

Builds the checkout's ``csrc/csr_pull.cu`` and variants of it with one
part changed (each variant a text substitution checked to apply, built by
nvcc into its own library under DIR), then times each on RMAT-20 K = 64
(``chip_smoke.py``'s seed-0 graph and groups) on every level of one BFS,
in both layouts: CUDA events around the walk launch and around the apply
launch, both enqueued behind a queued device sleep, median of 5, the
carry restored between runs.  Variants:

- ``chunk<c>``: c pieces of long rows a warp takes at once (the
  checkout: 8);
- ``round<r>``: r frontier reads a lane between a piece's coverage
  checks (8: no check inside a piece);
- ``short<s>``: s slots a short row's thread has in flight;
- ``threads<t>``: t threads a walk block;
- ``no_label_store``: the apply without its ``dist`` stores, ``no_short``
  and ``no_long``: the walk without its short rows or its long pieces
  (so their shares show; expected to differ from the checkout).

Each variant's carry after the level (``dist`` and every plane) is
compared with the checkout's (``ok``).  Needs one CUDA card and nvcc;
imports nothing of JAX.  Prints one JSON line per layout and level and,
last, the card.
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


def _set(src: str, name: str, value: int) -> str:
    pattern = rf"constexpr int {name} = \d+;"
    assert re.search(pattern, src), name
    return re.sub(pattern, f"constexpr int {name} = {value};", src)


def _variants(src: str) -> dict:
    label = "              dist[static_cast<long long>(q) * sq + v] = next;\n"
    minor = "              dist[(base + j) * sv + q] = next;\n"
    short = "      if (r < num_short) walk_short<W>(a, r);\n"
    long_ = "      walk_long<W>(a, first, left < kLongChunk ? static_cast<int>(left) : kLongChunk, lane);\n"
    for part in (label, minor, short, long_):
        assert part in src, part
    out = {f"chunk{c}": _set(src, "kLongChunk", c) for c in (1, 4)}
    out.update({f"round{r}": _set(src, "kRoundSlots", r) for r in (2, 8)})
    out["short8"] = _set(src, "kShortSlots", 8)
    out["threads256"] = _set(src, "kWalkThreads", 256)
    out["no_short"] = src.replace(short, "")
    out["no_long"] = src.replace(long_, "")
    out["no_label_store"] = src.replace(label, "").replace(minor, "")
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
        symbol, argtypes = kernels.KERNELS["csr_pull"][:2]
        fn = getattr(ctypes.CDLL(os.path.join(out_dir, f"{name}.so")), symbol)
        fn.argtypes = [ctypes.c_int, *argtypes, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        libs[name] = fn
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="build/chip_probe_csr")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_probe_csr: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.models import (
        generators,
    )
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.models.csr import (
        CSRGraph,
    )
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.ops import (
        bfs, cuda_csr, packed,
    )
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.runtime import (
        kernels,
    )
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.utils import (
        io as tio,
    )

    os.makedirs(args.out, exist_ok=True)
    src = (kernels.CSRC_DIR / "csr_pull.cu").read_text()
    libs = _build(kernels, args.out, {"checkout": src, **_variants(src)})
    kernels.library()
    n, e = generators.rmat_edges(20, edge_factor=16, seed=0)
    dg = CSRGraph.from_edges(n, e).to_device(torch.device("cuda", 0))
    q = tio.pad_queries(generators.random_queries(n, 64, seed=12))
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731

    def launch(fn, carry, phase):
        planes = carry.planes
        w = planes.frontier.shape[1]
        shift = cuda_csr.map_shift(n, w)
        sq, sv = carry.dist.stride()
        rc = fn(0, phase, dg.vrows.data_ptr(), dg.vrows.shape[0], dg.num_short,
                dg.col_indices.data_ptr(), carry.dist.data_ptr(), n, carry.dist.shape[0],
                sq, sv, carry.level.data_ptr(), carry.updated.data_ptr(), carry.stop.data_ptr(),
                planes.frontier.data_ptr(), planes.visited.data_ptr(), planes.hits.data_ptr(),
                planes.aux.data_ptr(), planes.union.data_ptr(), w,
                -1 if shift is None else shift, carry.ctrl.data_ptr(), stream())
        assert rc == 0, rc

    def clone(c):
        out = {}
        for f in dataclasses.fields(c):
            v = getattr(c, f.name)
            if isinstance(v, torch.Tensor):
                v = v.T.clone().T if v.dim() == 2 and cuda_csr.query_minor(v) else v.clone()
            elif dataclasses.is_dataclass(v):
                v = clone(v)
            out[f.name] = v
        return type(c)(**out)

    def restore(dst, src_):
        for f in dataclasses.fields(src_):
            a, b = getattr(dst, f.name), getattr(src_, f.name)
            if isinstance(b, torch.Tensor):
                a.copy_(b)
            elif dataclasses.is_dataclass(b):
                restore(a, b)

    def level(fn, work, snap, reps=5):
        """Median ms of the walk and of the apply over ``reps`` runs of the
        level from ``snap`` (the pack first, untimed, when stale)."""
        walk, apply_ = [], []
        for _ in range(reps):
            restore(work, snap)
            if not snap.planes.valid:
                launch(fn, work, cuda_csr.PHASE_PACK)
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            torch.cuda._sleep(2_000_000)
            ev[0].record()
            launch(fn, work, cuda_csr.PHASE_WALK)
            ev[1].record()
            launch(fn, work, cuda_csr.PHASE_APPLY)
            ev[2].record()
            ev[2].synchronize()
            walk.append(ev[0].elapsed_time(ev[1]))
            apply_.append(ev[1].elapsed_time(ev[2]))
        return sorted(walk)[reps // 2], sorted(apply_)[reps // 2]

    fields = ("dist", "level", "updated", "ctrl")
    planes = ("frontier", "visited", "hits", "aux", "union")
    for layout in ("rows", "minor"):
        carry = (bfs.distance_carry_init(n, q, device=dg.device) if layout == "rows"
                 else packed.packed_carry_init(dg, q))
        bfs.arm_chunk(carry, None, None)
        cuda_csr.csr_planes(dg, carry)
        for fn in libs.values():  # each library's first launches load its kernels
            warm = clone(carry)
            for phase in cuda_csr.PHASE_NAMES:
                launch(fn, warm, phase)
        torch.cuda.synchronize()
        index = 0
        while int(carry.ctrl[0]):
            snap = clone(carry)
            want = clone(snap)
            cuda_csr.csr_pull(dg, want)
            work = clone(snap)
            row = dict(layout=layout, level=index, stale=not snap.planes.valid,
                       new=int((snap.dist == -1).sum() - (want.dist == -1).sum()),
                       walk_ms={}, apply_ms={}, ok={})
            for name, fn in libs.items():
                row["walk_ms"][name], row["apply_ms"][name] = level(fn, work, snap)
                torch.cuda.synchronize()
                row["ok"][name] = (
                    all(torch.equal(getattr(work, f), getattr(want, f)) for f in fields)
                    and all(torch.equal(getattr(work.planes, f), getattr(want.planes, f))
                            for f in planes))
            print(json.dumps(row))
            carry = want
            carry.planes.valid = True
            index += 1
            del snap, work
            torch.cuda.empty_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

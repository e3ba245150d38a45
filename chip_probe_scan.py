#!/usr/bin/env python3
"""What H3 ``owner_push_expand`` and M2 ``wire_encode`` spend their time
on, on one card.

    python3 chip_probe_scan.py [--out DIR] [--reps 20]

Builds the checkout's ``csrc/halo_exchange.cu`` and ``csrc/mesh_wire.cu``
and variants of them (or of ``csrc/ordered_scan.cuh``, which both
include) with one part changed, each a text substitution checked to
apply, built by nvcc into a directory of its own under DIR.  Records the
calls of both kernels in one run each of the engines that launch them on
road-1024 K = 16 (``chip_smoke.py``'s seed-0 graph and groups) over a
logical mesh of four entries on cuda:0: the owner-partitioned push at
``MSBFS_VSHARD=4`` (H3) and the 2D mesh with the ring tree (M2).  Each
variant is timed on H3's widest call, its first thin one (fewer than
4,096 listed rows), a call of the median listed count and a call gated
off, and on M2's widest call and its first thin one (fewer than 4,096
nonzero words): CUDA events around one call behind a queued device
sleep, median of ``--reps``, the outputs restored between calls, each
variant's outputs compared bit for bit with the plain version's
(``ok``).  Variants:

- ``acquire``: the status words read acquire and written release
  instead of relaxed;
- ``h3_bps<b>`` / ``m2_bps<b>``: b blocks an SM instead of 2;
- ``h3_items<i>``: i consecutive slots a thread; ``m2_words<w>``: w
  words a thread;
- ``look_back<p>``: p tiles a lane reads a round of the look-back;
- ``helpers_always`` / ``finalizer_always``: the sentinels written by
  helper blocks after a hand-off, or by the finalizer alone, whatever
  their number;
- a diagnostic, whose outputs differ: ``no_look_back`` (every tile
  starts at slot 0).

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

THIN = 4096
MESH_SHARDS = 4


def _sub(text: str, old: str, new: str) -> str:
    assert old in text, old
    return text.replace(old, new)


def _const(text: str, name: str, value: int) -> str:
    out, n = re.subn(rf"(constexpr (?:int|long long) {name} = )\d+;", rf"\g<1>{value};", text)
    assert n == 1, name
    return out


def _variants(halo: str, wire: str, scan: str) -> dict:
    """name -> (halo_exchange.cu, mesh_wire.cu, ordered_scan.cuh)."""
    acquire = _sub(_sub(scan, "ld.relaxed.gpu.global.u64", "ld.acquire.gpu.global.u64"),
                   "st.relaxed.gpu.global.u64", "st.release.gpu.global.u64")
    out = {"checkout": (halo, wire, scan), "acquire": (halo, wire, acquire)}
    for b in (1, 4):
        out[f"h3_bps{b}"] = (_const(halo, "kExpandBlocksPerSm", b), wire, scan)
        out[f"m2_bps{b}"] = (halo, _const(wire, "kEncodeBlocksPerSm", b), scan)
    for i in (1, 4):
        out[f"h3_items{i}"] = (_const(halo, "kExpandItems", i), wire, scan)
    for w in (4, 16):
        out[f"m2_words{w}"] = (halo, _const(wire, "kEncodeWords", w), scan)
    for per in (1, 8):
        out[f"look_back{per}"] = (halo, wire, _const(scan, "kLookBackPer", per))
    out["helpers_always"] = (halo, wire, _const(scan, "kFinalizerSentinels", 0))
    out["finalizer_always"] = (halo, wire, _const(scan, "kFinalizerSentinels", 1 << 40))
    # A diagnostic (its outputs differ): every tile starts at slot 0.
    out["no_look_back"] = (halo, wire, _sub(scan, "excl = look_back(status, t, epoch);",
                                            "excl = 0;"))
    return out


def _build(kernels, out_dir: str, variants: dict) -> dict:
    procs = {}
    for name, (halo, wire, scan) in variants.items():
        d = os.path.join(out_dir, name)
        os.makedirs(d, exist_ok=True)
        for file, text in (("halo_exchange.cu", halo), ("mesh_wire.cu", wire),
                           ("ordered_scan.cuh", scan)):
            with open(os.path.join(d, file), "w") as fh:
                fh.write(text)
        for src in ("halo_exchange", "mesh_wire"):
            cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-I", str(kernels.CSRC_DIR),
                   "-o", os.path.join(d, f"{src}.so"), os.path.join(d, f"{src}.cu")]
            procs[name, src] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.STDOUT, text=True)
    libs = {}
    for (name, src), proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"{name} {src} failed to build:\n{log}")
        kernel = "owner_push_expand" if src == "halo_exchange" else "wire_encode"
        symbol, argtypes = kernels.KERNELS[kernel][:2]
        fn = getattr(ctypes.CDLL(os.path.join(out_dir, name, f"{src}.so")), symbol)
        fn.argtypes = [ctypes.c_int, *argtypes, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        libs.setdefault(name, {})[kernel] = fn
        if name == "checkout":
            regs = re.findall(r"Function properties for (\S+)\n.*?Used (\d+) registers", log, re.S)
            print(f"ptxas {src}: " + json.dumps(regs))
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="build/chip_probe_scan")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_probe_scan: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.models import (
        generators,
    )
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.models.csr import (
        CSRGraph,
    )
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.ops import (
        cuda_halo, cuda_mesh,
    )
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.parallel import (
        mesh, partition2d, push_sharded,
    )
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.runtime import (
        kernels,
    )
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.utils import (
        io as tio,
    )

    os.makedirs(args.out, exist_ok=True)
    csrc = kernels.CSRC_DIR
    libs = _build(kernels, args.out, _variants((csrc / "halo_exchange.cu").read_text(),
                                               (csrc / "mesh_wire.cu").read_text(),
                                               (csrc / "ordered_scan.cuh").read_text()))
    kernels.library()
    dev = torch.device("cuda", 0)
    n, e = generators.road_edges(1024, 1024, seed=1)
    g = CSRGraph.from_edges(n, e)
    q = tio.pad_queries(generators.random_queries(n, 16, seed=3))
    devices = [dev] * MESH_SHARDS

    # -- the recorded calls: sizes first, then the picked calls' inputs in a
    # second run of fresh engines (the runs are deterministic)
    real3, real2 = push_sharded.owner_push_expand, partition2d.wire_encode

    def run_engines(keep3, keep2):
        h3, m2 = {}, {}

        def rec3(*a, **k):
            i = len(h3)
            h3[i] = ((a[1].shape[0], a[2].clone(), a[11][:1].clone()) if keep3 is None else
                     tuple(x.clone() if isinstance(x, torch.Tensor) else x for x in a[:12])
                     if i in keep3 else None)
            return real3(*a, **k)

        def rec2(plane, budget, lanes=1, scratch=None):
            i = len(m2)
            m2[i] = ((plane != 0).sum() if keep2 is None else
                     (plane.clone(), budget, lanes) if i in keep2 else None)
            return real2(plane, budget, lanes, scratch)

        push_sharded.owner_push_expand, partition2d.wire_encode = rec3, rec2
        try:
            push_sharded.ShardedPushEngine(mesh.make_mesh(1, MESH_SHARDS, devices=devices),
                                           g).f_values(q)
            partition2d.Mesh2DEngine(mesh.make_mesh2d(2, 2, devices=devices), g,
                                     merge_tree="ring").f_values(q)
        finally:
            push_sharded.owner_push_expand, partition2d.wire_encode = real3, real2
        return h3, m2

    sizes3, sizes2 = run_engines(None, None)
    # H3's calls at the final (largest) bounds only.
    cap = max(c[0] for c in sizes3.values())
    listed = {i: min(int(c[1][0]), cap) for i, c in sizes3.items() if c[0] == cap and int(c[2][0])}
    live = sorted(listed)
    order = sorted(live, key=lambda i: listed[i])
    picks3 = {"widest": order[-1], "thin": next(i for i in live if 0 < listed[i] < THIN),
              "median": order[len(order) // 2]}
    nz = {i: int(x) for i, x in sizes2.items()}
    picks2 = {"widest": max(nz, key=lambda i: nz[i]),
              "thin": next(i for i in sorted(nz) if 0 < nz[i] < THIN)}
    h3, m2 = run_engines(set(picks3.values()), set(picks2.values()))
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731

    def timed(fn, reset):
        times = []
        for i in range(args.reps + 2):
            reset()
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            torch.cuda._sleep(1_000_000)
            ev[0].record()
            fn()
            ev[1].record()
            ev[1].synchronize()
            if i >= 2:
                times.append(ev[0].elapsed_time(ev[1]))
        return sorted(times)[len(times) // 2]

    def h3_case(call, gated=False):
        table, queue, count, frontier, hits, lo, n_pad, ids, words, bcount, peak, ctrl = call[:12]
        ctrl = ctrl.clone()
        if gated:
            ctrl[0] = 0
        plain = [hits.clone(), ids.clone(), words.clone(), bcount.clone(), peak.clone()]
        cuda_halo.owner_push_expand_plain(table, queue, count, frontier, plain[0], lo, n_pad,
                                          *plain[1:], ctrl)
        work = [t.clone() for t in (hits, ids, words, bcount, peak)]
        scratch = cuda_halo.ScanScratch(cuda_halo.expand_tiles(queue.shape[0], table.shape[1]),
                                        dev)

        def reset():
            for w, s in zip(work, (hits, ids, words, bcount, peak)):
                w.copy_(s)

        def run(fn):
            rc = fn(0, table.data_ptr(), table.shape[1], queue.data_ptr(), queue.shape[0],
                    count.data_ptr(), frontier.data_ptr(), frontier.shape[1], work[0].data_ptr(),
                    frontier.shape[0], lo, n_pad, work[1].data_ptr(), work[2].data_ptr(),
                    work[1].shape[0], work[3].data_ptr(), work[4].data_ptr(), ctrl.data_ptr(),
                    2**31 - 1, scratch.words.data_ptr(), scratch.next_epoch(), stream())
            assert rc == 0, rc

        return plain, work, reset, run, dict(listed=min(int(count[0]), queue.shape[0]),
                                             slots=min(int(count[0]), queue.shape[0])
                                             * table.shape[1], gated=gated)

    def m2_case(call):
        plane, budget, lanes = call
        plain = list(cuda_mesh.wire_encode_plain(plane, budget, lanes))
        work = [torch.empty(1, dtype=torch.int64, device=dev),
                torch.empty(budget, dtype=torch.int32, device=dev),
                torch.empty(budget, dtype=torch.int32, device=dev)]
        scratch = cuda_halo.ScanScratch(plane.numel(), dev)

        def run(fn):
            rc = fn(0, plane.data_ptr(), plane.numel(), lanes, budget, work[1].data_ptr(),
                    work[2].data_ptr(), work[0].data_ptr(), scratch.words.data_ptr(),
                    scratch.next_epoch(), stream())
            assert rc == 0, rc

        return plain, work, lambda: None, run, dict(words=plane.numel(),
                                                    nonzero=int((plane != 0).sum()),
                                                    budget=budget, lanes=lanes)

    cases = {f"h3 {k}": h3_case(h3[i]) for k, i in picks3.items()}
    cases["h3 gated"] = h3_case(h3[picks3["median"]], gated=True)
    cases.update({f"m2 {k}": m2_case(m2[i]) for k, i in picks2.items()})
    for name, (_, _, _, _, info) in cases.items():
        print(f"case {name}: " + json.dumps(info))
    kernel_of = {"h3": "owner_push_expand", "m2": "wire_encode"}
    for variant, fns in libs.items():
        row = {}
        for name, (plain, work, reset, run, _) in cases.items():
            fn = fns[kernel_of[name[:2]]]
            reset()
            run(fn)
            torch.cuda.synchronize()
            ok = all(torch.equal(a.cpu(), b.cpu()) for a, b in zip(work, plain))
            row[name] = dict(ms=timed(lambda: run(fn), reset), ok=ok)
        print(f"variant {variant}: " + json.dumps(row))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Two checkouts of the PyTorch/CUDA port side by side on one card: the
batch start of every route, the low-K levels' expansion and the CLI paths.

    python3 chip_compare.py TREE [TREE ...] [--out DIR] [--reps 3] [--routes R,R]

Each TREE is the root of a checkout (the repo root, or a parent commit
unpacked with ``git archive`` under ``build/``); give them in turns
(parent, change, change, parent) so that drift on the card or its host
falls on both.  The graphs and query files are made once, from seed 0 as
``chip_smoke.py`` makes them, and each TREE is measured in a child
process of its own that imports the port from that TREE only (so each
builds its own kernels).  Per TREE and route (stencil road-4096 K = 16,
mxu RMAT-14 K = 64 and road-512 K = 16, bitbell, bell and streamed
RMAT-20 K = 64, low-K RMAT-20 K = 4 and K = 1, low-K RMAT-16 K = 1, push
and ppush road-4096 K = 16, vmap and packed RMAT-20 K = 64, weighted
RMAT-20 K = 64 and road-512 K = 8 (three flavors), vshard4, mesh2d
ring and mesh2d async road-1024 K = 16 at ``-gn 4``, vshard2 RMAT-20
K = 64 at ``-gn 4``; ``--routes`` keeps the named ones only):

- the batch start (``engine._init_carry``): its host ms (median of 20,
  up to a synchronise), its device operations (torch.profiler) and its
  blocking reads (``torch.cuda.set_sync_debug_mode("warn")``);
- on the low-K BFSs (RMAT-16 K = 1, RMAT-20 K = 4), every level's
  expansion (``engine._expand``): its launches (the wrappers' counts), its
  device operations and device ms (CUDA events, behind a queued device
  sleep), and the host µs of one level's step (``engine._stepper``) and
  of the expansion alone, their launches gated off;
- the computation span of each CLI path (median of ``--reps`` runs; each
  run's preprocessing span and layout phase beside it) and,
  on the low-K, bitbell and mxu road-512 paths, the device's busy share
  of one chunk (the kernels' summed device time over the chunk's
  CUDA-event span);
- on the push and ppush routes, the capacities of one auto-capacity call
  and one BFS at the last of them a level at a time: each level's two
  kernels' device ms (CUDA events around each launch, behind a queued
  device sleep: queue_expand and queue_compact, or push_or and
  queue_compact's row mode), summed, and
  both on the widest level and on the thin one (the first whose
  compaction lists fewer than 4,096);
- on the vmap and packed routes, one BFS of the distance loop a level at
  a time: each level's CSR pull (K9, its launches together) timed with
  CUDA events behind a queued device sleep, summed, level 0 and the level
  that labels most beside it;
- on the mesh routes over a logical mesh of four entries on cuda:0, as
  ``chip_smoke.py`` phases 15 and 16 build them (road-1024 K = 16 at
  ``-gn 4``: ``MSBFS_VSHARD=4``, the owner-partitioned push, and
  ``MSBFS_MESH=2x2`` with the ring merge tree and the sparse wire), one
  ``f_values`` run of a fresh engine (capacity reruns included, as the CLI
  runs it) with each H3 ``owner_push_expand`` or M2 ``wire_encode``
  launch timed alone (CUDA events behind a queued device sleep): their
  sum and spread, the widest launch and the thin one (the first with
  fewer than 4,096 listed rows or nonzero words) kept and timed again
  alone (median of 10), the kernels' own device time over a profiled run
  and the device's busy share of it (every kernel's time over the run's
  wall time), and the wall ms of an untimed run; the CLI span with
  ``mesh_devices``;
- on the 2D mesh's road-1024 routes (ring, and the async drive at
  ``MSBFS_ASYNC_LEVELS=4``, as phase 16 builds them), one ``f_values`` run
  with each launch of M4 ``forest_max``, K1s ``forest_gather``, H1
  ``halo_pair_or`` and M1 ``chunk_merge`` timed alone: their launches and
  sums, every kernel's launch and variant counts, the zero fills and the
  busy share of a profiled run; on the async route also M4's whole-forest
  call (the parent's M4 and forest_gather, or the take form) on its widest
  and thinnest tiles, re-timed alone;
  the async route's counts separate M4's commit form
  (``forest_max_commit``, a local wave's launch) from its take, and every
  route's profiled run counts the device kernels that are no hand-written
  kernel (the torch operations: elementwise, fills, copies, reductions),
  with their ms and their most frequent names;
- on the vertex-sharded forest of RMAT-20 K = 64 at ``MSBFS_VSHARD=2``
  with the JAX package's auto halo and push budgets (as ``chip_smoke.py``
  phase 15 builds it), one ``f_values`` run with each launch of H2
  (``halo_push_match``, where the tree has it, and ``halo_push_or``) timed
  alone: launches, sums, the median and the longest, and a profiled run's
  torch operations (the parent's route decision ran a chain of them a
  shard a sparse level), busy share and wall ms;
- on the weighted routes (``MSBFS_WEIGHTED=1``: RMAT-20 K = 64 and
  road-512 K = 8 groups of up to 8, costs ``edge_costs(m, "uniform", 16,
  3)`` as ``chip_smoke.py`` phase 11 makes them; road-512 also with the
  stencil and mesh2d flavors), one ``f_values`` run of the route's engine
  under torch.profiler: K12's device ms summed over the events named
  ``weighted_relax*``, its launches (the wrapper's count) and the run's
  wall ms, beside a run without the profiler; on RMAT-20 also the
  build-time split of the slots into light and heavy, native and with
  NumPy masks.

Needs one CUDA card, nvcc and scipy; imports nothing of JAX.  Prints one
JSON line per TREE run and, last, the card and a summary by TREE; per
level rows go to ``--out`` (default build/chip_compare).
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import io
import json
import os
import subprocess
import sys
import tempfile
import time

TOP = 2**31 - 1


def _card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def _make_data(tmp: str, needed) -> dict:
    """The graph and query files of the routes' data in ``needed``
    (``chip_smoke.py``'s seeds)."""
    import numpy as np

    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.models import (
        generators,
    )
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.models.csr import (
        CSRGraph,
    )
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.utils import (
        io as tio,
    )

    def graph(name, n, edges, costs=None):
        path = os.path.join(tmp, f"{name}.bin")
        tio.save_graph_bin(path, n, edges, costs)
        return path

    def costs(edges):
        return generators.edge_costs(len(edges), "uniform", max_cost=16, seed=3)

    def query(name, queries):
        path = os.path.join(tmp, f"{name}-q.bin")
        tio.save_query_bin(path, queries)
        return path

    files = {}
    if "road-4096" in needed:
        n, e = generators.road_edges(4096, 4096, seed=0)
        files["road-4096"] = (graph("road4096", n, e),
                              query("road4096", generators.random_queries(n, 16, seed=2)))
    if "rmat-14" in needed:
        n, e = generators.rmat_edges(14, edge_factor=16, seed=0)
        files["rmat-14"] = (graph("rmat14", n, e),
                            query("rmat14", generators.random_queries(n, 64, seed=8)))
    if "road-1024" in needed:
        n, e = generators.road_edges(1024, 1024, seed=1)
        files["road-1024"] = (graph("road1024", n, e),
                              query("road1024", generators.random_queries(n, 16, seed=3)))
    if "road-512" in needed:
        n, e = generators.road_edges(512, 512, seed=0)
        files["road-512"] = (graph("road512", n, e),
                             query("road512", generators.random_queries(n, 16, seed=9)))
    if "rmat-16 K=1" in needed:
        n, e = generators.rmat_edges(16, edge_factor=16, seed=0)
        g = CSRGraph.from_edges(n, e)
        source = int(np.random.default_rng(0).choice(np.nonzero(g.degrees > 0)[0]))
        files["rmat-16 K=1"] = (graph("rmat16", n, e),
                                query("rmat16", [np.array([source], dtype=np.int32)]))
    if needed & {"rmat-20 K=64", "rmat-20 K=4", "rmat-20 K=1"}:
        n, e = generators.rmat_edges(20, edge_factor=16, seed=0)
        q = generators.random_queries(n, 64, seed=12)
        g20 = graph("rmat20", n, e)
        files["rmat-20 K=64"] = (g20, query("rmat20", q))
        files["rmat-20 K=4"] = (g20, query("rmat20-k4", q[:4]))
        files["rmat-20 K=1"] = (g20, query("rmat20-k1", q[:1]))
    if "rmat-20 weighted" in needed:
        n, e = generators.rmat_edges(20, edge_factor=16, seed=0)
        files["rmat-20 weighted"] = (graph("rmat20w", n, e, costs(e)),
                                     query("rmat20w", generators.random_queries(n, 64, seed=12)))
    if "road-512 weighted" in needed:
        n, e = generators.road_edges(512, 512, seed=0)
        files["road-512 weighted"] = (
            graph("road512w", n, e, costs(e)),
            query("road512w", generators.random_queries(n, 8, max_group=8, seed=16)))
    return files


# -- the child: one TREE --------------------------------------------------------

# route -> (data, MSBFS_BACKEND and other knobs of its CLI path)
ROUTES = {
    "stencil road-4096": ("road-4096", {}),
    "mxu rmat-14": ("rmat-14", {"MSBFS_BACKEND": "mxu", "MSBFS_MXU_KERNEL": "1"}),
    "mxu road-512": ("road-512", {"MSBFS_BACKEND": "mxu", "MSBFS_MXU_KERNEL": "1"}),
    "lowk rmat-16 K=1": ("rmat-16 K=1", {}),
    "bitbell rmat-20": ("rmat-20 K=64", {}),
    "bell rmat-20": ("rmat-20 K=64", {"MSBFS_BACKEND": "bell"}),
    "streamed rmat-20": ("rmat-20 K=64", {"MSBFS_BACKEND": "streamed"}),
    "lowk rmat-20 K=4": ("rmat-20 K=4", {}),
    "lowk rmat-20 K=1": ("rmat-20 K=1", {}),
    "push road-4096": ("road-4096", {"MSBFS_BACKEND": "push"}),
    "ppush road-4096": ("road-4096", {"MSBFS_BACKEND": "ppush"}),
    "vmap rmat-20": ("rmat-20 K=64", {"MSBFS_BACKEND": "vmap"}),
    "packed rmat-20": ("rmat-20 K=64", {"MSBFS_BACKEND": "packed"}),
    "weighted rmat-20": ("rmat-20 weighted", {"MSBFS_WEIGHTED": "1"}),
    "weighted road-512": ("road-512 weighted", {"MSBFS_WEIGHTED": "1"}),
    "weighted-stencil road-512": ("road-512 weighted", {"MSBFS_WEIGHTED": "1",
                                                        "MSBFS_WEIGHTED_ENGINE": "stencil"}),
    "weighted-mesh2d road-512": ("road-512 weighted", {"MSBFS_WEIGHTED": "1",
                                                       "MSBFS_WEIGHTED_ENGINE": "mesh2d"}),
    "vshard4 road-1024": ("road-1024", {"MSBFS_VSHARD": "4"}),
    "mesh2d ring road-1024": ("road-1024", {"MSBFS_MESH": "2x2", "MSBFS_MERGE_TREE": "ring"}),
    "mesh2d async road-1024": ("road-1024", {"MSBFS_MESH": "2x2", "MSBFS_ASYNC_LEVELS": "4"}),
    # The halo and push budgets are set from the graph (_halo_knobs).
    "vshard2 rmat-20": ("rmat-20 K=64", {"MSBFS_VSHARD": "2"}),
}
LEVEL_ROUTES = ("lowk rmat-16 K=1", "lowk rmat-20 K=4")
BUSY_ROUTES = ("lowk rmat-16 K=1", "lowk rmat-20 K=4", "bitbell rmat-20", "mxu road-512")
# The routes measured a BFS level at a time (no batch start of their own).
PUSH_ROUTES = ("push road-4096", "ppush road-4096")
# The CSR pull's routes, measured a BFS level at a time (K9 in its rows and
# query-minor layouts).
CSR_ROUTES = ("vmap rmat-20", "packed rmat-20")
# The weighted routes: K12 over one f_values run.
WEIGHTED_ROUTES = ("weighted rmat-20", "weighted road-512", "weighted-stencil road-512",
                   "weighted-mesh2d road-512")
# The mesh routes: -gn 4 over a logical mesh of four entries on cuda:0.
MESH_SHARDS = 4
MESH_ROUTES = ("vshard4 road-1024", "mesh2d ring road-1024", "mesh2d async road-1024",
               "vshard2 rmat-20")
# The 2D mesh's kernels whose launches are each timed alone over one run
# (M4 and its commit form, K1s's final take, H1, M1), and the profiler's
# names of their kernels (and of the zero fills beside them); M4's two forms
# are one kernel template, so the profiler's forest_max sum holds both.
MESH2D_KERNELS = {"forest_max": ("forest_max_kernel",),
                  "forest_max_commit": (),
                  "forest_gather": ("forest_gather_kernel",),
                  "halo_pair_or": ("pair_or_kernel",),
                  "chunk_merge": ("chunk_merge_kernel", "chunk_commit_kernel")}
# Every hand-written kernel is defined in a top-level anonymous namespace
# of its csrc/*.cu, so the profiler names it "(anonymous namespace)::..."
# ("void (anonymous namespace)::..." for a template); torch's kernels sit
# in at::native (some in an anonymous namespace inside it).  A device
# kernel of another name is a torch operation (host copies excluded).
HANDWRITTEN = ("(anonymous namespace)::", "void (anonymous namespace)::")
FILL_NAMES = ("FillFunctor", "Memset")
# Device cycles slept before each launch of a run timed alone (about 0.5
# ms): the wrapper's host time falls in the sleep, not between the events.
LAUNCH_SLACK = 1_000_000
# Device cycles slept before a recorded call timed again alone (about 1 ms).
HOST_SLACK = 2_000_000
# The thin launch: the first with fewer listed rows (H3) or nonzero words (M2).
THIN = 4096


@contextlib.contextmanager
def _env(**values):
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2]


def _host_ms(torch, fn, reps=20):
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return _median(times)


def _device_ops(torch, fn, reps=5):
    """(operations a call, {name: [count a call, median ms]}) as
    torch.profiler traces ``reps`` calls; (None, {}) when the trace saw no
    device activity."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    for _ in range(3):  # a trace that sees no device activity is taken again
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(100_000)  # a trace can miss its first events
            torch.cuda.synchronize()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = sorted((e for e in prof.events()
                         if e.device_type == torch.autograd.DeviceType.CUDA),
                        key=lambda e: e.time_range.start)
        if events:
            break

    def op(evt):
        name = evt.name.replace("(anonymous namespace)::", "").replace("void ", "")
        return name.split("(")[0].split("<")[0].split("::")[-1].strip() or evt.name[:40]

    opened = [e.time_range.end for e in events if op(e) == "spin_kernel"]
    names = {}
    for evt in events:
        if op(evt) != "spin_kernel" and (not opened or evt.time_range.start >= opened[0]):
            names.setdefault(op(evt), []).append(evt.time_range.elapsed_us() / 1e3)
    if not names:
        return None, {}
    return (sum(len(v) for v in names.values()) / reps,
            {k: [len(v) / reps, _median(v)] for k, v in names.items()})


def _blocking_reads(torch, fn) -> int:
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return sum(1 for w in caught if "called a synchronizing" in str(w.message))


def _device_ms(torch, fn, reps=10):
    """Median device time of one call (CUDA events behind a queued sleep)."""
    times = []
    for i in range(reps + 2):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        if i >= 2:
            times.append(e0.elapsed_time(e1))
    return _median(times)


def _host_us(torch, fn, reps=300):
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    return us


def _engines(torch, dev, files, routes):
    """route -> (engine, padded queries) as the CLI pads them, for the
    batch-start routes among ``routes``."""
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.models.bell import (
        BellGraph,
    )
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.ops import (
        bell, bitbell, lowk, mxu, stencil, streamed,
    )
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.utils import (
        io as tio,
    )

    graphs, out = {}, {}

    def load(data):
        gpath, qpath = files[data]
        if gpath not in graphs:
            graphs[gpath] = tio.load_graph_bin(gpath)
        return graphs[gpath], tio.pad_queries(tio.load_query_bin(qpath))

    def bell_graph():
        if "bg" not in graphs:
            graphs["bg"] = BellGraph.from_host(load("rmat-20 K=64")[0], dev)
        return graphs["bg"]

    def stencil_road():
        g, q = load("road-4096")
        return stencil.StencilEngine(stencil.StencilGraph.from_host(g, dev),
                                     level_chunk=stencil.AUTO_STENCIL_LEVEL_CHUNK), q

    def mxu_route(data):
        g, q = load(data)
        return mxu.MxuEngine(mxu.MxuGraph.from_host(g, dev), level_chunk=128, kernel=True), q

    def lowk_route(data):
        g, q = load(data)
        return lowk.LowKEngine(BellGraph.from_host(g, dev), level_chunk=128), q

    def streamed_route():
        g, q = load("rmat-20 K=64")
        return streamed.StreamedBitBellEngine(
            BellGraph.from_host(g, False, keep_sparse=False), dev), q

    make = {
        "stencil road-4096": stencil_road,
        "mxu rmat-14": lambda: mxu_route("rmat-14"),
        "mxu road-512": lambda: mxu_route("road-512"),
        "lowk rmat-16 K=1": lambda: lowk_route("rmat-16 K=1"),
        "bitbell rmat-20": lambda: (bitbell.BitBellEngine(bell_graph(), level_chunk=128),
                                    load("rmat-20 K=64")[1]),
        "bell rmat-20": lambda: (bell.BellEngine(bell_graph(), level_chunk=128),
                                 load("rmat-20 K=64")[1]),
        "streamed rmat-20": streamed_route,
        "lowk rmat-20 K=4": lambda: (lowk.LowKEngine(bell_graph(), level_chunk=128),
                                     load("rmat-20 K=4")[1]),
        "lowk rmat-20 K=1": lambda: (lowk.LowKEngine(bell_graph(), level_chunk=128),
                                     load("rmat-20 K=1")[1]),
    }
    for route in routes:
        if route in make:
            out[route] = make[route]()
    return out


def _batch_start(torch, eng, queries):
    padded = eng._pad_queries(queries)[0]
    start = lambda: eng._init_carry(padded)  # noqa: E731
    start()
    torch.cuda.synchronize()
    ops, names = _device_ops(torch, start)
    return dict(host_ms=_host_ms(torch, start), device_ops=ops, device_op_names=names,
                blocking_reads=_blocking_reads(torch, start))


def _levels(torch, eng, queries):
    """The low-K BFS a level at a time: each level's expansion measured,
    then the apply; and one level's step and expansion host µs."""
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.ops import (
        bitbell, cuda_flag_pull,
    )
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.utils import (
        timing,
    )

    padded = eng._pad_queries(queries)[0]
    carry = eng._init_carry(padded)
    w = carry.frontier.shape[1]
    scratch = cuda_flag_pull.flag_pull_scratch(eng.graph, w, carry.frontier.device)
    expand = eng._expand(w)
    hits = torch.zeros_like(carry.frontier)
    off = bitbell.BitCarry(carry.visited, carry.frontier, carry.f, carry.levels, carry.reached,
                           carry.counts, carry.ctrl.clone(), carry.switch, carry.k)
    off.ctrl[0] = 0
    step = eng._stepper(off)
    host = dict(step_us=_host_us(torch, lambda: step(off)),
                expand_us=_host_us(torch, lambda: expand(off, hits, TOP, scratch)))
    rows = []
    while bitbell.level_go(carry.ctrl, TOP):
        pushed = int(carry.ctrl[3]) == bitbell.DIR_PUSH
        call = lambda: expand(carry, hits, TOP, scratch)  # noqa: E731
        timing.reset_launch_counts()
        call()
        torch.cuda.synchronize()
        launches = timing.launch_counts()
        ops, names = _device_ops(torch, call)
        rows.append(dict(level=len(rows) + 1, direction="push" if pushed else "pull",
                         launches=launches, device_ops=ops, device_op_names=names,
                         ms=_device_ms(torch, call)))
        bitbell.bit_level_apply(carry, hits)
    return dict(host=host, levels=rows)


def _busy(torch, eng, queries, levels):
    """The device's busy share of one chunk of ``levels`` levels."""
    from torch.profiler import ProfilerActivity, profile

    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.ops import mxu

    padded = eng._pad_queries(queries)[0]

    def chunk():
        c = eng._init_carry(padded)
        torch.cuda.synchronize()
        if isinstance(eng, mxu.MxuEngine):
            return c, lambda: eng._chunk(c, levels, torch.empty_like(c.frontier))
        return c, lambda: eng._chunk(c, levels)

    spans = []
    for _ in range(3):
        _, run = chunk()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        run()
        e1.record()
        e1.synchronize()
        spans.append(e0.elapsed_time(e1))
    best = 0.0
    for _ in range(2):  # a trace can miss a chunk's first launches
        _, run = chunk()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        busy = sum(e.time_range.elapsed_us() for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
        best = max(best, busy)
    span = _median(spans)
    return dict(chunk_ms=span, busy_ms=best, busy_share=best / span if best else None)


def _mesh_run(torch, dev, files, route):
    """The route's engine as the CLI builds it, fresh for each of four
    ``f_values`` runs (so its capacity reruns count): one untimed (its
    wall ms); one with each launch of the route's kernel (H3 or M2) timed
    alone, CUDA events around the call behind a queued device sleep, its
    size (listed rows, or the nonzero words the encoding counted) read
    after the run; one that keeps the inputs of the widest launch and of
    the thin one, each then timed again alone (median of 10); one under
    torch.profiler (the kernels' own device time, summed)."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.parallel import (
        mesh, partition2d, push_sharded,
    )
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.utils import (
        io as tio,
    )

    gpath, qpath = files[ROUTES[route][0]]
    g = tio.load_graph_bin(gpath)
    q = tio.pad_queries(tio.load_query_bin(qpath))
    devices = [dev] * MESH_SHARDS
    if route.startswith("vshard4"):
        module, name, names = push_sharded, "owner_push_expand", ("owner_expand_kernel",)

        def make():
            return push_sharded.ShardedPushEngine(mesh.make_mesh(1, MESH_SHARDS,
                                                                 devices=devices), g)

        def size(args, kwargs, out):
            ctrl = args[11]
            return torch.stack([torch.clamp(args[2][0], max=args[1].shape[0]),
                                ctrl[0].to(args[2].dtype)])

        def keep(args, kwargs):
            return tuple(x.clone() if isinstance(x, torch.Tensor) else x for x in args[:13])

        def again(snap):
            work = [t.clone() if isinstance(t, torch.Tensor) else t for t in snap]
            return lambda: real(*work)
    else:
        module, name = partition2d, "wire_encode"
        names = ("encode_kernel", "encode_count_kernel", "encode_write_kernel")

        def make():
            return partition2d.Mesh2DEngine(mesh.make_mesh2d(2, 2, devices=devices), g,
                                            **_mesh2d_kwargs(route))

        def size(args, kwargs, out):
            return torch.stack([out.count[0], out.count[0].new_ones(())])

        def keep(args, kwargs):
            return (args[0].clone(), *args[1:3])

        def again(snap):
            return lambda: real(*snap)

    real = getattr(module, name)

    def run(wrapper=None):
        eng = make()
        torch.cuda.synchronize()
        if wrapper is not None:
            setattr(module, name, wrapper)
        gc.collect()
        gc.disable()  # a collection inside a timed call would land between its events
        t0 = time.perf_counter()
        try:
            f = eng.f_values(q).cpu().numpy()
        finally:
            wall = (time.perf_counter() - t0) * 1e3
            gc.enable()
            setattr(module, name, real)
        torch.cuda.synchronize()
        return f, wall, eng

    f, wall, eng = run()
    bounds = (eng.capacity, eng.boundary) if hasattr(eng, "boundary") else None
    del eng
    calls = []

    def timed(*args, **kwargs):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        torch.cuda._sleep(LAUNCH_SLACK)
        ev[0].record()
        out = real(*args, **kwargs)
        ev[1].record()
        calls.append((ev, size(args, kwargs, out)))
        return out

    assert np.array_equal(run(timed)[0], f), route
    ms = [ev[0].elapsed_time(ev[1]) for ev, _ in calls]
    sizes = [[int(x) for x in sz.tolist()] for _, sz in calls]
    live = [i for i, (_, go) in enumerate(sizes) if go]
    picks = {"widest": max(live, key=lambda i: sizes[i][0])}
    thin = next((i for i in live if 0 < sizes[i][0] < THIN), None)
    if thin is not None:
        picks["thin"] = thin
    snaps, seen = {}, [0]

    def keeping(*args, **kwargs):
        for which, i in picks.items():
            if i == seen[0]:
                snaps[which] = keep(args, kwargs)
        seen[0] += 1
        return real(*args, **kwargs)

    assert np.array_equal(run(keeping)[0], f), route
    alone = {}
    for which, snap in snaps.items():
        times = []
        for i in range(12):
            call = again(snap)
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            torch.cuda._sleep(HOST_SLACK)
            ev[0].record()
            call()
            ev[1].record()
            ev[1].synchronize()
            if i >= 2:
                times.append(ev[0].elapsed_time(ev[1]))
        alone[which] = dict(call=picks[which], size=sizes[picks[which]][0],
                            ms=_median(times), in_run_ms=ms[picks[which]])
    eng = make()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.f_values(q)
        torch.cuda.synchronize()
        profiled_wall = (time.perf_counter() - t0) * 1e3
    device = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    kern = [e.time_range.elapsed_us() / 1e3 for e in device if any(n in e.name for n in names)]
    busy = sum(e.time_range.elapsed_us() for e in device) / 1e3
    del eng
    order = sorted(ms)
    return dict(kernel=name, launches=len(ms), live_launches=len(live), sum_ms=sum(ms),
                p50_ms=order[len(order) // 2], p90_ms=order[int(len(order) * 0.9)],
                max_ms=order[-1], max_call=dict(call=ms.index(order[-1]),
                                                size=sizes[ms.index(order[-1])][0]),
                profiler_sum_ms=sum(kern), profiler_events=len(kern),
                profiled_run_ms=profiled_wall, device_busy_ms=busy,
                busy_share=busy / profiled_wall,
                widest=alone["widest"], thin=alone.get("thin"),
                untimed_run_ms=wall, bounds=bounds,
                winner=int(np.argmin(f)) + 1, min_f=int(f.min()))


def _torch_ops(device):
    """Of a profiled run's device events, the kernels that no hand-written
    kernel launched (no host copies): their count, ms and most frequent
    names."""
    names, count, ms = {}, 0, 0.0
    for e in device:
        if e.name.startswith(HANDWRITTEN) or e.name.startswith("Memcpy"):
            continue
        count += 1
        ms += e.time_range.elapsed_us() / 1e3
        key = e.name[:80]
        names[key] = names.get(key, 0) + 1
    top = dict(sorted(names.items(), key=lambda kv: -kv[1])[:8])
    return dict(torch_kernels=count, torch_kernel_ms=ms, torch_kernel_names=top)


def _halo_knobs(files, route):
    """The route's knobs; on vshard2 RMAT-20 also the JAX package's auto
    halo and push budgets for the graph (``chip_smoke.py`` phase 15's)."""
    knobs = dict(ROUTES[route][1])
    if route == "vshard2 rmat-20":
        from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.parallel import (
            sharded_bell,
        )
        from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.utils import (
            io as tio,
        )

        g = tio.load_graph_bin(files[ROUTES[route][0]][0])
        knobs.update(MSBFS_HALO_BUDGET=str(sharded_bell.default_halo_budget(2 * -(-g.n // 2), 2)),
                     MSBFS_PUSH_HALO=str(sharded_bell.default_push_halo_budget(
                         g.num_directed_edges, 2)))
    return knobs


def _timed_run(torch, make, q, names, patches=()):
    """One ``f_values`` run of a fresh engine (``make()``) with each launch
    of the kernels ``names`` timed alone (CUDA events behind a queued
    device sleep) and ``patches`` ((module, attribute, value) triples) in
    place; then one run of another fresh engine under torch.profiler,
    whose F must equal the first's.  Returns F, the timed run's launch
    counts, variants, ms a launch of each of ``names`` and wall ms, the
    profiled run's device events (the trace's opening sleep left out),
    its wall ms and the device's busy ms in it."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.runtime import (
        kernels,
    )
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.utils import (
        timing,
    )

    real_launch = kernels.launch
    events = {k: [] for k in names}

    def timed(name, device, *args, **kwargs):
        if name not in events:
            return real_launch(name, device, *args, **kwargs)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        torch.cuda._sleep(LAUNCH_SLACK)
        ev[0].record()
        out = real_launch(name, device, *args, **kwargs)
        ev[1].record()
        events[name].append(ev)
        return out

    saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in patches]
    eng = make()
    torch.cuda.synchronize()
    timing.reset_launch_counts()
    kernels.launch = timed
    for mod, attr, value in patches:
        setattr(mod, attr, value)
    gc.collect()
    gc.disable()  # a collection inside a timed launch would land between its events
    t0 = time.perf_counter()
    try:
        f = eng.f_values(q).cpu().numpy()
    finally:
        wall = (time.perf_counter() - t0) * 1e3
        gc.enable()
        kernels.launch = real_launch
        for mod, attr, value in saved:
            setattr(mod, attr, value)
    torch.cuda.synchronize()
    launches, variants = timing.launch_counts(), timing.variant_counts()
    ms = {k: [e0.elapsed_time(e1) for e0, e1 in evs] for k, evs in events.items()}
    del eng
    eng = make()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(100_000)  # a trace can miss its first events
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        f2 = eng.f_values(q).cpu().numpy()
        torch.cuda.synchronize()
        profiled_wall = (time.perf_counter() - t0) * 1e3
    del eng
    assert np.array_equal(f, f2)
    device = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
              and "spin_kernel" not in e.name]
    busy = sum(e.time_range.elapsed_us() for e in device) / 1e3
    return dict(f=f, launches=launches, variants=variants, ms=ms, wall_ms=wall,
                device=device, profiled_ms=profiled_wall, busy_ms=busy)


def _halo_push_run(torch, dev, files, route):
    """One ``f_values`` run of a fresh vertex-sharded forest at
    ``MSBFS_VSHARD=2`` on a ('q', 'v') mesh of 2 x 2 entries on the card,
    each H2 launch (the match, where the tree has it, and the push) timed
    alone (:func:`_timed_run`): launches, sums, the median and the
    longest; then one run under torch.profiler: the torch operations, the
    device's busy share and the run's wall ms."""
    import numpy as np

    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.parallel import (
        mesh, sharded_bell,
    )
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.utils import (
        io as tio,
    )

    gpath, qpath = files[ROUTES[route][0]]
    g = tio.load_graph_bin(gpath)
    q = tio.pad_queries(tio.load_query_bin(qpath))
    knobs = _halo_knobs(files, route)

    def make():
        return sharded_bell.ShardedBellEngine(
            mesh.make_mesh(2, 2, devices=[dev] * MESH_SHARDS), g,
            halo_budget=int(knobs["MSBFS_HALO_BUDGET"]),
            push_budget=int(knobs["MSBFS_PUSH_HALO"]))

    run = _timed_run(torch, make, q, ("halo_push_match", "halo_push_or"))
    ms = {k: sorted(v) for k, v in run["ms"].items()}
    f = run["f"]
    return dict(launches=run["launches"], knobs=knobs,
                timed_launches={k: len(v) for k, v in ms.items()},
                sum_ms={k: sum(v) for k, v in ms.items()},
                p50_ms={k: v[len(v) // 2] if v else None for k, v in ms.items()},
                max_ms={k: v[-1] if v else None for k, v in ms.items()},
                device_busy_ms=run["busy_ms"], profiled_run_ms=run["profiled_ms"],
                busy_share=run["busy_ms"] / run["profiled_ms"],
                **_torch_ops(run["device"]), winner=int(np.argmin(f)) + 1,
                min_f=int(f.min()))


def _mesh2d_kwargs(route):
    return dict(async_levels=4) if "async" in route else dict(merge_tree="ring")


def _mesh2d_kernels(torch, dev, files, route):
    """One ``f_values`` run of a fresh 2D mesh engine with each launch of
    M4, forest_gather, H1 and M1 timed alone (:func:`_timed_run`):
    launches and summed ms a kernel, and every kernel's launches and
    variants over the run; one run under torch.profiler: the device's busy
    share, those kernels' own time and the zero fills (fill kernels and
    memsets) beside them; on the async route, M4's whole-forest call
    (``forest_max_hits``: the parent's M4 and forest_gather, or the take
    form) on its widest and thinnest tiles, recorded and timed again alone
    (median of 10)."""
    import numpy as np

    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.parallel import (
        mesh, partition2d,
    )
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.utils import (
        io as tio,
    )

    gpath, qpath = files[ROUTES[route][0]]
    g = tio.load_graph_bin(gpath)
    q = tio.pad_queries(tio.load_query_bin(qpath))

    def make():
        return partition2d.Mesh2DEngine(mesh.make_mesh2d(2, 2, devices=[dev] * MESH_SHARDS), g,
                                        **_mesh2d_kwargs(route))

    real_hits = partition2d.forest_max_hits
    calls = {}

    def keeping(frontier, graph, hits, floor, go, scratch=None):
        slots = sum(int(c.shape[0]) for c in graph.level_cols)
        for which, better in (("widest", lambda a, b: a > b), ("thin", lambda a, b: a < b)):
            if which not in calls or better(slots, calls[which][0]):
                calls[which] = (slots, (frontier.clone(), graph, hits.clone(), floor, go.clone(),
                                        scratch))
        return real_hits(frontier, graph, hits, floor, go, scratch)

    patches = ((partition2d, "forest_max_hits", keeping),) if "async" in route else ()
    run = _timed_run(torch, make, q, tuple(MESH2D_KERNELS), patches)
    ms, f = run["ms"], run["f"]
    alone = {}
    for which, (slots, snap) in calls.items():
        times = []
        for i in range(12):
            frontier, graph, hits, floor, go, scratch = snap
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            torch.cuda._sleep(HOST_SLACK)
            ev[0].record()
            real_hits(frontier, graph, hits, floor, go, scratch)
            ev[1].record()
            ev[1].synchronize()
            if i >= 2:
                times.append(ev[0].elapsed_time(ev[1]))
        alone[which] = dict(slots=slots, levels=len(snap[1].level_cols), ms=_median(times))
    device, busy = run["device"], run["busy_ms"]
    profiled = {k: sum(e.time_range.elapsed_us() for e in device
                       if any(n in e.name for n in names)) / 1e3
                for k, names in MESH2D_KERNELS.items()}
    fills = [e for e in device if any(n in e.name for n in FILL_NAMES)]
    return dict(launches=run["launches"], variants=run["variants"],
                **_torch_ops(run["device"]),
                timed_launches={k: len(v) for k, v in ms.items()},
                sum_ms={k: sum(v) for k, v in ms.items()},
                total_ms=sum(sum(v) for v in ms.values()),
                profiler_ms=profiled, profiler_total_ms=sum(profiled.values()),
                zero_fills=len(fills), zero_fill_ms=sum(e.time_range.elapsed_us()
                                                        for e in fills) / 1e3,
                device_busy_ms=busy, profiled_run_ms=run["profiled_ms"],
                busy_share=busy / run["profiled_ms"], timed_run_ms=run["wall_ms"],
                forest_max_hits=alone, winner=int(np.argmin(f)) + 1, min_f=int(f.min()))


def _cli_span(cli, argv, knobs, reps, mesh_devices=None):
    """The report's computation span (median of ``reps`` runs), and each
    run's preprocessing span and its layout phase."""
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.utils import (
        timing,
    )

    spans, pre, layout = [], [], []
    for _ in range(reps):
        buf = io.StringIO()
        with _env(**knobs), contextlib.redirect_stdout(buf):
            assert (cli.main(argv) if mesh_devices is None
                    else cli.main(argv, mesh_devices=mesh_devices)) == 0
        lines = buf.getvalue().splitlines()
        spans.append(float(lines[6].split(":", 1)[1].split()[0]) * 1e3)
        pre.append(float(lines[5].split(":", 1)[1].split()[0]) * 1e3)
        layout.append(timing.phase_seconds().get("layout", 0.0) * 1e3)
    return dict(computation_ms=_median(spans), runs_ms=spans, preprocessing_ms=pre,
                layout_ms=layout,
                winner=int(lines[2].rsplit(":", 1)[1]), min_f=int(lines[3].rsplit(":", 1)[1]))


def _push_bfs(torch, dev, files, route):
    """The push (or ppush) engine's capacities over one auto-capacity
    call, then one BFS at the last of them a level at a time: each
    level's two kernels timed on their own (CUDA events), summed."""
    import inspect

    import numpy as np

    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.ops import (
        bfs, bitbell, cuda_push, push, push_packed,
    )
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.utils import (
        io as tio,
    )

    gpath, qpath = files[ROUTES[route][0]]
    q = tio.pad_queries(tio.load_query_bin(qpath))
    adj = push.PaddedAdjacency.from_host(tio.load_graph_bin(gpath), dev)
    packed = route.startswith("ppush")
    eng = (push_packed.PackedPushEngine if packed else push.PushEngine)(adj)
    trail, dispatch = [], eng._dispatch

    def recorded(queries):
        trail.append(eng.capacity)
        return dispatch(queries)

    eng._dispatch = recorded
    f = eng.f_values(q).cpu().numpy()
    cap = trail[-1]
    if packed:
        qp = push_packed._pad_rows(q, push_packed._k_pad(q.shape[0]))
        carry = push_packed._packed_init_batch(adj, qp, cap)
        start, vals, _ = push_packed._table_csr(adj)
        first = lambda c: bitbell.sparse_hits_or(  # noqa: E731
            c.frontier, start, vals, c.hits, c.ctrl, c.switch, bfs.INT32_MAX)
        second = lambda c: cuda_push.row_compact(c, bfs.INT32_MAX)  # noqa: E731
        size = lambda c: int(c.count[0])  # noqa: E731
    else:
        carry = push._push_init_batch(adj, q, cap)
        bfs.arm_chunk(carry, None, None)
        # The parent tree's K10 reads the padded table alone.
        extra = (push.table_csr(adj),) if len(
            inspect.signature(cuda_push.queue_expand).parameters) > 2 else ()
        first = lambda c: cuda_push.queue_expand(adj.rows, c, *extra)  # noqa: E731
        second = cuda_push.queue_compact
        size = lambda c: int(torch.clamp(c.count, max=cap).sum())  # noqa: E731
    levels = []
    while bool(carry.running(None)):
        entries = size(carry)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        torch.cuda._sleep(2_000_000)  # the wrappers' host time falls in the sleep
        ev[0].record()
        first(carry)
        ev[1].record()
        torch.cuda._sleep(2_000_000)
        ev[2].record()
        second(carry)
        ev[3].record()
        ev[3].synchronize()
        levels.append((entries, ev[0].elapsed_time(ev[1]), ev[2].elapsed_time(ev[3]),
                       int(carry.count.sum()) if not packed else int(carry.count[0])))
    ms = [a + b for _, a, b, _ in levels]
    widest = max(range(len(levels)), key=lambda i: levels[i][0])
    thin = next(i for i, lv in enumerate(levels) if lv[3] < 4096)
    names = ("push_or_ms", "compact_ms") if packed else ("expand_ms", "compact_ms")
    return dict(capacity_trail=trail, capacity=cap, levels=len(ms),
                level_device_ms_sum=sum(ms), level_device_ms_max=max(ms), level_ms=ms,
                **{f"{n}_sum": sum(lv[i + 1] for lv in levels) for i, n in enumerate(names)},
                widest=dict(level=widest, entries=levels[widest][0],
                            **{n: levels[widest][i + 1] for i, n in enumerate(names)}),
                thin=dict(level=thin, entries=levels[thin][0], new=levels[thin][3],
                          **{n: levels[thin][i + 1] for i, n in enumerate(names)}),
                winner=int(np.argmin(f)) + 1, min_f=int(f.min()))


def _csr_bfs(torch, dev, files, route):
    """One BFS of the route's distance loop a level at a time, after an
    untimed one: each level's K9 launches timed together (CUDA events
    behind a queued device sleep, so the wrapper's host time falls in the
    sleep), summed."""
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.ops import (
        bfs, cuda_csr, packed,
    )
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.utils import (
        io as tio,
    )

    gpath, qpath = files[ROUTES[route][0]]
    q = tio.pad_queries(tio.load_query_bin(qpath))
    dg = tio.load_graph_bin(gpath).to_device(dev)

    def start():
        if route.startswith("packed"):
            carry = packed.packed_carry_init(dg, q)
        else:
            carry = bfs.distance_carry_init(dg.n, q, device=dev)
        bfs.arm_chunk(carry, None, None)
        return carry

    carry = start()  # a first BFS untimed: the kernels' first launches load them
    while int(carry.ctrl[0]):
        cuda_csr.csr_pull(dg, carry)
    carry = start()
    ms, new = [], []
    while int(carry.ctrl[0]):
        before = int((carry.dist == -1).sum())
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        e0.record()
        cuda_csr.csr_pull(dg, carry)
        e1.record()
        e1.synchronize()
        ms.append(e0.elapsed_time(e1))
        new.append(before - int((carry.dist == -1).sum()))
    widest = max(range(len(new)), key=new.__getitem__)
    return dict(levels=len(ms), level_ms=ms, level_device_ms_sum=sum(ms), new_labels=new,
                level0_ms=ms[0], widest=dict(level=widest, new=new[widest], ms=ms[widest]))


def _split_ms(np, g, reps=3):
    """The engine's build-time split of the weighted dedup slots into a
    light and a heavy side, timed both ways on ``g`` (host ms of each of
    ``reps`` runs): the native partition (``native_loader.split_slots``)
    and the NumPy masks it replaced, on the same int32 arrays; None in a
    tree without the native split."""
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.runtime import (
        native_loader,
    )
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.weighted import (
        deltastep,
    )

    if not hasattr(native_loader, "split_slots"):
        return None
    u, v, w, _ = (np.ascontiguousarray(a, dtype=np.int32) for a in g.deduped_weighted())
    delta = deltastep.resolve_delta(w)

    def masks():
        light = w <= delta
        return tuple((u[keep], v[keep], w[keep]) for keep in (light, ~light))

    out = dict(slots=int(w.size), delta=delta)
    for name, fn in (("native_ms", lambda: native_loader.split_slots(u, v, w, delta)),
                     ("numpy_masks_ms", masks)):
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        out[name] = times
    return out


def _weighted_run(torch, dev, files, route):
    """One f_values run of the route's weighted engine after a warm one:
    K12's device ms summed over the profiler's ``weighted_relax*`` events,
    its launches, the profiled run's wall ms, its device ms by kernel name
    and host ops' self ms (the eight largest), and the median wall ms of
    three runs without the profiler; on RMAT-20 the slots' split timed
    both ways (:func:`_split_ms`)."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch import weighted
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.utils import (
        io as tio,
        timing,
    )

    data, knobs = ROUTES[route]
    gpath, qpath = files[data]
    q = tio.pad_queries(tio.load_query_bin(qpath))
    g = tio.load_graph_bin(gpath)
    _, eng = weighted.negotiate_weighted_engine(
        g, knobs.get("MSBFS_WEIGHTED_ENGINE", "auto"), device=dev)
    split = _split_ms(np, g) if data == "rmat-20 weighted" else None
    del g
    f = eng.f_values(q).numpy()
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.f_values(q)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    timing.reset_launch_counts()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.f_values(q)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    launches = timing.launch_counts().get("weighted_relax", 0)
    device = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    k12 = [e.time_range.elapsed_us() / 1e3 for e in device if "weighted_relax" in e.name]
    by_name = {}
    for e in device:
        name = e.name.split("(")[0].split("<")[0].replace("void ", "")[:60]
        by_name[name] = by_name.get(name, 0.0) + e.time_range.elapsed_us() / 1e3
    host = sorted(((a.key, a.self_cpu_time_total / 1e3) for a in prof.key_averages()),
                  key=lambda kv: -kv[1])[:8]
    return dict(k12_ms=sum(k12), k12_events=len(k12), launches=launches,
                device_busy_ms=sum(by_name.values()),
                device_ms=dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:8]),
                host_self_ms=dict(host),
                profiled_wall_ms=wall, wall_ms=_median(walls), walls_ms=walls,
                k12_share_of_profiled_run=sum(k12) / wall, stats=eng.weighted_stats(),
                winner=int(f.argmin()) + 1, min_f=int(f.min()), split=split)


def child(tree: str, files: dict, reps: int, routes) -> dict:
    import torch

    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch import cli
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.runtime import (
        kernels,
    )

    assert kernels.__file__.startswith(os.path.abspath(tree)), kernels.__file__
    dev = torch.device("cuda", 0)
    kernels.library()
    out = dict(tree=tree, batch_start={}, levels={}, busy={}, cli={}, push_bfs={}, csr_bfs={},
               weighted={}, mesh={}, mesh2d={})
    engines = _engines(torch, dev, files, routes)
    for route, (eng, q) in engines.items():
        out["batch_start"][route] = _batch_start(torch, eng, q)
    for route in (r for r in LEVEL_ROUTES if r in routes):
        out["levels"][route] = _levels(torch, *engines[route])
    for route in (r for r in BUSY_ROUTES if r in routes):
        eng, q = engines[route]
        depth = int(max(eng.query_stats(q)[0]))
        out["busy"][route] = _busy(torch, eng, q, depth)
    del engines
    torch.cuda.empty_cache()
    for route in (r for r in PUSH_ROUTES if r in routes):
        out["push_bfs"][route] = _push_bfs(torch, dev, files, route)
        torch.cuda.empty_cache()
    for route in (r for r in CSR_ROUTES if r in routes):
        out["csr_bfs"][route] = _csr_bfs(torch, dev, files, route)
        torch.cuda.empty_cache()
    for route in (r for r in WEIGHTED_ROUTES if r in routes):
        out["weighted"][route] = _weighted_run(torch, dev, files, route)
        torch.cuda.empty_cache()
    for route in (r for r in MESH_ROUTES if r in routes):
        if route == "vshard2 rmat-20":
            out["mesh"][route] = _halo_push_run(torch, dev, files, route)
            torch.cuda.empty_cache()
            continue
        out["mesh"][route] = _mesh_run(torch, dev, files, route)
        torch.cuda.empty_cache()
        if route.startswith("mesh2d"):
            out["mesh2d"][route] = _mesh2d_kernels(torch, dev, files, route)
            torch.cuda.empty_cache()
    for route in routes:
        data = ROUTES[route][0]
        knobs = _halo_knobs(files, route)
        gpath, qpath = files[data]
        shards = MESH_SHARDS if route in MESH_ROUTES else 1
        out["cli"][route] = _cli_span(
            cli, ["chip_compare", "-g", gpath, "-q", qpath, "-gn", str(shards)], knobs, reps,
            [dev] * shards if shards > 1 else None)
    return out


# -- the runs: one child process a TREE ----------------------------------------


def _summary(runs):
    """Per TREE (its runs merged): batch start host ms, device ops and
    reads per route; the low-K levels' launches and ms; CLI spans and busy
    shares."""
    by_tree = {}
    for r in runs:
        by_tree.setdefault(r["tree"], []).append(r)
    out = {}
    for tree, rs in by_tree.items():
        t = out[tree] = {}
        t["batch_start"] = {route: dict(
            host_ms=[x["batch_start"][route]["host_ms"] for x in rs],
            device_ops=rs[0]["batch_start"][route]["device_ops"],
            device_op_names=[x["batch_start"][route]["device_op_names"] for x in rs],
            blocking_reads=rs[0]["batch_start"][route]["blocking_reads"])
            for route in rs[0]["batch_start"]}
        t["levels"] = {route: dict(
            step_us=[x["levels"][route]["host"]["step_us"] for x in rs],
            expand_us=[x["levels"][route]["host"]["expand_us"] for x in rs],
            launches=[sum(lv["launches"].values()) for lv in rs[0]["levels"][route]["levels"]],
            device_ops=[lv["device_ops"] for lv in rs[0]["levels"][route]["levels"]],
            device_op_names=[lv["device_op_names"] for lv in rs[0]["levels"][route]["levels"]],
            ms=[[x["levels"][route]["levels"][i]["ms"] for x in rs]
                for i in range(len(rs[0]["levels"][route]["levels"]))],
            directions=[lv["direction"] for lv in rs[0]["levels"][route]["levels"]])
            for route in rs[0]["levels"]}
        t["cli_computation_ms"] = {route: [x["cli"][route]["computation_ms"] for x in rs]
                                   for route in rs[0]["cli"]}
        t["cli_layout_ms"] = {route: [x["cli"][route]["layout_ms"] for x in rs]
                              for route in rs[0]["cli"]}
        t["cli_preprocessing_ms"] = {route: [x["cli"][route]["preprocessing_ms"] for x in rs]
                                     for route in rs[0]["cli"]}
        t["busy_share"] = {route: [x["busy"][route]["busy_share"] for x in rs]
                           for route in rs[0]["busy"]}
        t["push_bfs"] = {route: dict(
            level_device_ms_sum=[x["push_bfs"][route]["level_device_ms_sum"] for x in rs],
            level_device_ms_max=[x["push_bfs"][route]["level_device_ms_max"] for x in rs],
            levels=rs[0]["push_bfs"][route]["levels"],
            widest=[x["push_bfs"][route]["widest"] for x in rs],
            thin=[x["push_bfs"][route]["thin"] for x in rs],
            kernel_sums={k: [x["push_bfs"][route][k] for x in rs]
                         for k in rs[0]["push_bfs"][route] if k.endswith("_ms_sum")},
            capacity_trail=rs[0]["push_bfs"][route]["capacity_trail"],
            min_f=[x["push_bfs"][route]["min_f"] for x in rs])
            for route in rs[0]["push_bfs"]}
        t["chunk_ms"] = {route: [x["busy"][route]["chunk_ms"] for x in rs]
                         for route in rs[0]["busy"]}
        t["csr_bfs"] = {route: dict(
            level_device_ms_sum=[x["csr_bfs"][route]["level_device_ms_sum"] for x in rs],
            level0_ms=[x["csr_bfs"][route]["level0_ms"] for x in rs],
            widest=[x["csr_bfs"][route]["widest"] for x in rs],
            level_ms=[x["csr_bfs"][route]["level_ms"] for x in rs])
            for route in rs[0]["csr_bfs"]}
        t["weighted"] = {route: dict(
            k12_ms=[x["weighted"][route]["k12_ms"] for x in rs],
            launches=[x["weighted"][route]["launches"] for x in rs],
            device_busy_ms=[x["weighted"][route]["device_busy_ms"] for x in rs],
            wall_ms=[x["weighted"][route]["wall_ms"] for x in rs],
            profiled_wall_ms=[x["weighted"][route]["profiled_wall_ms"] for x in rs],
            min_f=[x["weighted"][route]["min_f"] for x in rs],
            split=[x["weighted"][route]["split"] for x in rs])
            for route in rs[0]["weighted"]}
        t["mesh"] = {route: {k: [x["mesh"][route].get(k) for x in rs]
                             for k in ("launches", "sum_ms", "p50_ms", "p90_ms", "max_ms",
                                       "profiler_sum_ms", "profiler_events", "busy_share",
                                       "widest", "thin", "untimed_run_ms", "bounds",
                                       "timed_launches", "torch_kernels", "torch_kernel_ms",
                                       "profiled_run_ms", "min_f")
                             if k in rs[0]["mesh"][route]}
                     for route in rs[0]["mesh"]}
        t["mesh2d"] = {route: {k: [x["mesh2d"][route][k] for x in rs]
                               for k in ("launches", "sum_ms", "total_ms", "profiler_ms",
                                         "profiler_total_ms", "zero_fills", "zero_fill_ms",
                                         "torch_kernels", "torch_kernel_ms", "busy_share",
                                         "forest_max_hits", "min_f")}
                       for route in rs[0]["mesh2d"]}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="*")
    ap.add_argument("--out", default="build/chip_compare")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--routes", default=",".join(ROUTES),
                    help="comma-separated route names (default: every route)")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    ap.add_argument("--files", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        sys.path.insert(0, os.path.abspath(args.child))
        result = child(args.child, json.loads(args.files), args.reps,
                       args.routes.split(","))
        print("RESULT " + json.dumps(result))
        return 0
    import torch

    if not torch.cuda.is_available():
        print("chip_compare: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    if not args.trees:
        ap.error("give at least one TREE")
    routes = args.routes.split(",")
    unknown = [r for r in routes if r not in ROUTES]
    if unknown:
        ap.error(f"unknown routes {unknown}; known: {list(ROUTES)}")
    card = _card_line()
    os.makedirs(args.out, exist_ok=True)
    tmpdir = tempfile.TemporaryDirectory(prefix="msbfs_compare_")
    files = _make_data(tmpdir.name, {ROUTES[r][0] for r in routes})
    runs = []
    for i, tree in enumerate(args.trees):
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child", tree, "--files",
             json.dumps(files), "--reps", str(args.reps), "--routes", args.routes],
            capture_output=True, text=True, timeout=1800,
        )
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-8000:], file=sys.stderr)
            raise SystemExit(f"the run of {tree} failed (exit {proc.returncode})")
        result = json.loads(proc.stdout.split("RESULT ", 1)[1].splitlines()[0])
        result["seconds"] = time.perf_counter() - t0
        runs.append(result)
        with open(os.path.join(args.out, f"run{i}.json"), "w") as fh:
            json.dump(result, fh)
        print(f"run {i} {tree}: {time.perf_counter() - t0:.1f} s")
    tmpdir.cleanup()
    summary = _summary(runs)
    with open(os.path.join(args.out, "summary.json"), "w") as fh:
        json.dump(dict(card=card, trees=args.trees, summary=summary), fh)
    print(f"card: {card}")
    print("summary " + json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""On-card smoke of the PyTorch/CUDA port — the quickest proof that it
builds and runs on the GPU, and the source of its kernel timings.

    python3 chip_smoke.py [--seed 0]

Needs one CUDA card (NVIDIA H100 class, sm_90a), nvcc, and scipy; imports
nothing of JAX.  Phases (any failure exits non-zero; nothing is caught):

1. print the card (nvidia-smi name, power limit); build the three CUDA
   kernels from csrc/ in parallel and time the build;
2. hold each kernel against its plain torch version on the card, bit for
   bit, at the main path's shapes (road-4096: n = 16.8M, W = 1) and at the
   sub-batch shape (road-1024, n = 1M, W = 8); time both with CUDA events
   beside the analytic bound;
3. main path: road_edges(4096, 4096) with K = 16 random query groups as
   .bin files, through the port's CLI (``cli.main``) on cuda, with the
   kernel launch counters zeroed just before and read just after; the
   kernel path's F vector equals the plain path's on the card, and the
   winner's F equals scipy's multi-source BFS;
4. road-1024 at K = 16 (BASELINE.md config 4): every F and the winner
   equal scipy's;
5. road-1024 at K = 300 through the sub-batch split (W = 8 and W = 2):
   kernel path equals plain path;
6. grid_edges(2048, 2048) with corner sources: the active-row window
   engages (some chunk runs on fewer rows than n) and its results equal
   the plain path's without the window;
then the ``{"kernels": [...]}`` line and the final ``{"ok": true, ...}``.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

# Card peaks for the bound (NVIDIA H100 SXM data sheet, at 700 W): 3.35 TB/s
# of HBM3, and 16.7e12 int32 operations/s — 64 INT32 lanes per SM x 132 SMs
# x 1.98 GHz, the same issue rate that gives the 67 TFLOP/s fp32 figure
# (128 fp32 lanes, a fused multiply-add counted as two).
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 16.7e12


def _card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def _bound_ms(nbytes: float, ops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _time_ms(torch, fn, restore, reps=10, warm=2):
    """Median device time of one call of ``fn`` (CUDA events around the
    call alone; ``restore`` resets its in-place inputs between calls)."""
    times = []
    for i in range(warm + reps):
        restore()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        if i >= warm:
            times.append(e0.elapsed_time(e1))
    times.sort()
    return times[len(times) // 2]


def _max_abs_err(torch, pairs) -> int:
    err = 0
    for a, b in pairs:
        err = max(err, int((a.to(torch.int64) - b.to(torch.int64)).abs().max()))
    return err


def _compare_kernels(torch, sg, w, seed, label):
    """Each kernel against its plain version on one graph's shapes."""
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.ops import (
        bitbell, cuda_stencil, stencil,
    )

    dev = sg.device
    n, k = sg.n, 32 * w
    gen = torch.Generator(device=dev).manual_seed(seed)

    def words(density):
        x = torch.randint(-(2**31), 2**31, (n, w), dtype=torch.int32,
                          device=dev, generator=gen)
        keep = torch.rand((n, 1), device=dev, generator=gen) < density
        return torch.where(keep, x, 0)

    frontier, visited, hits0 = words(0.05), words(0.5), words(0.3)
    go = torch.tensor([1, 7, 0, 0], dtype=torch.int32, device=dev)
    out = {}

    # A: the masked-shift sweep.
    offs = sg.offsets
    h_k, h_p = torch.empty_like(frontier), torch.empty_like(frontier)
    cuda_stencil.stencil_sweep(frontier, sg.mask_bits, offs, h_k, go, 2**31 - 1)
    cuda_stencil.stencil_sweep_plain(frontier, sg.mask_bits, offs, h_p, go, 2**31 - 1)
    torch.cuda.synchronize()
    err = _max_abs_err(torch, [(h_k, h_p)])
    ms = _time_ms(torch, lambda: cuda_stencil.stencil_sweep(
        frontier, sg.mask_bits, offs, h_k, go, 2**31 - 1), lambda: None)
    plain_ms = _time_ms(torch, lambda: cuda_stencil.stencil_sweep_plain(
        frontier, sg.mask_bits, offs, h_p, go, 2**31 - 1), lambda: None, reps=3)
    bound, by = _bound_ms(n * 4 * (2 * w + 1), n * w * len(offs) * 4)
    out["stencil_sweep"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                bound_ms=bound, bound_by=by)

    # B: the residual segment-OR (into a fresh copy of one hit plane).
    r, u = int(sg.res_src.shape[0]), int(sg.res_dst_unique.shape[0])
    if r:
        res = (sg.res_src, sg.res_seg, sg.res_dst_unique)
        b_k, b_p = hits0.clone(), hits0.clone()
        stencil.residual_or(frontier, *res, b_k, go, 2**31 - 1)
        stencil.residual_or_plain(frontier, *res, b_p, go, 2**31 - 1)
        torch.cuda.synchronize()
        err = _max_abs_err(torch, [(b_k, b_p)])
        ms = _time_ms(torch, lambda: stencil.residual_or(
            frontier, *res, b_k, go, 2**31 - 1), lambda: b_k.copy_(hits0))
        plain_ms = _time_ms(torch, lambda: stencil.residual_or_plain(
            frontier, *res, b_p, go, 2**31 - 1), lambda: b_p.copy_(hits0), reps=3)
        bound, by = _bound_ms(r * 8 + u * 4 + r * w * 4 + u * w * 8, r * w * 2)
        out["residual_or"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                  bound_ms=bound, bound_by=by)

    # C: the level apply with per-query counts.
    def fresh():
        return bitbell.BitCarry(
            visited=visited.clone(), frontier=frontier.clone(),
            f=torch.arange(k, dtype=torch.int64, device=dev) * 1000,
            levels=torch.full((k,), 3, dtype=torch.int32, device=dev),
            reached=torch.full((k,), 5, dtype=torch.int32, device=dev),
            counts=torch.zeros(k, dtype=torch.int32, device=dev),
            ctrl=go.clone(),
        )

    c_k, c_p = fresh(), fresh()
    bitbell.bit_level_apply(c_k, hits0)
    bitbell.bit_level_apply_plain(c_p, hits0)
    torch.cuda.synchronize()
    fields = ("visited", "frontier", "f", "levels", "reached", "counts", "ctrl")
    err = _max_abs_err(torch, [(getattr(c_k, f), getattr(c_p, f)) for f in fields])
    pristine = fresh()

    def restore(c):
        for f in fields:
            getattr(c, f).copy_(getattr(pristine, f))

    ms = _time_ms(torch, lambda: bitbell.bit_level_apply(c_k, hits0),
                  lambda: restore(c_k))
    plain_ms = _time_ms(torch, lambda: bitbell.bit_level_apply_plain(c_p, hits0),
                        lambda: restore(c_p), reps=3)
    bound, by = _bound_ms(n * w * 16 + k * 40, n * w * 64)
    out["level_apply"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                              bound_ms=bound, bound_by=by)
    for name, row in out.items():
        print(f"compare {label} n={n} W={w} {name}: " + json.dumps(row))
        assert row["max_abs_err"] == 0, (label, name, row)
    return out


def _scipy_f(sp, cg, np, graph, sources):
    """F of one query group from scipy's multi-source BFS (unweighted)."""
    n = graph.n
    src = np.unique(sources[(sources >= 0) & (sources < n)])
    if src.size == 0:
        return 0
    a = sp.csr_matrix(
        (np.ones(graph.col_indices.size, np.float32), graph.col_indices,
         graph.row_offsets), shape=(n, n),
    )
    d = cg.dijkstra(a, directed=True, indices=src, unweighted=True, min_only=True)
    return int(d[np.isfinite(d)].sum())


def _run_cli(cli, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    report = buf.getvalue()
    print(report, end="")
    assert rc == 0, rc
    lines = report.splitlines()
    min_k = int(lines[2].rsplit(":", 1)[1]) - 1
    min_f = int(lines[3].rsplit(":", 1)[1])
    comp_s = float(lines[6].split(":", 1)[1].split()[0])
    pre_s = float(lines[5].split(":", 1)[1].split()[0])
    return min_k, min_f, pre_s, comp_s


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    t_start = time.perf_counter()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    import numpy as np
    import scipy.sparse as sp
    import scipy.sparse.csgraph as cg

    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch import cli
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.models import (
        generators,
    )
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.models.csr import (
        CSRGraph,
    )
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.ops import (
        packed, stencil,
    )
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.runtime import (
        kernels,
    )
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.utils import (
        io as tio, timing,
    )

    card = _card_line()
    print(f"card: {card}")
    dev = torch.device("cuda", 0)
    print(f"device: {torch.cuda.get_device_name(0)}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}")

    # ---- 1. build
    t0 = time.perf_counter()
    built = kernels.build_all()
    kernels.library()
    build_s = time.perf_counter() - t0
    print(f"build: {build_s:.3f} s wall for {len(built)} kernels in parallel")
    for name, res in built.items():
        regs = [ln.strip() for ln in res.log.splitlines() if "Used" in ln]
        print(f"  {name}: {res.seconds:.3f} s; {'; '.join(regs)}")

    # ---- data: road-4096 (main path) and road-1024
    seed = args.seed
    t0 = time.perf_counter()
    n4, e4 = generators.road_edges(4096, 4096, seed=seed)
    g4 = CSRGraph.from_edges(n4, e4)
    sg4 = stencil.StencilGraph.from_host(g4, dev)
    n1, e1 = generators.road_edges(1024, 1024, seed=seed + 1)
    g1 = CSRGraph.from_edges(n1, e1)
    sg1 = stencil.StencilGraph.from_host(g1, dev)
    print(f"data: road-4096 n={n4} directed={g4.num_directed_edges} "
          f"offsets={len(sg4.offsets)} residual={int(sg4.res_src.shape[0])}; "
          f"road-1024 n={n1} residual={int(sg1.res_src.shape[0])}; "
          f"{time.perf_counter() - t0:.1f} s host")

    # ---- 2. kernels against their plain versions
    main_shape = _compare_kernels(torch, sg4, 1, seed, "road-4096")
    _compare_kernels(torch, sg1, 8, seed + 1, "road-1024")

    # ---- 3. main path through the CLI
    # Removed when the script ends, whichever way it ends.
    tmpdir = tempfile.TemporaryDirectory(prefix="msbfs_smoke_")
    tmp = tmpdir.name
    gpath, qpath = os.path.join(tmp, "road4096.bin"), os.path.join(tmp, "q.bin")
    q4 = generators.random_queries(n4, 16, seed=seed + 2)
    tio.save_graph_bin(gpath, n4, e4)
    tio.save_query_bin(qpath, q4)
    timing.reset_launch_counts()
    min_k, min_f, pre_s, comp_s = _run_cli(
        cli, ["chip_smoke", "-g", gpath, "-q", qpath, "-gn", "1"]
    )
    launches = timing.launch_counts()
    print(f"main path launches: {json.dumps(launches)}")
    for name in kernels.KERNELS:
        assert launches.get(name, 0) > 0, f"{name} never launched on the main path"

    padded4 = tio.pad_queries(q4)
    fast = stencil.StencilEngine(sg4, level_chunk=stencil.AUTO_STENCIL_LEVEL_CHUNK)
    plain = stencil.StencilEngine(
        sg4, level_chunk=stencil.AUTO_STENCIL_LEVEL_CHUNK, plain=True
    )
    t0 = time.perf_counter()
    levels4, reached4, f_fast = fast.query_stats(padded4)
    fast_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    f_plain = plain.f_values(padded4).cpu().numpy()
    plain_s = time.perf_counter() - t0
    assert np.array_equal(f_fast, f_plain), (f_fast, f_plain)
    assert int(f_fast[min_k]) == min_f
    want_f = _scipy_f(sp, cg, np, g4, q4[min_k])
    assert want_f == min_f, (want_f, min_f)
    depth = int(levels4.max())
    print("main path: " + json.dumps(dict(
        graph="road-4096", K=16, winner=min_k + 1, min_f=min_f, scipy_f=want_f,
        preprocessing_s=pre_s, computation_s=comp_s, levels=depth,
        reached=int(reached4.sum()), engine_query_stats_s=fast_s,
        plain_path_f_values_s=plain_s,
        ms_per_level=comp_s * 1e3 / max(depth, 1),
    )))

    # ---- 4. road-1024, K = 16: every F against scipy
    gpath1, qpath1 = os.path.join(tmp, "road1024.bin"), os.path.join(tmp, "q1.bin")
    q1 = generators.random_queries(n1, 16, seed=seed + 3)
    tio.save_graph_bin(gpath1, n1, e1)
    tio.save_query_bin(qpath1, q1)
    k1, f1, pre1, comp1 = _run_cli(
        cli, ["chip_smoke", "-g", gpath1, "-q", qpath1, "-gn", "1"]
    )
    eng1 = stencil.StencilEngine(sg1, level_chunk=stencil.AUTO_STENCIL_LEVEL_CHUNK)
    lv1, _, fv1 = eng1.query_stats(tio.pad_queries(q1))
    want1 = np.array([_scipy_f(sp, cg, np, g1, q) for q in q1])
    assert np.array_equal(fv1, want1), (fv1, want1)
    assert (k1, f1) == (int(np.argmin(want1)), int(want1.min()))
    print("road-1024 K=16: " + json.dumps(dict(
        winner=k1 + 1, min_f=f1, all_f_equal_scipy=True, levels=int(lv1.max()),
        preprocessing_s=pre1, computation_s=comp1,
    )))
    tmpdir.cleanup()

    # ---- 5. road-1024, K = 300: the sub-batch split
    q300 = tio.pad_queries(generators.random_queries(n1, 300, max_group=8, seed=seed + 4))
    sub_fast = packed.SubBatchEngine(
        stencil.StencilEngine(sg1, level_chunk=stencil.AUTO_STENCIL_LEVEL_CHUNK))
    sub_plain = packed.SubBatchEngine(stencil.StencilEngine(
        sg1, level_chunk=stencil.AUTO_STENCIL_LEVEL_CHUNK, plain=True))
    t0 = time.perf_counter()
    best300 = sub_fast.best(q300)
    sub_s = time.perf_counter() - t0
    f300 = sub_fast.f_values(q300).cpu().numpy()
    assert np.array_equal(f300, sub_plain.f_values(q300).cpu().numpy())
    assert best300 == (int(f300.min()), int(np.argmin(f300)))
    print(f"road-1024 K=300: best={best300} kernel-path best {sub_s:.3f} s, "
          "F equals plain path")

    # ---- 6. the active-row window on a residual-free grid
    ng, eg = generators.grid_edges(2048, 2048)
    sgg = stencil.StencilGraph.from_host(CSRGraph.from_edges(ng, eg), dev)
    rng = np.random.default_rng(seed + 5)
    qg = tio.pad_queries(
        [rng.integers(0, 32 * 2048, size=4).astype(np.int32) for _ in range(8)]
    )
    win = stencil.StencilEngine(sgg, level_chunk=64, megachunk=1, window=True)
    ref = stencil.StencilEngine(sgg, level_chunk=64, megachunk=1, window=False,
                                plain=True)
    timing.reset_plane_pass()
    t0 = time.perf_counter()
    got = win.query_stats(qg)
    win_s = time.perf_counter() - t0
    win_bytes = timing.plane_pass_bytes()
    want = ref.query_stats(qg)
    for x, y in zip(got, want):
        assert np.array_equal(x, y)
    narrow = sum(1 for *_, rows in win.last_window_trace if rows < ng)
    assert narrow > 0, win.last_window_trace[:4]
    print(f"grid-2048 window: {narrow} of {len(win.last_window_trace)} chunks "
          f"on fewer than n rows, {win_s:.3f} s, plane-pass bytes {win_bytes}, "
          "equal to the plain full-plane path")

    # ---- the kernel line, the card, the verdict
    sources = {
        "stencil_sweep": ("csrc/stencil_sweep.cu",
                          "parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu/ops/pallas_stencil.py:75"),
        "residual_or": ("csrc/residual_or.cu",
                        "parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu/ops/stencil.py:319"),
        "level_apply": ("csrc/level_apply.cu",
                        "parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu/ops/bitbell.py:333"),
    }
    rows = []
    for name, (src, replaces) in sources.items():
        row = main_shape[name]
        rows.append(dict(
            name=name, route="cuda",
            source="parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch/" + src,
            replaces=replaces, launches=launches[name],
            max_abs_err=row["max_abs_err"], ms=row["ms"], plain_ms=row["plain_ms"],
            bound_ms=row["bound_ms"], bound_by=row["bound_by"], library_ms=None,
        ))
    print(f"total: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(_card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""On-card smoke of the PyTorch/CUDA port — the quickest proof that it
builds and runs on the GPU, and the source of its kernel timings.

    python3 chip_smoke.py [--seed 0] [--detail-dir build/chip_smoke]

Needs one CUDA card (NVIDIA H100 class, sm_90a), nvcc, and scipy; imports
nothing of JAX.  Phases (any failure exits non-zero; nothing is caught):

1. print the card (nvidia-smi name, power limit); build the eight CUDA
   kernels from csrc/ in parallel and time the build;
2. hold each kernel against its plain torch version on the card, bit for
   bit, and time both with CUDA events beside the analytic bound: the
   stencil route's two (the sweep with the residual edges in its launch,
   against the plain sweep then the plain residual OR; the apply) at its
   main path's shape (road-4096: n = 16.8M, W = 1) and at the sub-batch
   shape (road-1024, n = 1M, W = 8); the mxu
   route's two (tile_hits, push_or) at its main path's shape (RMAT-14,
   T = 128, W = 2, every one of the 16,384 tiles nonzero) and at
   road-512's (T = 128, W = 1), with the bf16 ``torch.bmm`` of the same
   tile products timed as tile_hits' library yardstick (push_or on a
   frontier of about n / 64 rows, listed by the plain switch epilogue,
   beside its launch floor: the same launch gated off); level_apply also
   at the mxu route's plane shapes (RMAT-14 W = 2, road-512 W = 1).  Each
   sweep, apply and tile_hits row names the variant its plan took (ring or
   l2, the W instance, 16- or 4-byte access; pipe with its word group,
   split and stages, or simple), and its bound counts the bytes that
   input needs (the mask only of rows with a nonzero frontier; visited
   only where a hit word is nonzero);
3. stencil main path: road_edges(4096, 4096) with K = 16 random query
   groups as .bin files, through the port's CLI (``cli.main``) on cuda;
   the kernel path's F vector equals the plain path's on the card, and
   the winner's F equals scipy's multi-source BFS; then the sweep and the
   apply held against their plain versions and timed on the planes of the
   BFS's middle level, and 64 real levels from there split by kernel
   (CUDA events around each launch: the sweep with its residual, the
   apply, and the gaps), beside the same 64 levels as the engine enqueues
   them;
4. mxu main path: ``MSBFS_BACKEND=mxu MSBFS_MXU_KERNEL=1`` through the
   CLI on rmat_edges(14) with K = 64 random groups; every F equals
   scipy's and the plain engine's, and the direction trace is printed;
   tile_hits is then held against its plain version and timed on the
   frontier of the BFS's widest matmul level;
   after each CLI path below, pack_sources is held against its plain
   version on that route's batch as its engine pads it (stride 1 for bit
   planes, 8 for byte planes) and timed beside its bound, with the host
   time of a batch start's whole pack against the plain pack;
5. the mxu route on road_edges(512, 512) with K = 16: the auto switch
   sends levels both ways within one BFS; same checks; then the BFS a
   level at a time: the direction the device's apply wrote before each
   level equals ``level_direction_trace``, push_or and the switched apply
   are held against their plain versions on every level and timed on
   every eighth (the apply beside the same launch without the switch),
   the whole BFS split by launch with CUDA events (push_or, tile_hits,
   level_apply, gaps), and one engine chunk traced with torch.profiler
   for the device's busy share and the kernels it ran;
5a. the low-K route on RMAT-16 (rmat_edges(16, 16), BASELINE.json config
   1) with one group of one source through the CLI's auto route: F equals
   scipy's and the plain engine's; then the BFS a level at a time, the
   kernel engine equal to the plain engine before every level, K5's push
   (push_or on the byte plane's word view) and pull (flag_pull, with the
   carry's visited plane and counters) held against their byte plain
   versions and timed beside their bounds (the pull's whole function's
   and its level's, over the live rows only) and the ``index_reduce_``
   amax library call (the pull's then masked by ``~visited``), the pull
   also beside bell_hits_packed (forest_or on the word view) on the
   same frontier, the switched apply held and timed; and its launch
   split;
5b. RMAT-20 (rmat_edges(20, 16), BASELINE.json config 2): forest_or and
   ell_hits against their plain versions at K = 64 (W = 2) and K = 256
   (W = 8), timed beside their bounds (forest_or also beside its L2
   floor; ell_hits also beside the two-call
   torch expression of its gather, and both as a level on a stale carry —
   planes rebuilt from dist — and as a steady level on carried planes,
   the latter against its own plain version), and level_apply at W = 2;
   the ELL level split (CUDA events around the pack, gather and apply
   launches of each real level of the K = 64 BFS, with the virtual rows
   the gather skipped and the new labels); the K = 64 bitbell BFS a level
   at a time, as road-512's above (forest_or on each pull level beside its
   bound and L2 floor, push_or on each push level); the switched apply
   on RMAT-20's synthetic W = 2 plane as a pulled and as a pushed level;
   then with
   K = 64 random groups the default route (bitbell: forest_or, push_or,
   level_apply), the ELL route (``MSBFS_BACKEND=pallas``: ell_hits) and
   the byte-plane BELL route (``MSBFS_BACKEND=bell``, W = 16) through the
   CLI, and the low-K route on the first four groups, each a path;
   the 64 F values are equal across the kernel and plain engines of the
   three routes, the CLIs report the same winner and F, the winner and
   the first eight groups (the low-K route's four among them) equal
   scipy's; then the low-K BFS a level at a time as on RMAT-16, at K = 4
   and at K = 1 (the apply's time on its widest K = 1 level beside its
   bound at 4 and at 1 byte a vertex), the bell BFS (K = 64) the same way,
   both byte routes split by launch, and K5's pull at W = 16 on a
   synthetic plane with nothing visited, beside bell_hits_packed;
6. road-1024 at K = 16 (BASELINE.md config 4): every F and the winner
   equal scipy's;
7. road-1024 at K = 300 through the sub-batch split (W = 8 and W = 2):
   kernel path equals plain path;
8. grid_edges(2048, 2048) with corner sources: the active-row window
   engages (some chunk runs on fewer rows than n) and its results equal
   the plain path's without the window;
then the ``{"kernels": [...]}`` line and the final ``{"ok": true, ...}``.

Each CLI run of phases 3-5b is one path: the kernel launch counters are
zeroed just before it and read just after; each path must have launched
its route's kernels (pack_sources at its route's stride), and every
registered kernel must have launched on some path, and no byte path may
launch forest_or.  The kernel line has a row for each kernel (flag_pull's
from the densest pull of RMAT-20's low-K BFS, its bound the level's) and
for the byte use of push_or (K5's push), counted over the byte paths.
Each path, and phases 7 and 8, also print the launches per kernel
variant; the mxu paths must have launched tile_hits' pipe variant, the
ELL path more steady than stale levels, and the byte paths flag_pull's
instance of their width (the bits instance at K = 1).
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
# Dense int8 tensor-core rate (the same data sheet).
INT8_TENSOR_OPS_PER_S = 1979e12
# Random 32-byte L2 sector reads: the rate ell_hits' gather reached on an
# H100 at 700 W (PERF.md), the yardstick of the forest's frontier reads.
L2_SECTOR_BYTES_PER_S = 4.0e12

PKG = "parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch"
JAX_PKG = "parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu"
# Each path's own kernels (a CLI run per path).
PATH_KERNELS = {
    "stencil road-4096": ("pack_sources", "stencil_sweep", "level_apply"),
    "mxu rmat-14": ("pack_sources", "tile_hits", "level_apply"),
    "mxu road-512": ("pack_sources", "tile_hits", "push_or", "level_apply"),
    "lowk rmat-16": ("pack_sources", "flag_pull", "push_or", "level_apply"),
    "bitbell rmat-20": ("pack_sources", "forest_or", "push_or", "level_apply"),
    "ell rmat-20": ("ell_hits",),
    "bell rmat-20": ("pack_sources", "flag_pull", "level_apply"),
    "lowk rmat-20": ("pack_sources", "flag_pull", "push_or", "level_apply"),
}
# The paths whose planes are bytes: their pack runs at a stride of 8 lanes,
# the others' at 1 (the ELL route packs no planes), and they pull with
# flag_pull, never with forest_or.
BYTE_PATHS = ("lowk rmat-16", "bell rmat-20", "lowk rmat-20")
# Groups of the RMAT-20 paths checked against scipy (besides the winner).
SCIPY_GROUPS = 8
# Groups of RMAT-20's 64 that its low-K path runs (all checked against scipy).
LOWK_GROUPS = 4
# Each path's launches per kernel variant, as _run_path read them.
VARIANTS = {}


def _card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def _bound_ms(nbytes: float, ops: float, ops_per_s: float = INT32_OPS_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _time_ms(torch, fn, restore, reps=10, warm=2):
    """Median device time of one call of ``fn`` (CUDA events around the
    call alone; ``restore`` resets its in-place inputs between calls).
    A ~1 ms device sleep is queued before the first event, so the host
    has enqueued the call's launches before the device reaches them and
    the events measure the device, not the wrapper's host time (a call
    that reads the device back, as the plain versions do, still waits)."""
    times = []
    for i in range(warm + reps):
        restore()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
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
        assert a.shape == b.shape, (a.shape, b.shape)
        if a.numel():
            err = max(err, int((a.to(torch.int64) - b.to(torch.int64)).abs().max()))
    return err


def _words(torch, n, w, density, gen, dev, rows=None):
    """(n, w) random int32 words in a ``density`` share of the first
    ``rows`` rows (all rows when None), zero elsewhere."""
    x = torch.randint(-(2**31), 2**31, (n, w), dtype=torch.int32, device=dev,
                      generator=gen)
    keep = torch.rand((n, 1), device=dev, generator=gen) < density
    if rows is not None:
        keep[rows:] = False
    return torch.where(keep, x, 0)


def _sweep_bound(torch, frontier, n_offsets, residual_edges):
    """Bytes any sweep must move for this frontier: read it and write the
    hit plane (8W bytes a row), read the mask word of each row whose
    frontier is nonzero and the residual's two index arrays (8 bytes an
    edge); a few operations per offset and word, one per edge and word."""
    n, w = frontier.shape
    active_rows = int((frontier != 0).any(dim=1).sum())
    return _bound_ms(8 * n * w + 4 * active_rows + 8 * residual_edges,
                     n * w * n_offsets * 4 + residual_edges * w)


def _apply_bound(torch, hits, visited):
    """Bytes any level apply must move for these planes: read hits and
    write frontier (8W bytes a row), read visited where a hit word is
    nonzero and write it where something is new, and the per-query
    counters; two operations a word and 64 a new word (the popcount)."""
    n, w = hits.shape
    hit_words = int((hits != 0).sum())
    new_words = int(((hits & ~visited) != 0).sum())
    nbytes = 8 * n * w + 4 * hit_words + 4 * new_words + 32 * w * 40
    return _bound_ms(nbytes, 2 * n * w + 64 * new_words), hit_words, new_words


def _sweep_row(torch, frontier, mask_bits, offs, go, residual):
    """stencil_sweep with the residual edges against its plain version
    (the plain sweep, then the plain residual OR) on one frontier: the
    error, both times and the bound."""
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.ops import (
        bitbell, cuda_stencil,
    )

    top = 2**31 - 1
    h_k, h_p = torch.empty_like(frontier), torch.empty_like(frontier)
    cuda_stencil.stencil_sweep(frontier, mask_bits, offs, h_k, go, top, residual)
    cuda_stencil.stencil_sweep_plain(frontier, mask_bits, offs, h_p, go, top, residual)
    torch.cuda.synchronize()
    err = _max_abs_err(torch, [(h_k, h_p)])
    ms = _time_ms(torch, lambda: cuda_stencil.stencil_sweep(
        frontier, mask_bits, offs, h_k, go, top, residual), lambda: None)
    plain_ms = _time_ms(torch, lambda: cuda_stencil.stencil_sweep_plain(
        frontier, mask_bits, offs, h_p, go, top, residual), lambda: None, reps=3)
    # The same launch without the residual edges: what they add.
    no_residual_ms = _time_ms(torch, lambda: cuda_stencil.stencil_sweep(
        frontier, mask_bits, offs, h_k, go, top), lambda: None)
    edges = residual.count if residual is not None else 0
    bound, by = _sweep_bound(torch, frontier, len(offs), edges)
    n, w = frontier.shape
    vec16 = all(t.data_ptr() % 16 == 0 for t in (frontier, mask_bits, h_k))
    plan = cuda_stencil.sweep_plan(n, w, offs, vec16)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                no_residual_ms=no_residual_ms,
                variant=bitbell.plan_label(plan) + ("/res" if edges else ""),
                tile=plan.tile, smem_bytes=plan.smem_bytes, residual_edges=edges)


def _apply_row(torch, pristine, hits, switch=None, timed=True):
    """level_apply against its plain version on one carry and hit plane
    (each call on a fresh copy of ``pristine``): the error, both times
    and the bound.  ``switch`` = (count, row_limit, edge_limit): the
    switched apply, which lists the new frontier and decides the next
    direction; on a level ``pristine.ctrl[3]`` sent to the push it reads
    ``hits`` from the switch's plane and clears it (restored before each
    call).  Its control, state, worklist (as a set) and push plane are
    held against the plain epilogue's too."""
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.ops import (
        bitbell,
    )

    fields = ("visited", "frontier", "f", "levels", "reached", "counts", "ctrl")

    pushed = switch is not None and int(pristine.ctrl[3]) == bitbell.DIR_PUSH

    def fresh():
        c = bitbell.BitCarry(*(getattr(pristine, f).clone() for f in fields))
        if switch is not None:
            c.switch = bitbell.PushSwitch.new(*switch, hits.shape[1])
            if pushed:
                c.switch.hits.copy_(hits)
        return c

    def restore(c, h):
        for f in fields:
            getattr(c, f).copy_(getattr(pristine, f))
        if switch is not None:
            c.switch.state.zero_()
            if pushed:
                c.switch.hits.copy_(hits)

    c_k, c_p = fresh(), fresh()
    # A pushed level's pull plane is never read: an unwritten one.
    h_k, h_p = (torch.empty_like(hits), torch.empty_like(hits)) if pushed else (hits, hits)
    bitbell.bit_level_apply(c_k, h_k)
    bitbell.bit_level_apply_plain(c_p, h_p)
    torch.cuda.synchronize()
    pairs = [(getattr(c_k, f), getattr(c_p, f)) for f in fields]
    extra = {}
    if switch is not None:
        pairs.append((c_k.switch.hits, c_p.switch.hits))
        sk, sp = c_k.switch, c_p.switch
        length = int(sp.state[bitbell.SW_LISTED])
        whole = int(sp.state[bitbell.SW_ACTIVE_ROWS]) <= sp.capacity
        keep = [bitbell.SW_LISTED, bitbell.SW_ACTIVE_ROWS, bitbell.SW_ACTIVE_EDGES]
        pairs.append((sk.state[keep], sp.state[keep]))
        if whole:
            rows = sk.worklist[0, :length].long()
            deg = sk.count[rows].long()
            pairs += [(torch.sort(rows).values, sp.worklist[0, :length]),
                      (sk.worklist[1, :length], torch.cumsum(deg, 0) - deg),
                      (sk.state, sp.state)]
        extra = dict(pushed_level=pushed, direction=int(c_k.ctrl[3]), listed_rows=length,
                     active_rows=int(sp.state[bitbell.SW_ACTIVE_ROWS]),
                     active_edges=int(sp.state[bitbell.SW_ACTIVE_EDGES]),
                     list_whole=whole)
    err = _max_abs_err(torch, pairs)
    ms = plain_ms = None
    if timed:
        ms = _time_ms(torch, lambda: bitbell.bit_level_apply(c_k, h_k),
                      lambda: restore(c_k, h_k))
        plain_ms = _time_ms(torch, lambda: bitbell.bit_level_apply_plain(c_p, h_p),
                            lambda: restore(c_p, h_p), reps=3)
    (bound, by), hit_words, new_words = _apply_bound(torch, hits, pristine.visited)
    planes = (hits, c_k.visited, c_k.frontier)  # as the timed launches
    vec16 = all(t.data_ptr() % 16 == 0 for t in planes)
    plan = bitbell.apply_plan(hits.shape[1], vec16, switch is not None)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                variant=bitbell.plan_label(plan), hit_words=hit_words,
                new_words=new_words, **extra)


def _synthetic_carry(torch, n, w, gen, dev, rows=None):
    """A carry at level 7 with random visited (half the rows) and frontier
    (5%) planes and counters, and a hit plane with 30% nonzero rows."""
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.ops import (
        bitbell,
    )

    k = 32 * w
    frontier = _words(torch, n, w, 0.05, gen, dev, rows)
    visited = _words(torch, n, w, 0.5, gen, dev, rows)
    hits = _words(torch, n, w, 0.3, gen, dev, rows)
    carry = bitbell.BitCarry(
        visited=visited, frontier=frontier,
        f=torch.arange(k, dtype=torch.int64, device=dev) * 1000,
        levels=torch.full((k,), 3, dtype=torch.int32, device=dev),
        reached=torch.full((k,), 5, dtype=torch.int32, device=dev),
        counts=torch.zeros(k, dtype=torch.int32, device=dev),
        ctrl=torch.tensor([1, 7, 0, 0], dtype=torch.int32, device=dev),
    )
    return carry, hits


def _compare_kernels(torch, sg, w, seed, label):
    """Each kernel of the stencil route against its plain version on one
    graph's shapes."""
    dev = sg.device
    n = sg.n
    gen = torch.Generator(device=dev).manual_seed(seed)
    pristine, hits0 = _synthetic_carry(torch, n, w, gen, dev)
    frontier = pristine.frontier
    go = torch.tensor([1, 7, 0, 0], dtype=torch.int32, device=dev)
    out = {}

    # A: the masked-shift sweep with the residual edges in its launch.
    out["stencil_sweep"] = _sweep_row(torch, frontier, sg.mask_bits, sg.offsets, go,
                                      sg.residual)

    # C: the level apply with per-query counts.
    out["level_apply"] = _apply_row(torch, pristine, hits0)
    for name, row in out.items():
        print(f"compare {label} n={n} W={w} {name}: " + json.dumps(row))
        assert row["max_abs_err"] == 0, (label, name, row)
    return out


def _compare_apply(torch, n, rows, w, dev, seed, label, switch=None):
    """level_apply against its plain version at one route's plane shape
    (n rows, the first ``rows`` of them real vertices); with ``switch`` =
    (count, row_limit, edge_limit) also the switched apply on the same
    planes, as a pulled level and as a pushed one (what the switch
    epilogue adds, and what clearing the consumed hit words adds)."""
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.ops import (
        bitbell,
    )

    gen = torch.Generator(device=dev).manual_seed(seed)
    pristine, hits = _synthetic_carry(torch, n, w, gen, dev, rows)
    row = _apply_row(torch, pristine, hits)
    print(f"compare {label} n={n} W={w} level_apply: " + json.dumps(row))
    assert row["max_abs_err"] == 0, (label, row)
    if switch is not None:
        for direction in (bitbell.DIR_PULL, bitbell.DIR_PUSH):
            pristine.ctrl[3] = direction
            sw = _apply_row(torch, pristine, hits, switch)
            print(f"compare {label} n={n} W={w} level_apply switched: " + json.dumps(sw))
            assert sw["max_abs_err"] == 0, (label, sw)
        pristine.ctrl[3] = 0
    return row


def _real_level(torch, sg, padded, depth, label):
    """The sweep and the apply on the planes of one real level: the
    kernel-path StencilEngine runs the BFS to its middle level, then each
    kernel is held against its plain version on that carry and timed
    beside the bound of that input.  Returns the carry at that level."""
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.ops import (
        bitbell, stencil,
    )

    eng = stencil.StencilEngine(sg, level_chunk=stencil.AUTO_STENCIL_LEVEL_CHUNK)
    carry = eng._init_carry(eng._pad_queries(padded)[0])
    hits = torch.empty_like(carry.frontier)
    mid = depth // 2
    bitbell.bit_level_chunk(carry, lambda c: eng._step(c, 0, hits), mid)
    assert int(carry.ctrl[1]) == mid, (int(carry.ctrl[1]), mid)
    go = carry.ctrl.clone()
    row = {"stencil_sweep": _sweep_row(torch, carry.frontier, sg.mask_bits,
                                       sg.offsets, go, sg.residual)}
    # The level's whole hit plane (sweep + residual), as the engine builds it.
    stencil._expand_into(hits, carry.frontier, sg.mask_bits, sg, go, 2**31 - 1, False)
    row["level_apply"] = _apply_row(torch, carry, hits)
    n, w = carry.frontier.shape
    active = int((carry.frontier != 0).any(dim=1).sum())
    print(f"real level {label} level={mid} of {depth} n={n} W={w} "
          f"frontier_rows={active}: " + json.dumps(row))
    for name, r in row.items():
        assert r["max_abs_err"] == 0, (label, name, r)
    return carry


def _level_split(torch, sg, carry, levels, label):
    """One chunk of ``levels`` real levels from ``carry`` with CUDA events
    around every launch: device time of the sweep (its residual edges
    included) and the apply, and the gaps between launches; then the same
    chunk as the engine enqueues it, with one event pair around it."""
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.ops import (
        bitbell, cuda_stencil, stencil,
    )

    fields = ("visited", "frontier", "f", "levels", "reached", "counts", "ctrl")

    def fresh():
        return bitbell.BitCarry(*(getattr(carry, f).clone() for f in fields))

    top = 2**31 - 1
    c = fresh()
    hits = torch.empty_like(c.frontier)
    ev = [[torch.cuda.Event(enable_timing=True) for _ in range(3)] for _ in range(levels)]
    torch.cuda.synchronize()
    torch.cuda._sleep(2_000_000)
    for e in ev:
        e[0].record()
        cuda_stencil.stencil_sweep(c.frontier, sg.mask_bits, sg.offsets, hits, c.ctrl, top,
                                   sg.residual)
        e[1].record()
        bitbell.bit_level_apply(c, hits, top)
        e[2].record()
    torch.cuda.synchronize()
    split = {"sweep": 0.0, "apply": 0.0, "gaps": 0.0}
    for i, e in enumerate(ev):
        split["sweep"] += e[0].elapsed_time(e[1])
        split["apply"] += e[1].elapsed_time(e[2])
        if i + 1 < levels:
            split["gaps"] += e[2].elapsed_time(ev[i + 1][0])
    span = ev[0][0].elapsed_time(ev[-1][2])
    eng = stencil.StencilEngine(sg, level_chunk=stencil.AUTO_STENCIL_LEVEL_CHUNK)
    c2 = fresh()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(2_000_000)
    e0.record()
    for _ in range(levels):
        eng._step(c2, 0, hits)
    e1.record()
    e1.synchronize()
    assert torch.equal(c.f, c2.f) and torch.equal(c.ctrl, c2.ctrl)
    print(f"level split {label} from level {int(carry.ctrl[1])}: " + json.dumps(dict(
        levels=levels, ms_per_level={k: v / levels for k, v in split.items()},
        evented_span_ms=span, evented_ms_per_level=span / levels,
        engine_chunk_ms=e0.elapsed_time(e1),
        engine_ms_per_level=e0.elapsed_time(e1) / levels,
    )))


def _compare_mxu(torch, mg, w, seed, label):
    """tile_hits and push_or against their plain versions on one graph's
    tiles; the bf16 torch.bmm of the same tile products as tile_hits'
    library yardstick."""
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.ops import (
        bitbell, cuda_mxu, mxu,
    )

    dev = mg.device
    n, k = mg.n_pad, 32 * w
    gen = torch.Generator(device=dev).manual_seed(seed)

    def words(density):
        return _words(torch, n, w, density, gen, dev, mg.n)

    out = {}
    # K7: a dense frontier (a matmul level).
    frontier = words(0.3)
    mm = torch.tensor([1, 7, 0, bitbell.DIR_MATMUL], dtype=torch.int32, device=dev)
    tiles = (mg.tiles, mg.tile_row, mg.tile_col, mg.row_ptr)
    h_k, h_p = torch.empty_like(frontier), torch.empty_like(frontier)
    cuda_mxu.tile_matmul_hits(*tiles, frontier, h_k, mm)
    cuda_mxu.tile_matmul_hits_plain(*tiles, frontier, h_p, mm)
    torch.cuda.synchronize()
    err = _max_abs_err(torch, [(h_k, h_p)])
    ms = _time_ms(torch, lambda: cuda_mxu.tile_matmul_hits(*tiles, frontier, h_k, mm),
                  lambda: None)
    plain_ms = _time_ms(torch, lambda: cuda_mxu.tile_matmul_hits_plain(
        *tiles, frontier, h_p, mm), lambda: None, reps=3)
    lhs = mg.tiles_bf16
    fr = bitbell.unpack_byte_planes(frontier).view(mg.ntr, mg.tile, k)
    rhs = fr[mg.tile_col.long()].to(torch.bfloat16)
    library_ms = _time_ms(torch, lambda: torch.bmm(lhs, rhs), lambda: None, reps=5)
    del rhs, fr
    t2 = mg.tile * mg.tile
    bound, by = _bound_ms(
        mg.nt * t2 + 4 * mg.nt + 4 * (mg.ntr + 1) + 8 * n * w,
        2 * mg.nt * t2 * k, INT8_TENSOR_OPS_PER_S,
    )
    plan = cuda_mxu.tile_plan(mg.ntr, mg.nt, mg.tile, w, frontier.data_ptr() % 16 == 0)
    out["tile_hits"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                            bound_by=by, library_ms=library_ms, variant=plan.label,
                            units=plan.units, smem_bytes=plan.smem_bytes)

    # K3: a thin frontier (about n / 64 rows, the auto switch), listed by
    # the plain switch epilogue under the mxu engine's push edge budget
    # (which sizes the push's grid as on the route).
    frontier = words(1 / 64)
    switch = bitbell.PushSwitch.new(mg.count, n, mxu.MxuEngine(mg).push_budget, w)
    push = torch.tensor([1, 7, 0, 0], dtype=torch.int32, device=dev)
    bitbell.switch_record(switch, frontier, push)
    out["push_or"] = _push_row(torch, frontier, mg.start, mg.vals, switch, push)
    for name, row in out.items():
        print(f"compare {label} n_pad={n} T={mg.tile} nt={mg.nt} W={w} {name}: "
              + json.dumps(row))
        assert row["max_abs_err"] == 0, (label, name, row)
    return out


def _push_row(torch, frontier, start, vals, switch, ctrl, timed=True):
    """push_or against its plain version on one listed frontier (both into
    a zeroed hit plane): the error, both times, the bound, and the launch
    floor (the same launch gated off by ctrl[3] = pull); ``timed`` False:
    the error and the counts only."""
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.ops import (
        bitbell,
    )

    assert int(ctrl[3]) == bitbell.DIR_PUSH
    p_k, p_p = torch.zeros_like(frontier), torch.zeros_like(frontier)
    bitbell.sparse_hits_or(frontier, start, vals, p_k, ctrl, switch)
    bitbell.sparse_hits_or_plain(frontier, start, vals, p_p, ctrl, switch)
    torch.cuda.synchronize()
    err = _max_abs_err(torch, [(p_k, p_p)])
    ms = plain_ms = floor_ms = None
    if timed:
        ms = _time_ms(torch, lambda: bitbell.sparse_hits_or(
            frontier, start, vals, p_k, ctrl, switch), p_k.zero_)
        plain_ms = _time_ms(torch, lambda: bitbell.sparse_hits_or_plain(
            frontier, start, vals, p_p, ctrl, switch), p_p.zero_, reps=3)
        pull = ctrl.clone()
        pull[3] = bitbell.DIR_PULL
        floor_ms = _time_ms(torch, lambda: bitbell.sparse_hits_or(
            frontier, start, vals, p_k, pull, switch), lambda: None)
    w = frontier.shape[1]
    listed = int(switch.state[bitbell.SW_LISTED])
    edges = int(switch.state[bitbell.SW_LISTED_EDGES])
    reached = int((p_p != 0).any(dim=1).sum())
    degrees = switch.count[switch.worklist[0, :listed].long()]
    # The worklist (8 bytes an entry), each listed row's words and CSR
    # start, its neighbours, and the hit words reached; an OR a word an edge.
    bound, by = _bound_ms(8 * listed + (4 * w + 4) * listed + 4 * edges + 4 * w * reached,
                          edges * w)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                library_ms=None, floor_ms=floor_ms, listed_rows=listed, edges=edges,
                reached_rows=reached,
                max_degree=int(degrees.max()) if listed else 0)


def _compare_forest_ell(torch, bg, eg, k, seed, label):
    """forest_or and ell_hits against their plain versions at K queries
    (W = ceil(K / 32) words) on one graph's forest and ELL slab; the
    two-call torch expression of the ELL gather as ell_hits' library
    yardstick (torch has no OR reduction: forest_or has none)."""
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.ops import (
        bfs, cuda_bfs,
    )

    dev = bg.device
    n, w = bg.n, -(-k // 32)
    gen = torch.Generator(device=dev).manual_seed(seed)
    out = {}

    # K1: a dense pull level, with a third of the vertices in the frontier.
    x = torch.randint(-(2**31), 2**31, (n, w), dtype=torch.int32, device=dev, generator=gen)
    frontier = torch.where(torch.rand((n, 1), device=dev, generator=gen) < 0.3, x, 0)
    out["forest_or"] = _forest_row(torch, bg, frontier)
    del frontier, x

    # K8: one level of the distance loop, every query at level 2 with
    # distances 0..3 spread over half the vertices.
    dist = torch.randint(0, 4, (k, n), dtype=torch.int32, device=dev, generator=gen)
    dist = torch.where(torch.rand((k, n), device=dev, generator=gen) < 0.5, dist, -1)
    pristine = bfs.DistCarry(
        dist=dist,
        level=torch.full((k,), 2, dtype=torch.int32, device=dev),
        updated=torch.ones(k, dtype=torch.int32, device=dev),
        stop=torch.full((k,), 3, dtype=torch.int32, device=dev),
        found=torch.zeros(k, dtype=torch.int32, device=dev),
        ctrl=torch.tensor([1, 0, 0, 0], dtype=torch.int32, device=dev),
    )
    fields = ("dist", "level", "updated", "stop", "found", "ctrl")
    plane_fields = ("frontier", "visited", "hits", "aux")

    def fresh():
        return bfs.DistCarry(*(getattr(pristine, f).clone() for f in fields))

    def restore(c):
        for f in fields:
            getattr(c, f).copy_(getattr(pristine, f))
        c.touch()  # dist was rewritten: the next level is a stale one

    # Stale: the planes are rebuilt from dist, then the level runs.
    c_k, c_p = fresh(), fresh()
    cuda_bfs.ell_level(eg, c_k)
    cuda_bfs.ell_level_plain(eg, c_p)
    torch.cuda.synchronize()
    err = _max_abs_err(torch, [(getattr(c_k, f), getattr(c_p, f)) for f in fields])
    ms = _time_ms(torch, lambda: cuda_bfs.ell_level(eg, c_k), lambda: restore(c_k))
    plain_ms = _time_ms(torch, lambda: cuda_bfs.ell_level_plain(eg, c_p),
                        lambda: restore(c_p), reps=3)
    pad_to = max(128, -(-(n + 1) // 128) * 128)
    flags = torch.zeros((k, pad_to), dtype=torch.int8, device=dev)
    flags[:, :n] = (dist == 2).to(torch.int8)
    cols = eg.cols.long()
    library_ms = _time_ms(torch, lambda: torch.amax(flags[:, cols], dim=1), lambda: None, reps=3)
    del flags, cols
    slots = eg.width * eg.num_vrows
    bound, by = _bound_ms(4 * slots + 4 * eg.num_vrows + 8 * k * n, slots * w + k * n)
    out["ell_hits"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                           bound_by=by, library_ms=library_ms, vrows=eg.num_vrows,
                           library="torch.amax(frontier[:, cols], dim=1), two calls")

    # Steady: the same level on carried planes (packed once, by the plain
    # pack), against the steady function's own plain version; dist is
    # written where a label is new and never read.
    planes0 = cuda_bfs.ell_planes(eg, c_p)
    restore(c_p)
    cuda_bfs.ell_pack_plain(c_p, planes0)
    snap = {f: getattr(planes0, f).clone() for f in plane_fields}

    def restore_steady(c):
        restore(c)
        planes = cuda_bfs.ell_planes(eg, c)
        for f in plane_fields:
            getattr(planes, f).copy_(snap[f])
        planes.valid = True

    restore_steady(c_k)
    restore_steady(c_p)
    cuda_bfs.ell_level(eg, c_k)
    cuda_bfs.ell_steady_plain(eg, c_p, c_p.planes)
    torch.cuda.synchronize()
    pairs = [(getattr(c_k, f), getattr(c_p, f)) for f in fields]
    pairs += [(getattr(c_k.planes, f), getattr(c_p.planes, f)) for f in plane_fields]
    err = _max_abs_err(torch, pairs)
    ms = _time_ms(torch, lambda: cuda_bfs.ell_level(eg, c_k), lambda: restore_steady(c_k))
    plain_ms = _time_ms(torch, lambda: cuda_bfs.ell_steady_plain(eg, c_p, c_p.planes),
                        lambda: restore_steady(c_p), reps=3)
    stats = _ell_gather_stats(torch, eg, snap["visited"], snap["aux"][:w])
    new_labels = int((c_p.dist != pristine.dist).sum())
    bound, by = _bound_ms(
        4 * eg.width * stats["live_rows"] + 4 * eg.num_vrows + 16 * n * w + 4 * new_labels,
        stats["live_slots"] * w + n * w,
    )
    # The steady level gathers the same dist == 2 frontier: its library
    # yardstick is the stale row's call.
    out["ell_hits steady"] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
        library_ms=library_ms, library="torch.amax(frontier[:, cols], dim=1), two calls",
        new_labels=new_labels,
        gather_l2_floor_bytes=32 * stats["live_slots"], **stats)
    del c_p, c_k, snap, planes0
    for name, row in out.items():
        print(f"compare {label} n={n} K={k} W={w} {name}: " + json.dumps(row))
        assert row["max_abs_err"] == 0, (label, name, row)
    return out


def _forest_row(torch, bg, frontier):
    """forest_or against its plain version on one pull frontier: the
    error, both times, the byte bound and the L2 floor (one 32-byte sector
    per non-sentinel slot; the live slots, those whose source row is
    nonzero, are all that a design reading only nonzero rows would
    fetch)."""
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.ops import (
        bitbell, cuda_bell,
    )

    dev, (n, w) = frontier.device, frontier.shape
    pull = torch.tensor([1, 7, 0, bitbell.DIR_PULL], dtype=torch.int32, device=dev)
    scratch = cuda_bell.forest_scratch(bg, w, dev)
    h_k, h_p = torch.full_like(frontier, 7), torch.empty_like(frontier)
    cuda_bell.forest_or(frontier, bg, h_k, pull, scratch=scratch)
    cuda_bell.forest_or_plain(frontier, bg, h_p, pull)
    torch.cuda.synchronize()
    err = _max_abs_err(torch, [(h_k, h_p)])
    ms = _time_ms(torch, lambda: cuda_bell.forest_or(
        frontier, bg, h_k, pull, scratch=scratch), lambda: None)
    plain_ms = _time_ms(torch, lambda: cuda_bell.forest_or_plain(
        frontier, bg, h_p, pull), lambda: None, reps=3)
    slots = sum(int(f.numel()) for f in bg.level_cols)
    bound, by = _bound_ms(4 * slots + 4 * n + 8 * n * w, slots * w)
    live = torch.cat([(frontier != 0).any(dim=1), frontier.new_zeros(1, dtype=torch.bool)])
    cols0 = bg.level_cols[0].long()
    real0 = int((cols0 < n).sum())
    real = real0 + sum(
        int((f < size).sum()) for f, size in zip(bg.level_cols[1:], bg.level_sizes))
    live_slots = int(live[cols0].sum()) + real - real0
    del cols0
    vec16 = all(t.data_ptr() % 16 == 0 for t in (frontier, scratch, h_k))
    return dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
        library_ms=None, l2_floor_ms=32 * real / L2_SECTOR_BYTES_PER_S * 1e3,
        variant=cuda_bell.forest_plan(w, vec16).label, slots=slots, real_slots=real,
        live_slots=live_slots, frontier_rows=int(live.sum()),
        forest_levels=len(bg.level_sizes),
    )


def _bitbell_hybrid(torch, bg, padded, label):
    """The bitbell route's BFS a level at a time (:func:`_hybrid_levels`,
    forest_or held against its plain version and timed on each pull
    level, push_or on each push level), then its launch split."""
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.ops import (
        bitbell, cuda_bell,
    )

    top = 2**31 - 1
    eng = bitbell.BitBellEngine(bg, level_chunk=128)
    queries = eng._pad_queries(padded)[0]
    carry = eng._init_carry(queries)
    w = carry.frontier.shape[1]
    scratch = cuda_bell.forest_scratch(bg, w, carry.frontier.device)
    slot_budget = eng._slot_budget_for(w)
    expand = bitbell.bitbell_expand(bg, slot_budget)
    start, _, vals = bg.sparse
    directions, rows = _hybrid_levels(
        torch, carry, lambda c, h: expand(c, h, top, scratch), start, vals,
        lambda fr: _forest_row(torch, bg, fr), label,
    )
    for row in rows:
        print(f"hybrid level {label}: " + json.dumps(row))
    assert {bitbell.DIR_PUSH, bitbell.DIR_PULL} <= set(directions), directions

    def push(c, h):
        bitbell.sparse_hits_or(c.frontier, start, vals, c.switch.hits, c.ctrl, c.switch, top)

    def pull(c, h):
        cuda_bell.forest_or(c.frontier, bg, h, c.ctrl, top, slot_budget, scratch)

    _hybrid_split(torch, lambda: eng._init_carry(queries), push, pull,
                  lambda c: eng._chunk(c, len(directions)), len(directions), label)
    return rows


def _mxu_hybrid(torch, mg, eng, padded, label):
    """The mxu route's BFS a level at a time (:func:`_hybrid_levels`:
    push_or and the switched apply held on every level, timed on every
    eighth and at each change of direction), the device's direction
    sequence held against ``level_direction_trace``, then its launch
    split."""
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.ops import (
        bitbell, cuda_mxu,
    )

    top = 2**31 - 1
    queries = eng._pad_queries(padded)[0]
    directions, rows = _hybrid_levels(
        torch, eng._init_carry(queries), lambda c, h: eng._expand(c, h, top),
        mg.start, mg.vals, None, label, every=8,
    )
    device = ["push" if d == bitbell.DIR_PUSH else "matmul" for d in directions]
    trace = [s["direction"] for s in eng.level_direction_trace(padded)]
    assert device == trace, (_runs(device), _runs(trace))
    path = _write_detail(label.replace(" ", "_"), rows)
    timed = [r for r in rows if r["timed"]]
    pushes = [r["push_or"] for r in rows if "push_or" in r]

    def median(xs):
        xs = sorted(xs)
        return xs[len(xs) // 2] if xs else None

    print(f"hybrid levels {label}: " + json.dumps(dict(
        levels=len(rows), device_directions_equal_trace=True,
        push_levels=device.count("push"), apply_timed_levels=len(timed),
        push_or_ms_median=median([p["ms"] for p in pushes]),
        push_or_ms_max=max((p["ms"] for p in pushes), default=None),
        push_or_floor_ms_median=median([p["floor_ms"] for p in pushes]),
        push_or_plain_ms_median=median([p["plain_ms"] for p in pushes]),
        push_or_bound_ms_median=median([p["bound_ms"] for p in pushes]),
        push_listed_rows_max=max((p["listed_rows"] for p in pushes), default=0),
        apply_switched_ms_median=median([r["level_apply"]["ms"] for r in timed]),
        apply_unswitched_ms_median=median([r["unswitched_apply_ms"] for r in timed]),
        detail=path,
    )))
    tiles = (mg.tiles, mg.tile_row, mg.tile_col, mg.row_ptr)

    def push(c, h):
        bitbell.sparse_hits_or(c.frontier, mg.start, mg.vals, c.switch.hits, c.ctrl,
                               c.switch, top)

    def pull(c, h):
        cuda_mxu.tile_matmul_hits(*tiles, c.frontier, h, c.ctrl, top)

    _hybrid_split(torch, lambda: eng._init_carry(queries), push, pull,
                  lambda c: eng._chunk(c, len(rows), torch.empty_like(c.frontier)),
                  len(rows), label)
    return rows


def _switch_snapshot(torch, switch):
    """A copy of a switch state (its worklist and state words)."""
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.ops import (
        bitbell,
    )

    return bitbell.PushSwitch(switch.count, switch.row_limit, switch.edge_limit,
                              switch.worklist.clone(), switch.state.clone(),
                              switch.hits)


def _hybrid_levels(torch, carry, expand, start, vals, pull_row, label, every=1):
    """One BFS of a direction-switched route driven a level at a time from
    ``carry`` (``expand(carry, hits)`` then the apply, as a chunk enqueues
    them).  Before each level, ctrl[3] is the direction the level takes;
    on a push level push_or is held against its plain version on that
    level's list and timed, on a pull level ``pull_row(frontier)`` runs
    (None: not held here), and on every level the switched apply is held
    against its plain version and timed beside the same launch without
    the switch (on the same hits; the push's plane is zero after every
    level).  The apply is timed on every ``every``-th level and each level
    whose direction differs from the one before, held only on the others.
    Returns the directions and one row per level."""
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.ops import (
        bitbell,
    )

    sw = carry.switch
    limits = (sw.count, sw.row_limit, sw.edge_limit)
    hits = torch.zeros_like(carry.frontier)
    directions, rows = [], []
    while bitbell.level_go(carry.ctrl, 2**31 - 1):
        level = int(carry.ctrl[1]) + 1
        d = int(carry.ctrl[3])
        timed = (level - 1) % every == 0 or (directions and directions[-1] != d)
        directions.append(d)
        row = dict(level=level, direction="push" if d == bitbell.DIR_PUSH else "pull",
                   timed=bool(timed))
        if d == bitbell.DIR_PUSH:
            row["push_or"] = _push_row(torch, carry.frontier, start, vals,
                                       _switch_snapshot(torch, sw), carry.ctrl.clone())
            assert row["push_or"]["max_abs_err"] == 0, (label, level, row)
        elif pull_row is not None:
            row["pull"] = pull_row(carry.frontier)
            assert row["pull"]["max_abs_err"] == 0, (label, level, row)
        expand(carry, hits)
        level_hits = sw.hits.clone() if d == bitbell.DIR_PUSH else hits
        pristine = bitbell.BitCarry(carry.visited, carry.frontier, carry.f, carry.levels,
                                    carry.reached, carry.counts, carry.ctrl)
        row["level_apply"] = _apply_row(torch, pristine, level_hits, limits, timed)
        if timed:
            row["unswitched_apply_ms"] = _apply_row(torch, pristine, level_hits)["ms"]
        assert row["level_apply"]["max_abs_err"] == 0, (label, level, row)
        bitbell.bit_level_apply(carry, hits)
        assert not bool(sw.hits.any()), (label, level, "push plane not cleared")
        rows.append(row)
        assert level <= carry.frontier.shape[0], "the level loop did not stop"
    return directions, rows


def _hybrid_split(torch, make_carry, push, pull, chunk, levels, label):
    """A whole BFS of a direction-switched route (``levels`` levels) with
    CUDA events around each launch of each level — ``push(carry, hits)``
    (into the switch's plane), ``pull(carry, hits)``, the apply — and the
    gaps between them, all
    enqueued before one synchronise, as a chunk enqueues them; then the
    engine's own ``chunk(carry)`` timed with one event pair, and traced
    with torch.profiler for the device's busy share: the kernels' summed
    device time over that chunk's time (the device is idle when the
    chunk starts, so the pair spans the host's enqueue of it)."""
    from torch.profiler import ProfilerActivity, profile

    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.ops import (
        bitbell,
    )

    top = 2**31 - 1
    c = make_carry()
    hits = torch.zeros_like(c.frontier)
    names = ("push_or", "pull", "level_apply")
    ev = [[torch.cuda.Event(enable_timing=True) for _ in range(4)] for _ in range(levels)]
    torch.cuda.synchronize()
    torch.cuda._sleep(2_000_000)
    for e in ev:
        e[0].record()
        push(c, hits)
        e[1].record()
        pull(c, hits)
        e[2].record()
        bitbell.bit_level_apply(c, hits, top)
        e[3].record()
    torch.cuda.synchronize()
    assert not bitbell.level_go(c.ctrl, top), "the split did not reach convergence"
    per_level = []
    for i, e in enumerate(ev):
        t = {name: e[j].elapsed_time(e[j + 1]) for j, name in enumerate(names)}
        t["gap_after"] = e[3].elapsed_time(ev[i + 1][0]) if i + 1 < levels else 0.0
        per_level.append(t)
    totals = {k: sum(t[k] for t in per_level) for k in (*names, "gap_after")}
    span = ev[0][0].elapsed_time(ev[-1][3])
    # The engine's own chunk: one event pair, then under the profiler.
    c2 = make_carry()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    e0.record()
    chunk(c2)
    e1.record()
    e1.synchronize()
    assert torch.equal(c.f, c2.f) and torch.equal(c.ctrl[:2], c2.ctrl[:2])
    chunk_ms = e0.elapsed_time(e1)
    # Two traced chunks, the one with more device events kept: a trace can
    # miss a chunk's first launches.
    best = None
    for _ in range(2):
        c3 = make_carry()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            chunk(c3)
            torch.cuda.synchronize()
        seen, kernel_us, busy_us, first, last = {}, {}, 0.0, None, None
        for evt in prof.events():
            if evt.device_type != torch.autograd.DeviceType.CUDA:
                continue
            rng_ = evt.time_range
            busy_us += rng_.elapsed_us()
            first = rng_.start if first is None else min(first, rng_.start)
            last = rng_.end if last is None else max(last, rng_.end)
            name = evt.name.replace("(anonymous namespace)::", "").replace("void ", "")
            name = name.split("(")[0].split("<")[0].split("::")[-1] or evt.name[:40]
            seen[name] = seen.get(name, 0) + 1
            kernel_us[name] = kernel_us.get(name, 0.0) + rng_.elapsed_us()
        if best is None or sum(seen.values()) > sum(best[0].values()):
            best = (seen, kernel_us, busy_us, first, last)
    seen, kernel_us, busy_us, first, last = best
    if seen:
        busy = dict(source="torch.profiler", busy_ms=busy_us / 1e3, chunk_ms=chunk_ms,
                    busy_share=busy_us / 1e3 / chunk_ms,
                    device_span_ms=(last - first) / 1e3, kernels=seen,
                    kernel_ms={k: v / 1e3 for k, v in kernel_us.items()})
    else:  # no device activity in either trace: the events of the split
        busy = dict(source="cuda events", busy_ms=sum(totals[k] for k in names),
                    chunk_ms=span, busy_share=sum(totals[k] for k in names) / span)
    per_level = [{k: round(v, 5) for k, v in t.items()} for t in per_level]
    print(f"hybrid split {label}: " + json.dumps(dict(
        levels=levels, ms_total=totals,
        ms_per_level={k: v / levels for k, v in totals.items()},
        evented_span_ms=span, engine_chunk_ms=chunk_ms,
        engine_ms_per_level=chunk_ms / levels, busy=busy,
        per_level=per_level if levels <= 16 else _write_detail(
            "split_" + label.replace(" ", "_"), per_level),
    )))
    return busy


def _wrapper_host_us(torch, fn, reps=500):
    """Host time of one call of a kernel wrapper ``fn`` whose launches are
    gated off on the device (so the device never holds the host back):
    its checks, plan, ctypes call and the launches themselves."""
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    return us


def _host_dispatch_us(torch, dev):
    """Host time to enqueue one small torch op on the card (a compare on a
    1,024-element tensor), the unit the old switch chain paid nine of a
    level."""
    x = torch.zeros(1024, dtype=torch.int32, device=dev)
    for _ in range(200):
        x.ne(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(2000):
        x.ne(0)
    us = (time.perf_counter() - t0) / 2000 * 1e6
    torch.cuda.synchronize()
    return us


# Where per-level rows too long for the output go (--detail-dir).
DETAIL_DIR = "build/chip_smoke"


def _write_detail(name, rows):
    """Per-level rows too long for the output, as JSON under DETAIL_DIR."""
    os.makedirs(DETAIL_DIR, exist_ok=True)
    path = os.path.join(DETAIL_DIR, f"chip_smoke_{name}.json")
    with open(path, "w") as fh:
        json.dump(rows, fh)
    return path


def _ell_gather_stats(torch, eg, visited, mask):
    """What the ELL gather must touch for these planes: the virtual rows
    whose owner some running query has not reached (the others it skips)
    and their non-sentinel slots."""
    n = eg.n
    live = ((~visited & mask) != 0).any(dim=1)
    live = torch.cat([live, live.new_zeros(1)])  # the sentinel owner n
    rows = live[eg.vrow_vertex.long()]
    owned = int((eg.vrow_vertex < n).sum())
    live_rows = int(rows.sum())
    live_slots = int((eg.cols[:, rows] < n).sum())
    return dict(owned_rows=owned, live_rows=live_rows, skipped_rows=owned - live_rows,
                live_slots=live_slots)


def _ell_level_split(torch, eg, padded, label):
    """The ELL route's real levels for one batch, with CUDA events around
    each launch of each level (pack on the first, stale, level; gather;
    apply), the rows the gather skipped and the labels the apply wrote."""
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.ops import (
        bfs, bitbell, cuda_bfs, engine,
    )

    dev = eg.device
    carry = bfs.distance_carry_init(eg.n, padded, eg.n_pad, dev)
    bfs.arm_chunk(carry, None, None)
    w = -(-carry.dist.shape[0] // 32)
    phases = (("pack", cuda_bfs.PHASE_PACK), ("gather", cuda_bfs.PHASE_GATHER),
              ("apply", cuda_bfs.PHASE_APPLY))
    levels = []
    while int(carry.ctrl[0]):
        row = {}
        for name, bit in phases:
            if name == "pack" and levels:
                continue  # the planes are carried from here on
            if name == "gather":
                planes = carry.planes
                row.update(_ell_gather_stats(torch, eg, planes.visited, planes.aux[:w]))
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            torch.cuda._sleep(2_000_000)
            e0.record()
            cuda_bfs.ell_level(eg, carry, phases=bit)
            e1.record()
            e1.synchronize()
            row[f"{name}_ms"] = e0.elapsed_time(e1)
        row["new_labels"] = int(bitbell.unpack_counts(carry.planes.frontier).sum())
        levels.append(row)
        assert len(levels) <= eg.n, "the level loop did not stop"
    want = engine.Engine(eg, level_chunk=128).f_values(padded)
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.ops.objective import (
        f_of_u,
    )
    assert torch.equal(f_of_u(carry.dist), want)
    print(f"ell level split {label}: " + json.dumps(dict(
        levels=len(levels), per_level=levels,
        total_ms={k: sum(r.get(k, 0.0) for r in levels)
                  for k in ("pack_ms", "gather_ms", "apply_ms")},
    )))


def _host_ms(torch, fn, reps=5):
    """Median host-clock time of ``fn`` up to a synchronise after it."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    times.sort()
    return times[len(times) // 2]


# Each route's pack_sources row (_pack_check), by path.
PACK_ROWS = {}


def _pack_check(torch, eng, n, padded, label):
    """pack_sources against its plain version on one route's batch as its
    engine pads it (stride 1 for bit planes, 8 for byte planes): the
    error, both times, the bound, and the host time of a batch start's
    whole pack (upload, zeroing, launch) against the plain pack."""
    import numpy as np

    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.ops import (
        bitbell,
    )

    queries = eng._pad_queries(padded)[0]
    stride = eng.lane_stride
    dev = eng.device
    q = torch.from_numpy(np.ascontiguousarray(queries, dtype=np.int32)).to(dev)
    k, s = q.shape
    w = max(1, -(-k * stride // 32))

    def buffers():
        return (torch.zeros((n, w), dtype=torch.int32, device=dev),
                torch.zeros(32 * w, dtype=torch.int32, device=dev))

    (p_k, c_k), (p_p, c_p) = buffers(), buffers()
    bitbell.pack_sources(q, n, p_k, c_k, stride)
    bitbell.pack_sources_plain(q, n, p_p, c_p, stride)
    torch.cuda.synchronize()
    err = _max_abs_err(torch, [(p_k, p_p), (c_k, c_p)])
    ms = _time_ms(torch, lambda: bitbell.pack_sources(q, n, p_k, c_k, stride),
                  lambda: (p_k.zero_(), c_k.zero_()))
    plain_ms = _time_ms(torch, lambda: bitbell.pack_sources_plain(q, n, p_p, c_p, stride),
                        lambda: (p_p.zero_(), c_p.zero_()), reps=3)
    valid = int(((q >= 0) & (q < n)).sum())
    touched = int((p_p != 0).sum())
    # The queries read once, the words the sources reach and the counts
    # written once; an atomic OR a source.
    bound, by = _bound_ms(4 * k * s + 4 * touched + 4 * 32 * w, valid)
    row = dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
        library_ms=None, K=k, S=s, lane_stride=stride, W=w, valid_sources=valid,
        distinct_sources=int(c_p.sum()), words_set=touched,
        batch_start_pack_host_ms=_host_ms(
            torch, lambda: bitbell.pack_queries(n, queries, dev, stride)),
        batch_start_plain_pack_host_ms=_host_ms(
            torch, lambda: bitbell.pack_queries_plain(n, queries, dev, stride)),
    )
    print(f"compare {label} n={n} pack_sources: " + json.dumps(row))
    assert err == 0, (label, row)
    PACK_ROWS[label] = row
    return row


def _byte_forest_row(torch, bg, frontier, scratch, library):
    """forest_or over a byte plane's word view (bell_hits_packed) against
    the byte pull's plain version (amax over bytes) on one pull frontier:
    the error, both times, the bound, and the library call
    ``hits.index_reduce_(0, owner, frontier[neighbour], "amax")`` over the
    dedup CSR (``library`` = (owner, neighbour) int64 tensors, or None)."""
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.ops import (
        bell, bitbell,
    )

    dev, (n, kp) = frontier.device, frontier.shape
    w = kp // 4
    pull = torch.tensor([1, 7, 0, bitbell.DIR_PULL], dtype=torch.int32, device=dev)
    h_k, h_p = torch.full_like(frontier, 7), torch.empty_like(frontier)
    bell.bell_hits_packed(frontier, bg, h_k, pull, scratch=scratch)
    bell.bell_hits_packed_plain(frontier, bg, h_p, pull)
    torch.cuda.synchronize()
    err = _max_abs_err(torch, [(h_k, h_p)])
    ms = _time_ms(torch, lambda: bell.bell_hits_packed(frontier, bg, h_k, pull, scratch=scratch),
                  lambda: None)
    plain_ms = _time_ms(torch, lambda: bell.bell_hits_packed_plain(frontier, bg, h_p, pull),
                        lambda: None, reps=3)
    library_ms = None
    if library is not None:
        owner, nbr = library
        lib = torch.zeros_like(frontier)
        library_ms = _time_ms(torch, lambda: lib.index_reduce_(0, owner, frontier[nbr], "amax"),
                              lib.zero_, reps=3)
        assert torch.equal(lib, h_p), "the library yardstick computes another function"
        del lib
    slots = sum(int(f.numel()) for f in bg.level_cols)
    # cols (4 bytes a slot), final_slot, the frontier read and the hits
    # written once (Kp bytes a row each); an OR a word a slot.
    bound, by = _bound_ms(4 * slots + 4 * n + 2 * n * kp, slots * w)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                library_ms=library_ms, Kp=kp, W=w,
                frontier_rows=int((frontier != 0).any(dim=1).sum()))


def _csr_pairs(torch, bg):
    """(owner, neighbour) int64 of every dedup CSR edge: the library
    yardstick's indices."""
    _, count, vals = bg.sparse
    owner = torch.repeat_interleave(
        torch.arange(bg.n, device=count.device), count.long())
    return owner, vals.long()


def _byte_push_row(torch, bg, frontier, switch, ctrl, timed=True):
    """push_or over a byte plane's word view (sparse_hits_flags) against
    the byte push's plain version on one listed frontier (both into a
    zeroed plane): the error, both times, the bound, the launch floor (the
    launch gated off) and the library call ``hits.index_reduce_(0,
    neighbour, frontier[owner], "amax")`` over the listed rows' edges."""
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.ops import (
        bitbell, lowk,
    )

    assert int(ctrl[3]) == bitbell.DIR_PUSH
    n, kp = frontier.shape
    p_k, p_p = torch.zeros_like(frontier), torch.zeros_like(frontier)
    lowk.sparse_hits_flags(frontier, bg, p_k, ctrl, switch)
    lowk.sparse_hits_flags_plain(frontier, bg, p_p, ctrl, switch)
    torch.cuda.synchronize()
    err = _max_abs_err(torch, [(p_k, p_p)])
    listed = int(switch.state[bitbell.SW_LISTED])
    edges = int(switch.state[bitbell.SW_LISTED_EDGES])
    ms = plain_ms = floor_ms = library_ms = None
    if timed:
        ms = _time_ms(torch, lambda: lowk.sparse_hits_flags(frontier, bg, p_k, ctrl, switch),
                      p_k.zero_)
        plain_ms = _time_ms(torch, lambda: lowk.sparse_hits_flags_plain(
            frontier, bg, p_p, ctrl, switch), p_p.zero_, reps=3)
        gated = ctrl.clone()
        gated[3] = bitbell.DIR_PULL
        floor_ms = _time_ms(torch, lambda: lowk.sparse_hits_flags(
            frontier, bg, p_k, gated, switch), lambda: None)
        owner, nbr = bitbell.listed_edges(switch, bg.sparse[0], bg.sparse[2])
        lib = torch.zeros_like(frontier)
        library_ms = _time_ms(torch, lambda: lib.index_reduce_(0, nbr, frontier[owner], "amax"),
                              lib.zero_, reps=5)
        assert torch.equal(lib, p_p), "the library yardstick computes another function"
    reached = int((p_p != 0).any(dim=1).sum())
    # The worklist (8 bytes an entry), each listed row's Kp bytes and CSR
    # start, its neighbours (4 bytes an edge), the rows reached (Kp bytes);
    # an OR a word an edge.
    bound, by = _bound_ms(8 * listed + (kp + 4) * listed + 4 * edges + kp * reached,
                          edges * (kp // 4))
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                library_ms=library_ms, floor_ms=floor_ms, listed_rows=listed, edges=edges,
                reached_rows=reached, Kp=kp)


def _active_lanes(torch, kp, k, levels, ctrl):
    """flag_pull's active lanes as a (Kp,) bool: real lanes (q < k) whose
    counter says the query's frontier is not empty (every real lane when
    ``levels`` is None)."""
    lanes = torch.arange(kp, device=ctrl.device) < k
    if levels is not None:
        lanes &= levels[::8][:kp] == ctrl[1] + 1
    return lanes


def _flag_pull_row(torch, bg, frontier, visited, k, levels, ctrl, scratch, library):
    """flag_pull (K5's pull, csrc/flag_pull.cu) against its plain version
    on one pull level: the error, both times, the library call
    ``hits.index_reduce_(0, owner, frontier[neighbour], "amax") &=
    ~visited`` over the dedup CSR (``library`` = (owner, neighbour)
    int64 tensors, or None), and two bounds: the whole function's (every
    slot's cols, final_slot, the frontier and visited read and the hits
    written once) and the level's (only the cols of the live rows, whose
    owner has an active lane it has not visited, and the three planes),
    with the L2 sector floor of the frontier rows the kernel must gather
    (level-0 slots of live rows whose source is in the frontier)."""
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.ops import (
        cuda_flag_pull as cfp,
    )

    n, kp = frontier.shape
    w = kp // 4

    def kernel():
        cfp.flag_pull(frontier, visited, bg, h_k, ctrl, k, scratch=scratch, levels=levels)

    h_k, h_p = torch.full_like(frontier, 7), torch.full_like(frontier, 7)
    kernel()
    cfp.flag_pull_plain(frontier, visited, bg, h_p, ctrl, k)
    torch.cuda.synchronize()
    err = _max_abs_err(torch, [(h_k, h_p)])
    ms = _time_ms(torch, kernel, lambda: None)
    plain_ms = _time_ms(torch, lambda: cfp.flag_pull_plain(frontier, visited, bg, h_p, ctrl, k),
                        lambda: None, reps=3)
    library_ms = None
    if library is not None:
        owner, nbr = library
        lib, unvisited = torch.zeros_like(frontier), ~visited
        library_ms = _time_ms(
            torch, lambda: lib.index_reduce_(0, owner, frontier[nbr], "amax").bitwise_and_(unvisited),
            lib.zero_, reps=3)
        assert torch.equal(lib, h_p), "the library yardstick computes another function"
        del lib, unvisited
    # Live rows: their owner has an active lane it has not visited.
    lanes = _active_lanes(torch, kp, k, levels, ctrl)
    vlive = ((visited == 0) & lanes[None, :]).any(dim=1)
    live = vlive[bg.row_owner(frontier.device).long()]
    widths = torch.cat([torch.full((r_b,), w_b, dtype=torch.int64, device=frontier.device)
                        for shapes in bg.level_shapes for r_b, w_b in shapes if r_b])
    slots = int(widths.sum())
    live_slots = int(widths[live].sum())
    size0 = bg.level_sizes[0]
    in_frontier = torch.cat([(frontier != 0).any(dim=1), live.new_zeros(1)])
    gathered = torch.repeat_interleave(live[:size0], widths[:size0]) & in_frontier[
        bg.level_cols[0].long()]
    sectors = int(gathered.sum()) * -(-kp // 32)
    del vlive, in_frontier, gathered
    function_bound, function_by = _bound_ms(4 * slots + 4 * n + 3 * n * kp, slots * w)
    level_bound, level_by = _bound_ms(4 * live_slots + 3 * n * kp, live_slots * w)
    plan = cfp.flag_pull_plan(w, n, k, all(t.data_ptr() % 16 == 0 for t in (
        frontier, visited, h_k, scratch.v_cat)))
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=level_bound,
                bound_by=level_by, function_bound_ms=function_bound,
                function_bound_by=function_by, l2_floor_ms=sectors * 32 / L2_SECTOR_BYTES_PER_S * 1e3,
                library_ms=library_ms, variant=plan.label, Kp=kp, W=w, k=k,
                active_lanes=int(lanes.sum()), frontier_rows=int((frontier != 0).any(dim=1).sum()),
                live_rows=int(live.sum()), rows=int(live.numel()), live_slots=live_slots,
                slots=slots, gathered_sectors=sectors)


def _byte_levels(torch, bg, padded, label, library, bell_route=False):
    """A byte route's BFS a level at a time (LowKEngine, or BellEngine
    with ``bell_route``): the kernel engine's carry and the plain engine's
    advanced in lockstep and equal before every level and at the end; on
    each pull level flag_pull held against its plain version with the
    carry's visited plane and counters and timed (:func:`_flag_pull_row`)
    beside bell_hits_packed (forest_or on the word view) on the same
    frontier (:func:`_byte_forest_row`); on each push level the
    byte push (:func:`_byte_push_row`); the apply held and timed (the
    switched one beside the same launch without the switch on the low-K
    route).  Returns one row a level."""
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.ops import (
        bell, bitbell, cuda_bell, cuda_flag_pull, lowk,
    )

    top = 2**31 - 1
    cls = bell.BellEngine if bell_route else lowk.LowKEngine
    fast = cls(bg, level_chunk=128)
    slow = cls(bg, level_chunk=128, plain=True)
    queries = fast._pad_queries(padded)[0]
    a, b = fast._init_carry(queries), slow._init_carry(queries)
    w = a.frontier.shape[1]
    scratch = cuda_flag_pull.flag_pull_scratch(bg, w, a.frontier.device)
    forest = cuda_bell.forest_scratch(bg, w, a.frontier.device)
    expand = fast._expand(w)
    hits = torch.zeros_like(a.frontier)
    sw = a.switch
    limits = None if sw is None else (sw.count, sw.row_limit, sw.edge_limit)
    fields = ("visited", "frontier", "f", "levels", "reached", "ctrl")
    u8 = torch.uint8

    def same():
        pairs = [(getattr(a, f), getattr(b, f)) for f in fields]
        if sw is not None:
            pairs += [(a.switch.state[:4], b.switch.state[:4]), (a.switch.hits, b.switch.hits)]
        return _max_abs_err(torch, pairs)

    rows = []
    while bitbell.level_go(b.ctrl, top):
        assert same() == 0, (label, len(rows), "kernel and plain engines differ")
        level, d = int(a.ctrl[1]) + 1, int(a.ctrl[3])
        row = dict(level=level, direction="push" if d == bitbell.DIR_PUSH else "pull")
        fr = a.frontier.view(u8)
        if d == bitbell.DIR_PUSH:
            row["push_or:bytes"] = _byte_push_row(torch, bg, fr, _switch_snapshot(torch, sw),
                                                  a.ctrl.clone())
            assert row["push_or:bytes"]["max_abs_err"] == 0, (label, row)
        else:
            row["flag_pull"] = _flag_pull_row(torch, bg, fr, a.visited.view(u8), a.k, a.levels,
                                              a.ctrl.clone(), scratch, library)
            assert row["flag_pull"]["max_abs_err"] == 0, (label, row)
            row["forest_or:bytes"] = _byte_forest_row(torch, bg, fr, forest, None)
            assert row["forest_or:bytes"]["max_abs_err"] == 0, (label, row)
        expand(a, hits, top, scratch)
        level_hits = sw.hits.clone() if d == bitbell.DIR_PUSH else hits
        pristine = bitbell.BitCarry(a.visited, a.frontier, a.f, a.levels, a.reached,
                                    a.counts, a.ctrl)
        row["level_apply"] = _apply_row(torch, pristine, level_hits, limits)
        if limits is not None:
            row["unswitched_apply_ms"] = _apply_row(torch, pristine, level_hits)["ms"]
        assert row["level_apply"]["max_abs_err"] == 0, (label, row)
        bitbell.bit_level_apply(a, hits)
        slow._chunk(b, 1)
        rows.append(row)
        assert level <= bg.n, "the level loop did not stop"
    assert same() == 0, (label, "kernel and plain engines differ at the end")
    return rows


def _lowk_split(torch, eng, bg, padded, levels, label):
    """A byte-plane route's whole BFS split by launch (:func:`_hybrid_split`):
    the byte push (a no-op on a pull-only carry), the byte pull
    (flag_pull) and the apply, then the engine's chunk timed and traced."""
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.ops import (
        cuda_flag_pull, lowk,
    )

    top = 2**31 - 1
    queries = eng._pad_queries(padded)[0]
    c0 = eng._init_carry(queries)
    scratch = cuda_flag_pull.flag_pull_scratch(bg, c0.frontier.shape[1], c0.frontier.device)
    pull_level = lowk.flag_pull_expand(bg)
    u8 = torch.uint8

    def push(c, h):
        if c.switch is not None:
            lowk.sparse_hits_flags(c.frontier.view(u8), bg, c.switch.hits.view(u8), c.ctrl,
                                   c.switch, top)

    def pull(c, h):
        pull_level(c, h, top, scratch)

    return _hybrid_split(torch, lambda: eng._init_carry(queries), push, pull,
                         lambda c: eng._chunk(c, levels), levels, label)


def _summarise_levels(rows, label):
    """One line of a level-by-level drive: directions, and the byte
    kernels' numbers level by level; the rows themselves go to a detail
    file."""
    path = _write_detail(label.replace(" ", "_"), rows)

    def pick(key, field):
        return [r[key][field] for r in rows if key in r]

    print(f"byte levels {label}: " + json.dumps(dict(
        levels=len(rows), directions=_runs([r["direction"] for r in rows]),
        every_level_equal_to_plain_engine=True,
        flag_pull_ms=pick("flag_pull", "ms"),
        flag_pull_level_bound_ms=pick("flag_pull", "bound_ms"),
        flag_pull_function_bound_ms=pick("flag_pull", "function_bound_ms"),
        flag_pull_l2_floor_ms=pick("flag_pull", "l2_floor_ms"),
        flag_pull_library_ms=pick("flag_pull", "library_ms"),
        flag_pull_plain_ms=pick("flag_pull", "plain_ms"),
        flag_pull_live_rows=pick("flag_pull", "live_rows"),
        flag_pull_frontier_rows=pick("flag_pull", "frontier_rows"),
        flag_pull_variant=pick("flag_pull", "variant"),
        word_view_pull_ms=pick("forest_or:bytes", "ms"),
        push_or_bytes_ms=pick("push_or:bytes", "ms"),
        push_or_bytes_floor_ms=pick("push_or:bytes", "floor_ms"),
        push_or_bytes_library_ms=pick("push_or:bytes", "library_ms"),
        apply_ms=[r["level_apply"]["ms"] for r in rows],
        apply_unswitched_ms=[r.get("unswitched_apply_ms") for r in rows],
        detail=path,
    )))


def _apply_at_k1(torch, rows, n, label):
    """The apply of a K = 1 low-K BFS on its level with the most new
    vertices, against its bound at the port's 4-byte stride (one word a
    vertex) and at JAX's 1-byte stride (one byte a vertex): the four plane
    streams, the visited reads under nonzero hits and the writes of what
    is new, at 4 or 1 bytes each."""
    row = max(rows, key=lambda r: r["level_apply"]["new_words"])
    ap = row["level_apply"]
    hit, new = ap["hit_words"], ap["new_words"]
    out = dict(
        level=row["level"], direction=row["direction"], ms=ap["ms"],
        unswitched_ms=row["unswitched_apply_ms"], hit_rows=hit, new_rows=new,
        bound_ms_4_byte_stride=_bound_ms(8 * n + 4 * hit + 4 * new + 32 * 40, 2 * n)[0],
        bound_ms_1_byte_stride=_bound_ms(2 * n + hit + new + 32 * 40, 2 * n)[0],
    )
    print(f"apply at K=1 {label}: " + json.dumps(out))
    return out


def _lowk16_path(ctx, seed):
    """BASELINE.json config 1, single-source BFS on RMAT-16: rmat_edges(16,
    16) with one group of one source (drawn from the non-isolated
    vertices) through the CLI's auto low-K route; F equals scipy's and the
    plain engine's; then the pack held, the BFS a level at a time and
    split by launch."""
    torch, np, sp, cg, cli, tio, timing, generators, launches, tmp, dev = ctx
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.models.bell import (
        BellGraph,
    )
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.models.csr import (
        CSRGraph,
    )
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.ops import (
        lowk,
    )

    t0 = time.perf_counter()
    n, edges = generators.rmat_edges(16, edge_factor=16, seed=seed)
    g = CSRGraph.from_edges(n, edges)
    source = int(np.random.default_rng(seed).choice(np.nonzero(g.degrees > 0)[0]))
    queries = [np.array([source], dtype=np.int32)]
    gpath, qpath = os.path.join(tmp, "rmat16.bin"), os.path.join(tmp, "rmat16-q.bin")
    tio.save_graph_bin(gpath, n, edges)
    tio.save_query_bin(qpath, queries)
    host_s = time.perf_counter() - t0
    min_k, min_f, pre_s, comp_s = _run_path(
        cli, timing, ["chip_smoke", "-g", gpath, "-q", qpath, "-gn", "1"], "lowk rmat-16",
        launches,
    )
    want = _scipy_f(cg, np, _scipy_matrix(sp, np, g), queries[0])
    assert (min_k, min_f) == (0, want) and want > 0, (min_k, min_f, want)
    assert "flag_pull:W1/map/bits" in VARIANTS["lowk rmat-16"], VARIANTS["lowk rmat-16"]
    bg = BellGraph.from_host(g, dev)
    padded = tio.pad_queries(queries)
    fast = lowk.LowKEngine(bg, level_chunk=128)
    levels, reached, f = fast.query_stats(padded)
    f_plain = lowk.LowKEngine(bg, level_chunk=128, plain=True).f_values(padded).cpu().numpy()
    assert int(f[0]) == int(f_plain[0]) == want, (f, f_plain, want)
    print("lowk rmat-16: " + json.dumps(dict(
        n=n, directed_edges=g.num_directed_edges, source=source, min_f=min_f, scipy_f=want,
        levels=int(levels[0]), reached=int(reached[0]), preprocessing_s=pre_s,
        computation_s=comp_s, host_generate_s=host_s,
    )))
    _pack_check(torch, fast, n, padded, "lowk rmat-16")
    rows = _byte_levels(torch, bg, padded, "lowk rmat-16 K=1", _csr_pairs(torch, bg))
    _summarise_levels(rows, "lowk rmat-16 K=1")
    _lowk_split(torch, fast, bg, padded, len(rows), "lowk rmat-16 K=1")


def _rmat20_paths(ctx, n, edges, g, bg, eg, k, seed):
    """The default (bitbell), ELL (MSBFS_BACKEND=pallas) and byte-plane
    BELL (MSBFS_BACKEND=bell) routes through the CLI on RMAT-20 with K
    groups, and the low-K route on its first LOWK_GROUPS groups: the same
    winner and F on the three K-group routes, every F equal across the
    kernel engines and the plain engines on the card, the winner and the
    first SCIPY_GROUPS groups equal to scipy's (the low-K groups among
    them); then the low-K BFS a level at a time (also at K = 1, for the
    apply's two strides) and both byte routes split by launch."""
    torch, np, sp, cg, cli, tio, timing, generators, launches, tmp = ctx
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.ops import (
        bell, bitbell, engine, lowk,
    )

    gpath, qpath = os.path.join(tmp, "rmat20.bin"), os.path.join(tmp, "rmat20-q.bin")
    qpath4 = os.path.join(tmp, "rmat20-q4.bin")
    queries = generators.random_queries(n, k, seed=seed)
    tio.save_graph_bin(gpath, n, edges)
    tio.save_query_bin(qpath, queries)
    tio.save_query_bin(qpath4, queries[:LOWK_GROUPS])
    argv = ["chip_smoke", "-g", gpath, "-q", qpath, "-gn", "1"]
    runs = {"bitbell rmat-20": _run_path(cli, timing, argv, "bitbell rmat-20", launches)}
    with _env(MSBFS_BACKEND="pallas"):
        runs["ell rmat-20"] = _run_path(cli, timing, argv, "ell rmat-20", launches)
    with _env(MSBFS_BACKEND="bell"):
        runs["bell rmat-20"] = _run_path(cli, timing, argv, "bell rmat-20", launches)
    lowk_run = _run_path(cli, timing, ["chip_smoke", "-g", gpath, "-q", qpath4, "-gn", "1"],
                         "lowk rmat-20", launches)
    os.remove(gpath)
    ell = {k_: v for k_, v in VARIANTS["ell rmat-20"].items() if k_.startswith("ell_hits:")}
    steady = sum(v for k_, v in ell.items() if ":steady" in k_)
    stale = sum(v for k_, v in ell.items() if ":stale" in k_)
    assert steady > stale > 0, ell
    assert "flag_pull:W16/vec16/map" in VARIANTS["bell rmat-20"], VARIANTS["bell rmat-20"]
    assert "flag_pull:W1/map" in VARIANTS["lowk rmat-20"], VARIANTS["lowk rmat-20"]
    padded = tio.pad_queries(queries)
    padded4 = tio.pad_queries(queries[:LOWK_GROUPS])
    _ell_level_split(torch, eg, padded, "rmat-20 K=64")
    _bitbell_hybrid(torch, bg, padded, "bitbell rmat-20 K=64")
    f = {}
    seconds = {}
    for name, eng in (
        ("bitbell kernels", bitbell.BitBellEngine(bg, level_chunk=128)),
        ("bitbell plain", bitbell.BitBellEngine(bg, level_chunk=128, plain=True)),
        ("ell kernels", engine.Engine(eg, level_chunk=128)),
        ("ell plain", engine.Engine(eg, level_chunk=128, plain=True)),
        ("bell kernels", bell.BellEngine(bg, level_chunk=128)),
        ("bell plain", bell.BellEngine(bg, level_chunk=128, plain=True)),
    ):
        t0 = time.perf_counter()
        stats = eng.query_stats(padded)
        seconds[name] = time.perf_counter() - t0
        f[name] = stats[2]
        if name == "bitbell kernels":
            levels, reached = stats[0], stats[1]
    for name, vals in f.items():
        assert np.array_equal(vals, f["bitbell kernels"]), (name, vals)
    fv = f["bitbell kernels"]
    for name, eng in (("lowk kernels", lowk.LowKEngine(bg, level_chunk=128)),
                      ("lowk plain", lowk.LowKEngine(bg, level_chunk=128, plain=True))):
        t0 = time.perf_counter()
        f[name] = eng.query_stats(padded4)[2]
        seconds[name] = time.perf_counter() - t0
        assert np.array_equal(f[name], fv[:LOWK_GROUPS]), (name, f[name])
    winner = int(np.argmin(fv))
    winner4 = int(np.argmin(fv[:LOWK_GROUPS]))
    for name, (min_k, min_f, _, _) in runs.items():
        assert (min_k, min_f) == (winner, int(fv[winner])), (name, min_k, min_f)
    assert lowk_run[:2] == (winner4, int(fv[winner4])), lowk_run
    a = _scipy_matrix(sp, np, g)
    groups = sorted({winner, *range(SCIPY_GROUPS)})
    want = {q: _scipy_f(cg, np, a, queries[q]) for q in groups}
    for q, wf in want.items():
        assert int(fv[q]) == wf, (q, int(fv[q]), wf)
    # About 38% of RMAT-20's vertices are isolated, so a small group may
    # win with F = 0: the check must also hold groups that reach far.
    assert any(wf > 0 for wf in want.values()), want
    depth = int(levels.max())
    for name, (min_k, min_f, pre_s, comp_s) in runs.items():
        print(f"{name}: " + json.dumps(dict(
            n=n, directed_edges=g.num_directed_edges, K=k, winner=min_k + 1, min_f=min_f,
            scipy_f=want[winner], scipy_groups_equal=len(want),
            scipy_f_checked=[want[q] for q in groups], all_f_equal_across_engines=True,
            preprocessing_s=pre_s, computation_s=comp_s, levels=depth,
            reached=int(reached.sum()), ms_per_level=comp_s * 1e3 / max(depth, 1),
        )))
    min_k, min_f, pre_s, comp_s = lowk_run
    print("lowk rmat-20: " + json.dumps(dict(
        n=n, K=LOWK_GROUPS, winner=min_k + 1, min_f=min_f,
        all_f_equal_scipy=[int(x) for x in fv[:LOWK_GROUPS]] == [
            want[q] for q in range(LOWK_GROUPS)],
        f=[int(x) for x in fv[:LOWK_GROUPS]], preprocessing_s=pre_s, computation_s=comp_s,
    )))
    print("rmat-20 engine query_stats s: " + json.dumps(seconds))
    # The pack at the three RMAT-20 batch shapes (bitbell: stride 1, W = 2;
    # bell: stride 8, W = 16; low-K: stride 8, W = 1).
    _pack_check(torch, bitbell.BitBellEngine(bg), n, padded, "bitbell rmat-20")
    _pack_check(torch, bell.BellEngine(bg), n, padded, "bell rmat-20")
    _pack_check(torch, lowk.LowKEngine(bg), n, padded4, "lowk rmat-20")
    # The byte routes a level at a time and split by launch.
    library = _csr_pairs(torch, bg)
    rows4 = _byte_levels(torch, bg, padded4, "lowk rmat-20 K=4", library)
    _summarise_levels(rows4, "lowk rmat-20 K=4")
    rows1 = _byte_levels(torch, bg, padded4[:1], "lowk rmat-20 K=1", library)
    _summarise_levels(rows1, "lowk rmat-20 K=1")
    _apply_at_k1(torch, rows1, n, "lowk rmat-20")
    rows64 = _byte_levels(torch, bg, padded, "bell rmat-20 K=64", library, bell_route=True)
    _summarise_levels(rows64, "bell rmat-20 K=64")
    _lowk_split(torch, lowk.LowKEngine(bg, level_chunk=128), bg, padded4, len(rows4),
                "lowk rmat-20 K=4")
    bell_eng = bell.BellEngine(bg, level_chunk=128)
    _lowk_split(torch, bell_eng, bg, padded, depth, "bell rmat-20 K=64")
    # K5's pull at the bell route's width (W = 16) on a synthetic plane: a
    # third of the flags set, nothing visited (no row to skip), beside
    # bell_hits_packed (forest_or on the word view) on the same frontier.
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.ops import (
        cuda_bell, cuda_flag_pull,
    )

    gen = torch.Generator(device=bg.device).manual_seed(seed)
    wide = (torch.rand((n, k), device=bg.device, generator=gen) < 0.3).to(torch.uint8)
    pull = torch.tensor([1, 7, 0, bitbell.DIR_PULL], dtype=torch.int32, device=bg.device)
    row = _flag_pull_row(torch, bg, wide, torch.zeros_like(wide), k, None, pull,
                         cuda_flag_pull.flag_pull_scratch(bg, k // 4, bg.device), library)
    row["word_view_pull"] = _byte_forest_row(
        torch, bg, wide, cuda_bell.forest_scratch(bg, k // 4, bg.device), library)
    # Each pull wrapper's host time a level, its launches gated off.
    off = torch.tensor([0, 7, 0, bitbell.DIR_PULL], dtype=torch.int32, device=bg.device)
    scratch = cuda_flag_pull.flag_pull_scratch(bg, k // 4, bg.device)
    forest = cuda_bell.forest_scratch(bg, k // 4, bg.device)
    hits, seen = torch.empty_like(wide), torch.zeros_like(wide)
    levels = torch.zeros(8 * k, dtype=torch.int32, device=bg.device)
    row["wrapper_host_us"] = dict(
        flag_pull=_wrapper_host_us(torch, lambda: cuda_flag_pull.flag_pull(
            wide, seen, bg, hits, off, k, scratch=scratch, levels=levels)),
        word_view_pull=_wrapper_host_us(torch, lambda: bell.bell_hits_packed(
            wide, bg, hits, off, scratch=forest)),
        note="host time of one call, its kernels gated off on the device")
    del scratch, forest, hits, seen
    print(f"compare rmat-20 n={n} K={k} flag_pull synthetic: " + json.dumps(row))
    assert row["max_abs_err"] == 0 and row["word_view_pull"]["max_abs_err"] == 0, row
    del library, wide
    pulls = [r["flag_pull"] for r in rows4 if "flag_pull" in r]
    pushes = [r["push_or:bytes"] for r in rows4 if "push_or:bytes" in r]
    assert pulls and pushes, "the low-K BFS ran one direction only"
    # The kernel line's rows: the densest pull and the widest push of the
    # low-K BFS (K = 4, W = 1).
    return {
        "flag_pull": max(pulls, key=lambda r: r["frontier_rows"]),
        "push_or:bytes": max(pushes, key=lambda r: r["edges"]),
    }


@contextlib.contextmanager
def _env(**values):
    """Set environment knobs for one CLI run, then restore them."""
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


def _run_path(cli, timing, argv, name, launches):
    """One CLI run as one path: counters zeroed before, read after."""
    timing.reset_launch_counts()
    result = _run_cli(cli, argv)
    counts = timing.launch_counts()
    launches[name] = counts
    print(f"{name} launches: {json.dumps(counts)}")
    VARIANTS[name] = timing.variant_counts()
    print(f"{name} variants: {json.dumps(VARIANTS[name])}")
    for kernel in PATH_KERNELS[name]:
        assert counts.get(kernel, 0) > 0, f"{kernel} never launched on {name}"
    if name in BYTE_PATHS:
        assert "forest_or" not in counts, (name, counts)
    if "pack_sources" in PATH_KERNELS[name]:
        stride = 8 if name in BYTE_PATHS else 1
        packs = {k: v for k, v in VARIANTS[name].items() if k.startswith("pack_sources:")}
        assert list(packs) == [f"pack_sources:stride{stride}"], (name, packs)
    return result


def _runs(seq):
    """Run-length form of a direction sequence: "push x3, matmul x5"."""
    out = []
    for d in seq:
        if out and out[-1][0] == d:
            out[-1][1] += 1
        else:
            out.append([d, 1])
    return ", ".join(f"{d} x{c}" for d, c in out)


def _mxu_path(ctx, name, n, edges, g, k, seed):
    """The mxu route through the CLI on one graph, then every F against
    scipy and the plain engine, and the direction trace."""
    torch, np, sp, cg, cli, tio, timing, generators, mxu, dev, tmp, launches = ctx
    gpath = os.path.join(tmp, f"{name.split()[1]}.bin")
    qpath = os.path.join(tmp, f"{name.split()[1]}-q.bin")
    queries = generators.random_queries(n, k, seed=seed)
    tio.save_graph_bin(gpath, n, edges)
    tio.save_query_bin(qpath, queries)
    with _env(MSBFS_BACKEND="mxu", MSBFS_MXU_KERNEL="1"):
        min_k, min_f, pre_s, comp_s = _run_path(
            cli, timing, ["chip_smoke", "-g", gpath, "-q", qpath, "-gn", "1"],
            name, launches,
        )
    assert any(v.startswith("tile_hits:pipe") for v in VARIANTS[name]), VARIANTS[name]
    mg = mxu.MxuGraph.from_host(g, dev)
    padded = tio.pad_queries(queries)
    fast = mxu.MxuEngine(mg, level_chunk=128, kernel=True)
    _pack_check(torch, fast, mg.n, padded, name)
    plain = mxu.MxuEngine(mg, level_chunk=128, plain=True)
    t0 = time.perf_counter()
    levels, reached, f_fast = fast.query_stats(padded)
    fast_s = time.perf_counter() - t0
    f_plain = plain.f_values(padded).cpu().numpy()
    assert np.array_equal(f_fast, f_plain), (f_fast, f_plain)
    a = _scipy_matrix(sp, np, g)
    want = np.array([_scipy_f(cg, np, a, q) for q in queries])
    assert np.array_equal(f_fast, want), (f_fast, want)
    assert (min_k, min_f) == (int(np.argmin(want)), int(want.min()))
    trace = [s["direction"] for s in fast.level_direction_trace(padded)]
    assert len(trace) == int(levels.max()), (len(trace), int(levels.max()))
    depth = int(levels.max())
    print(f"{name}: " + json.dumps(dict(
        n=n, K=k, tiles=mg.nt, winner=min_k + 1, min_f=min_f, scipy_f=int(want.min()),
        all_f_equal_scipy=True, preprocessing_s=pre_s, computation_s=comp_s,
        levels=depth, engine_query_stats_s=fast_s,
        ms_per_level=comp_s * 1e3 / max(depth, 1), switch=fast.switch,
        push_budget=fast.push_budget, push_levels=trace.count("push"),
        matmul_levels=trace.count("matmul"),
    )))
    print(f"{name} directions: {_runs(trace)}")
    _real_mxu_level(torch, mg, fast, padded, name)
    if set(trace) == {"push", "matmul"}:
        _mxu_hybrid(torch, mg, fast, padded, name)
    return trace


def _real_mxu_level(torch, mg, eng, padded, label):
    """tile_hits against its plain version, timed, on the frontier of the
    BFS's widest matmul level (``eng.last_direction_trace`` is the trace of
    this batch)."""
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.ops import (
        bitbell, cuda_mxu,
    )

    matmul = [s for s in eng.last_direction_trace if s["direction"] == "matmul"]
    if not matmul:
        return
    widest = max(matmul, key=lambda s: s["active_rows"])
    carry = eng._init_carry(eng._pad_queries(padded)[0])
    hits = torch.zeros_like(carry.frontier)
    for _ in range(widest["level"] - 1):
        eng._chunk(carry, 1, hits)
    frontier = carry.frontier
    assert int((frontier != 0).any(dim=1).sum()) == widest["active_rows"]
    mm = torch.tensor([1, 0, 0, bitbell.DIR_MATMUL], dtype=torch.int32, device=frontier.device)
    tiles = (mg.tiles, mg.tile_row, mg.tile_col, mg.row_ptr)
    h_k, h_p = torch.empty_like(frontier), torch.empty_like(frontier)
    cuda_mxu.tile_matmul_hits(*tiles, frontier, h_k, mm)
    cuda_mxu.tile_matmul_hits_plain(*tiles, frontier, h_p, mm)
    torch.cuda.synchronize()
    err = _max_abs_err(torch, [(h_k, h_p)])
    ms = _time_ms(torch, lambda: cuda_mxu.tile_matmul_hits(*tiles, frontier, h_k, mm),
                  lambda: None)
    print(f"real level {label} level={widest['level']} "
          f"frontier_rows={widest['active_rows']} tile_hits: "
          + json.dumps(dict(max_abs_err=err, ms=ms)))
    assert err == 0, (label, err)


def _scipy_matrix(sp, np, graph):
    """The graph's CSR as a scipy matrix, built once per graph."""
    return sp.csr_matrix(
        (np.ones(graph.col_indices.size, np.float32), graph.col_indices,
         graph.row_offsets), shape=(graph.n, graph.n),
    )


def _scipy_f(cg, np, a, sources):
    """F of one query group from scipy's multi-source BFS (unweighted) over
    the matrix ``a`` of :func:`_scipy_matrix`."""
    n = a.shape[0]
    src = np.unique(sources[(sources >= 0) & (sources < n)])
    if src.size == 0:
        return 0
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
    global DETAIL_DIR
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--detail-dir", default=DETAIL_DIR,
                    help="directory for the per-level rows of the hybrid paths")
    args = ap.parse_args()
    DETAIL_DIR = args.detail_dir
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
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.models.bell import (
        BellGraph,
    )
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.models.csr import (
        CSRGraph,
    )
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.models.ell import (
        EllGraph,
    )
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.ops import (
        bitbell, mxu, packed, stencil,
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

    print("host dispatch: " + json.dumps(dict(
        us_per_small_torch_op=_host_dispatch_us(torch, dev),
        event_pair_ms=_time_ms(torch, lambda: None, lambda: None),
        note="host time to enqueue one small torch op on the card; the device "
             "time between two CUDA events with nothing between them")))

    # ---- data: road-4096 (stencil main path), road-1024, RMAT-14 (mxu main
    # path: bench.py config "6") and road-512
    seed = args.seed
    t0 = time.perf_counter()
    n4, e4 = generators.road_edges(4096, 4096, seed=seed)
    g4 = CSRGraph.from_edges(n4, e4)
    sg4 = stencil.StencilGraph.from_host(g4, dev)
    n1, e1 = generators.road_edges(1024, 1024, seed=seed + 1)
    g1 = CSRGraph.from_edges(n1, e1)
    sg1 = stencil.StencilGraph.from_host(g1, dev)
    nr, er = generators.rmat_edges(14, edge_factor=16, seed=seed)
    gr = CSRGraph.from_edges(nr, er)
    mgr = mxu.MxuGraph.from_host(gr, dev)
    n5, e5 = generators.road_edges(512, 512, seed=seed)
    g5 = CSRGraph.from_edges(n5, e5)
    mg5 = mxu.MxuGraph.from_host(g5, dev)
    print(f"data: road-4096 n={n4} directed={g4.num_directed_edges} "
          f"offsets={len(sg4.offsets)} residual={int(sg4.res_src.shape[0])}; "
          f"road-1024 n={n1} residual={int(sg1.res_src.shape[0])}; "
          f"rmat-14 n={nr} dedup={int(mgr.vals.shape[0])} tiles={mgr.nt}; "
          f"road-512 n={n5} dedup={int(mg5.vals.shape[0])} tiles={mg5.nt}; "
          f"{time.perf_counter() - t0:.1f} s host")

    # ---- 2. kernels against their plain versions
    main_shape = _compare_kernels(torch, sg4, 1, seed, "road-4096")
    _compare_kernels(torch, sg1, 8, seed + 1, "road-1024")
    main_shape.update(_compare_mxu(torch, mgr, 2, seed + 6, "rmat-14"))
    _compare_mxu(torch, mg5, 1, seed + 7, "road-512")
    # The level apply at the mxu route's plane shapes.
    _compare_apply(torch, mgr.n_pad, mgr.n, 2, dev, seed + 13, "rmat-14")
    _compare_apply(torch, mg5.n_pad, mg5.n, 1, dev, seed + 14, "road-512")

    # ---- 3. main path through the CLI
    # Removed when the script ends, whichever way it ends.
    tmpdir = tempfile.TemporaryDirectory(prefix="msbfs_smoke_")
    tmp = tmpdir.name
    gpath, qpath = os.path.join(tmp, "road4096.bin"), os.path.join(tmp, "q.bin")
    q4 = generators.random_queries(n4, 16, seed=seed + 2)
    tio.save_graph_bin(gpath, n4, e4)
    tio.save_query_bin(qpath, q4)
    launches = {}
    min_k, min_f, pre_s, comp_s = _run_path(
        cli, timing, ["chip_smoke", "-g", gpath, "-q", qpath, "-gn", "1"],
        "stencil road-4096", launches,
    )
    sweeps = [k for k in VARIANTS["stencil road-4096"] if k.startswith("stencil_sweep:")]
    assert sweeps and all(k.endswith("/res") for k in sweeps), sweeps

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
    want_f = _scipy_f(cg, np, _scipy_matrix(sp, np, g4), q4[min_k])
    assert want_f == min_f, (want_f, min_f)
    depth = int(levels4.max())
    _pack_check(torch, fast, n4, padded4, "stencil road-4096")
    print("main path: " + json.dumps(dict(
        graph="road-4096", K=16, winner=min_k + 1, min_f=min_f, scipy_f=want_f,
        preprocessing_s=pre_s, computation_s=comp_s, levels=depth,
        reached=int(reached4.sum()), engine_query_stats_s=fast_s,
        plain_path_f_values_s=plain_s,
        ms_per_level=comp_s * 1e3 / max(depth, 1),
    )))
    # The sweep and the apply on the planes of a real level, and one chunk
    # of real levels split by kernel.
    mid_carry = _real_level(torch, sg4, padded4, depth, "road-4096")
    _level_split(torch, sg4, mid_carry, 64, "road-4096")
    del mid_carry, fast, plain

    # ---- 4-5. the mxu route: RMAT-14 with K = 64, road-512 with K = 16
    ctx = (torch, np, sp, cg, cli, tio, timing, generators, mxu, dev, tmp, launches)
    _mxu_path(ctx, "mxu rmat-14", nr, er, gr, 64, seed + 8)
    trace5 = _mxu_path(ctx, "mxu road-512", n5, e5, g5, 16, seed + 9)
    assert {"push", "matmul"} <= set(trace5), "road-512 ran one direction only"
    del mgr, mg5

    # ---- 5a. the low-K route on RMAT-16 with one source (BASELINE.json
    # config 1)
    _lowk16_path((torch, np, sp, cg, cli, tio, timing, generators, launches, tmp, dev), seed)

    # ---- 4b. RMAT-20 (BASELINE.json config 2): the forest and ELL kernels
    # against their plain versions at K = 64 and K = 256, then the default
    # and ELL routes through the CLI with K = 64
    t0 = time.perf_counter()
    n20, e20 = generators.rmat_edges(20, edge_factor=16, seed=seed)
    g20 = CSRGraph.from_edges(n20, e20)
    t_csr = time.perf_counter() - t0
    t0 = time.perf_counter()
    bg20 = BellGraph.from_host(g20, dev)
    t_bell = time.perf_counter() - t0
    t0 = time.perf_counter()
    eg20 = EllGraph.from_host(g20, dev)
    t_ell = time.perf_counter() - t0
    dedup = int(bg20.sparse[2].shape[0])
    print(f"data: rmat-20 n={n20} directed={g20.num_directed_edges} dedup={dedup} "
          f"max_dedup_degree={int(bg20.sparse[1].max())} "
          f"isolated={int((g20.degrees == 0).sum())} forest_levels={list(bg20.level_sizes)} "
          f"fill={bg20.fill:.3f} ell_vrows={eg20.num_vrows}; host s: generate+csr "
          f"{t_csr:.1f}, bell {t_bell:.1f}, ell {t_ell:.1f}")
    main_shape.update(_compare_forest_ell(torch, bg20, eg20, 64, seed + 10, "rmat-20"))
    budget = bitbell.default_sparse_budget(dedup)
    _compare_apply(torch, n20, n20, 2, dev, seed + 15, "rmat-20",
                   (bg20.sparse[1], budget, budget))
    _compare_forest_ell(torch, bg20, eg20, 256, seed + 11, "rmat-20")
    torch.cuda.empty_cache()
    ctx20 = (torch, np, sp, cg, cli, tio, timing, generators, launches, tmp)
    main_shape.update(_rmat20_paths(ctx20, n20, e20, g20, bg20, eg20, 64, seed + 12))
    main_shape["pack_sources"] = PACK_ROWS["bitbell rmat-20"]
    del bg20, eg20, g20, e20
    torch.cuda.empty_cache()
    total = {name: sum(c.get(name, 0) for c in launches.values())
             for name in kernels.KERNELS}
    for name, count in total.items():
        assert count > 0, f"{name} launched on no path"

    # ---- 6. road-1024, K = 16: every F against scipy
    gpath1, qpath1 = os.path.join(tmp, "road1024.bin"), os.path.join(tmp, "q1.bin")
    q1 = generators.random_queries(n1, 16, seed=seed + 3)
    tio.save_graph_bin(gpath1, n1, e1)
    tio.save_query_bin(qpath1, q1)
    k1, f1, pre1, comp1 = _run_cli(
        cli, ["chip_smoke", "-g", gpath1, "-q", qpath1, "-gn", "1"]
    )
    eng1 = stencil.StencilEngine(sg1, level_chunk=stencil.AUTO_STENCIL_LEVEL_CHUNK)
    lv1, _, fv1 = eng1.query_stats(tio.pad_queries(q1))
    a1 = _scipy_matrix(sp, np, g1)
    want1 = np.array([_scipy_f(cg, np, a1, q) for q in q1])
    assert np.array_equal(fv1, want1), (fv1, want1)
    assert (k1, f1) == (int(np.argmin(want1)), int(want1.min()))
    print("road-1024 K=16: " + json.dumps(dict(
        winner=k1 + 1, min_f=f1, all_f_equal_scipy=True, levels=int(lv1.max()),
        preprocessing_s=pre1, computation_s=comp1,
    )))
    tmpdir.cleanup()

    # ---- 7. road-1024, K = 300: the sub-batch split
    q300 = tio.pad_queries(generators.random_queries(n1, 300, max_group=8, seed=seed + 4))
    sub_fast = packed.SubBatchEngine(
        stencil.StencilEngine(sg1, level_chunk=stencil.AUTO_STENCIL_LEVEL_CHUNK))
    sub_plain = packed.SubBatchEngine(stencil.StencilEngine(
        sg1, level_chunk=stencil.AUTO_STENCIL_LEVEL_CHUNK, plain=True))
    timing.reset_launch_counts()
    t0 = time.perf_counter()
    best300 = sub_fast.best(q300)
    sub_s = time.perf_counter() - t0
    print(f"road-1024 K=300 variants: {json.dumps(timing.variant_counts())}")
    f300 = sub_fast.f_values(q300).cpu().numpy()
    assert np.array_equal(f300, sub_plain.f_values(q300).cpu().numpy())
    assert best300 == (int(f300.min()), int(np.argmin(f300)))
    print(f"road-1024 K=300: best={best300} kernel-path best {sub_s:.3f} s, "
          "F equals plain path")

    # ---- 8. the active-row window on a residual-free grid
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
    timing.reset_launch_counts()
    t0 = time.perf_counter()
    got = win.query_stats(qg)
    win_s = time.perf_counter() - t0
    print(f"grid-2048 window variants: {json.dumps(timing.variant_counts())}")
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
    replaces = {
        "stencil_sweep": "ops/pallas_stencil.py:75",
        "level_apply": "ops/bitbell.py:333",
        "tile_hits": "ops/pallas_mxu.py:48",
        "push_or": "ops/bitbell.py:225",
        "forest_or": "ops/bell.py:75",
        "ell_hits": "ops/pallas_bfs.py:44",
        "pack_sources": "ops/bitbell.py:93, {JAX_PKG}/ops/lowk.py:66",
        "flag_pull": "ops/bell.py:144, {JAX_PKG}/ops/lowk.py:126",
        "push_or:bytes": "ops/lowk.py:87",
    }
    # The byte use of K3 (K5's push): its launches on the byte paths.
    total["push_or:bytes"] = sum(launches[p].get("push_or", 0) for p in BYTE_PATHS)
    rows = []
    for name in (*kernels.KERNELS, "push_or:bytes"):
        row = main_shape[name]
        rows.append(dict(
            name=name, route="cuda", source=f"{PKG}/csrc/{name.split(':')[0]}.cu",
            replaces=f"{JAX_PKG}/{replaces[name].format(JAX_PKG=JAX_PKG)}",
            launches=total[name],
            max_abs_err=row["max_abs_err"], ms=row["ms"], plain_ms=row["plain_ms"],
            bound_ms=row["bound_ms"], bound_by=row["bound_by"],
            library_ms=row.get("library_ms"),
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

"""CLI driver — the reference contract, on the CUDA device.

``python -m parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch
-g <graph.bin> -q <query.bin> -gn <numGPU>``, kept exactly as the JAX
package's cli.py keeps it (reference main.cu:195-422): hand-rolled argv
scan, unknown flags ignored, ``-gn`` defaulting to 1 and clamped to the
cards present but reported as given; usage errors return -1; the 7-line
report with the 1-based winner and 9-decimal times.

Routes, chosen as the JAX CLI chooses them off a TPU; on one device: the
stencil route — road-class graphs with a banded adjacency (auto), or
``MSBFS_BACKEND=stencil``; the low-K route — 1 to ``MSBFS_LOWK_MAX_K``
(4) queries on auto when no earlier route took the graph (``MSBFS_LOWK=0``
disables; ``MSBFS_STATS=2`` keeps bitbell), or ``MSBFS_BACKEND=lowk``; the tensor-core route ``MSBFS_BACKEND=mxu``
(``MSBFS_MXU_KERNEL=1`` for the CUDA tile kernel); the ELL route
``MSBFS_BACKEND=pallas``; the pull-only byte-plane route
``MSBFS_BACKEND=bell``; the host-streamed forest ``MSBFS_BACKEND=streamed``;
the single-device engines over the flat CSR — ``vmap`` (a row a query) and
``packed`` (query-minor, ``MSBFS_EDGE_CHUNKS``) on the CSR pull kernel,
``dense`` (one bf16 matmul a level, only when asked for by name, as off a
TPU), and the queue pushes ``push`` and ``ppush`` over the width-padded
table (a degree beyond its cap exits 1);
and the default bitbell route (every other graph and backend name), with
its over-memory configuration when the hybrid layout would not fit the
device, and otherwise its capacity ladder (level-chunked, streamed,
host-streamed) for the supervisor to step down on an out-of-memory
error.  Each has the sub-batch split for wide batches and the
supervisor's watchdog, retry and fault seams (``MSBFS_FAULTS``, installed
before any load); ``MSBFS_CHECKPOINT`` runs the batch in journaled
chunks, ``MSBFS_STATS=1/2`` prints the per-query (and per-level) tables,
and a typed failure dumps the flight ring to ``MSBFS_FLIGHT_RECORDER``.
Ahead of all of them, ``MSBFS_WEIGHTED=1`` takes the weighted route
(weighted/: delta-stepping over the file's edge costs, its flavor from
``MSBFS_WEIGHTED_ENGINE``, its bucket width from ``MSBFS_DELTA``, audited
under ``MSBFS_AUDIT``), and the ``verify`` subcommand certifies answers
(:func:`verify_main`); the serving subcommands ``serve``, ``query``,
``health`` and ``trace`` run the single-replica daemon and its client,
``fleet`` a replicated fleet of those daemons behind a failover
router (serve/), and ``analyze`` the static passes over the port's
files (analysis/).  ``MSBFS_PROFILE_DIR`` writes a ``torch.profiler``
trace of the computation span (:func:`.utils.trace.profiler_trace`).
At ``-gn > 1`` the batch runs over a ('q', 'v') mesh of that many cards
(:func:`mesh_route`, parallel/): the query-sharded bitbell, CSR-pull and
push engines, or, with ``MSBFS_VSHARD`` (or a graph beyond one card's
memory), the vertex-sharded forest and owner-partitioned push, whose
halo ``MSBFS_HALO_BUDGET`` / ``MSBFS_PUSH_HALO`` tune; with
``MSBFS_MESH=RxC`` the CSR is tiled over an (R, C) mesh instead
(:func:`mesh2d_route`, parallel/partition2d.py); the supervisor
reshards onto the surviving cards after a lost one.
Every other route or mode of the JAX CLI (``MSBFS_COORDINATOR``,
``MSBFS_CACHE_DIR``) exits 1 with a one-line
message naming it as not yet ported; none of them silently runs
something else.

``main(argv, device=None, native=True, mesh_devices=None)`` runs on
``cuda`` and raises when there is no card; ``device="cpu"`` runs the
kernels' plain torch versions (tests).  ``mesh_devices`` replaces the
card list that ``-gn`` is clamped to, for tests and the smoke: a logical
mesh may name one device several times (``["cpu"] * 4``).  The host preprocessing (load, CSR, dedup, BELL levels) runs in
the native runtime, built at first use; ``native=False`` runs its NumPy
versions instead, to compare.  The preprocessing span's phases (load,
layout, compile) are left in :func:`.utils.timing.phase_seconds`.
"""

from __future__ import annotations

import sys
from typing import List, Optional

import numpy as np
import torch

from .utils import knobs

# Levels per dispatch for the auto bound of the gather engines (the JAX
# package's value); the stencil route replaces it with its own.
_AUTO_LEVEL_CHUNK = 128


def parse_args(argv: List[str]):
    """Linear argv scan, reference-exact (main.cu:216-224)."""
    graph_file: Optional[str] = None
    query_file: Optional[str] = None
    num_gpu = 1
    i = 1
    while i < len(argv):
        if argv[i] == "-g" and i + 1 < len(argv):
            i += 1
            graph_file = argv[i]
        elif argv[i] == "-q" and i + 1 < len(argv):
            i += 1
            query_file = argv[i]
        elif argv[i] == "-gn" and i + 1 < len(argv):
            i += 1
            try:
                num_gpu = int(argv[i])
            except ValueError:
                num_gpu = 0  # atoi semantics: non-numeric -> 0
        i += 1
    return graph_file, query_file, num_gpu


def _road_class(graph) -> bool:
    """Deep-BFS degree profile (road networks/grids): low max and mean
    degree.  Routes auto runs to the stencil probe."""
    if graph.n == 0 or graph.num_directed_edges == 0:
        return False
    mean_deg = graph.num_directed_edges / graph.n
    return int(graph.degrees.max()) <= 64 and mean_deg <= 8.0


_UNSET = object()


def _explicit_level_chunk() -> Optional[int]:
    """Parsed MSBFS_LEVEL_CHUNK, or None when unset/empty or malformed
    (a malformed value warns and keeps the auto bound)."""
    raw = knobs.raw("MSBFS_LEVEL_CHUNK")
    if raw is None or raw == "":
        return None
    try:
        return int(raw)
    except ValueError:
        print(
            f"MSBFS_LEVEL_CHUNK={raw!r} is not an integer; "
            "using the auto bound",
            file=sys.stderr,
        )
        return None


def _level_chunk_policy(graph, explicit=_UNSET) -> Optional[int]:
    """Levels between host syncs (None = one run to convergence): an
    explicit positive MSBFS_LEVEL_CHUNK wins, 0 disables the bound, a
    negative value warns and keeps the auto bound."""
    if explicit is _UNSET:
        explicit = _explicit_level_chunk()
    if explicit is not None:
        if explicit > 0:
            return explicit
        if explicit == 0:
            return None
        print(
            f"MSBFS_LEVEL_CHUNK={explicit} is negative; "
            "using the auto bound (0 disables)",
            file=sys.stderr,
        )
    if graph.n == 0 or graph.num_directed_edges == 0:
        return None
    return _AUTO_LEVEL_CHUNK


def chunk_policy(graph):
    """(explicit MSBFS_LEVEL_CHUNK, levels between host syncs, megachunk):
    a deliberate positive bound is honored exactly (megachunk 1); the auto
    bound may be fused per dispatch (megachunk None).  Shared by the batch
    route and :mod:`.serve.registry`."""
    explicit = _explicit_level_chunk()
    level_chunk = _level_chunk_policy(graph, explicit)
    megachunk = 1 if (explicit is not None and explicit > 0) else None
    return explicit, level_chunk, megachunk


def stencil_probe(graph, device, backend, level_chunk, explicit_chunk):
    """The stencil route's probe: (StencilGraph, levels per dispatch) when
    ``MSBFS_BACKEND=stencil`` or, on auto, a road-class graph with a banded
    adjacency (``MSBFS_STENCIL=0`` disables); None when the route does not
    take the graph.  A forced stencil backend that does not fit raises
    ValueError.  Shared by the batch route and :mod:`.serve.registry`."""
    if not (backend == "stencil" or (
        backend == "auto" and _road_class(graph) and knobs.raw("MSBFS_STENCIL", "") != "0"
    )):
        return None
    from .ops.stencil import AUTO_STENCIL_LEVEL_CHUNK, StencilGraph

    try:
        sg = StencilGraph.from_host(graph, device)
    except ValueError:
        if backend == "stencil":
            raise
        return None  # auto probe failed: keep the gather engines
    # An explicit MSBFS_LEVEL_CHUNK wins; a negative one lands on the
    # stencil auto bound, not the gather engines' 128.
    stencil_chunk = (
        level_chunk
        if explicit_chunk is not None and explicit_chunk >= 0
        else (AUTO_STENCIL_LEVEL_CHUNK if level_chunk else None)
    )
    return sg, stencil_chunk


def resolve_device(device) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: this CLI runs on the GPU (device='cpu' "
                "runs the plain versions, for tests)"
            )
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None and torch.cuda.is_available():
        # A bare "cuda" (``--device cuda``) is the current card, by index:
        # the daemon's threads bind it with torch.cuda.set_device.
        return torch.device("cuda", torch.cuda.current_device())
    return dev


# Backends whose footprint the bitbell estimate does not model: they never
# take the over-memory configuration (the JAX CLI's list).
_NON_BITBELL_FOOTPRINT_BACKENDS = (
    "dense", "pallas", "bell", "packed", "ppush", "stencil", "streamed",
    "lowk", "mxu", "vmap", "push",
)
# Levels per dispatch of the over-memory bitbell configuration.
_OVER_MEMORY_LEVEL_CHUNK = 8
# Gather-segment budget of the over-memory configuration, in slots.
_OVER_MEMORY_SLOT_BUDGET = 1 << 25


# Backends with no 1D-distributed variant: at -gn > 1 they warn and fall
# back to the distributed bitbell engine (the JAX CLI's list; ``csr`` /
# ``vmap`` and ``push`` have multi-device routes).
_SINGLE_CHIP_ONLY_BACKENDS = (
    "dense", "pallas", "bell", "packed", "ppush", "stencil", "streamed", "lowk", "mxu",
)


def _opt_env_int(name: str) -> Optional[int]:
    """None when unset, empty or malformed (the engine auto-sizes); else
    the integer (0 disables)."""
    raw = knobs.raw(name)
    if raw is None or raw == "":
        return None
    try:
        return int(raw)
    except ValueError:
        return None


def mesh_route(graph, padded, devices, level_chunk, explicit_chunk, road_class,
               hbm_need, hbm_have, announce_chunk, native: bool = True):
    """The -gn > 1 route over ``devices`` (the JAX CLI's multi-chip branch
    without ``MSBFS_MESH``): the engine, or an exit code.

    ``MSBFS_VSHARD=v`` splits the graph over a 'v' mesh axis of v devices
    (the rest shard queries); unset, the graph is replicated unless its
    estimated footprint exceeds one device's budget, when the smallest
    vertex-shard count that divides the devices and fits is taken.  On a
    ('q', 'v') mesh the owner-partitioned push serves ``push`` and
    road-class graphs on auto (the sharded forest when it cannot build),
    the sharded forest everything else; on a query mesh ``push`` runs the
    query-sharded push, ``csr``/``vmap`` the distributed CSR pull, and
    every other backend the distributed bitbell engine."""
    from .models.bell import BellGraph
    from .parallel.distributed import DistributedEngine
    from .parallel.mesh import make_mesh

    n_chips = len(devices)
    vshard = knobs.get_int("MSBFS_VSHARD", 0)
    if vshard == 0:
        vshard = 1
        if hbm_need > hbm_have:
            k_est = max(32, padded.shape[0])
            for v in range(2, n_chips + 1):
                # Only the edge-proportional terms shrink per shard.
                if n_chips % v == 0 and BellGraph.estimate_hbm_bytes(
                    graph.n, graph.num_directed_edges, k_est, v
                ) <= hbm_have:
                    vshard = v
                    break
            else:
                vshard = n_chips
            print(
                f"graph needs ~{hbm_need >> 20} MiB"
                f" > {hbm_have >> 20} MiB/chip: auto-sharding the"
                f" CSR over {vshard} of {n_chips} chips"
                " (MSBFS_VSHARD overrides)",
                file=sys.stderr,
            )
    if vshard > 1 and n_chips % vshard != 0:
        print(
            f"MSBFS_VSHARD={vshard} does not divide {n_chips} chips;"
            " falling back to replicated-graph query sharding",
            file=sys.stderr,
        )
    backend = knobs.raw("MSBFS_BACKEND", "auto")
    if backend in _SINGLE_CHIP_ONLY_BACKENDS:
        print(
            f"MSBFS_BACKEND={backend} is single-chip only; using "
            "the distributed bitbell engine at -gn > 1",
            file=sys.stderr,
        )
        backend = "auto"
    if vshard > 1 and n_chips % vshard == 0:
        mesh = make_mesh(num_query_shards=n_chips // vshard, num_vertex_shards=vshard,
                         devices=devices)
        engine = None
        if backend == "push" or (backend == "auto" and road_class):
            from .parallel.push_sharded import ShardedPushEngine

            try:
                engine = ShardedPushEngine(mesh, graph, level_chunk=level_chunk, native=native)
                announce_chunk()
            except ValueError as exc:
                if backend == "push":
                    print(str(exc), file=sys.stderr)
                    return 1
                print(f"auto: {exc}; using the sharded bitbell engine", file=sys.stderr)
        elif backend in ("csr", "vmap"):
            print(
                f"MSBFS_BACKEND={backend} has no vertex-sharded "
                "variant; using the sharded bitbell engine",
                file=sys.stderr,
            )
        if engine is None:
            from .parallel.sharded_bell import ShardedBellEngine

            announce_chunk()
            engine = ShardedBellEngine(
                mesh, graph, level_chunk=level_chunk,
                halo_budget=_opt_env_int("MSBFS_HALO_BUDGET"),
                push_budget=_opt_env_int("MSBFS_PUSH_HALO"),
                native=native,
            )
        return engine
    if backend == "push":
        from .parallel.push_dist import DistributedPushEngine

        try:
            return DistributedPushEngine(
                make_mesh(num_query_shards=n_chips, devices=devices), graph, native=native)
        except ValueError as exc:
            # Degree beyond the width cap: the push route's error.
            print(str(exc), file=sys.stderr)
            return 1
    mesh = make_mesh(num_query_shards=n_chips, devices=devices)
    if backend in ("csr", "vmap"):
        if road_class or (explicit_chunk or 0) > 0:
            print(
                f"warning: MSBFS_BACKEND={backend} has no "
                "bounded-dispatch level loop at -gn > 1; a "
                "high-diameter graph may exceed per-dispatch "
                "limits (unset MSBFS_BACKEND for the chunked "
                "bitbell engine)",
                file=sys.stderr,
            )
        return DistributedEngine(mesh, graph, backend="csr", native=native)
    announce_chunk()
    return DistributedEngine(mesh, graph, level_chunk=level_chunk, native=native)


def mesh2d_route(graph, devices, level_chunk, announce_chunk, native: bool = True):
    """The -gn > 1 route with ``MSBFS_MESH=RxC`` (the JAX CLI's 2D mesh
    branch): the CSR tiled over an (R, C) mesh of ``devices``
    (parallel/partition2d.py).  ``MSBFS_BACKEND`` pins the axis defaults
    (lowk -> plane:byte, mxu -> kernel:mxu), ``MSBFS_MESH_PLANE`` /
    ``MSBFS_MESH_KERNEL`` / ``MSBFS_MESH_RESIDENCY`` override per axis, and
    ``resolve_axes`` + ``negotiate_engine`` fail loud on a composition no
    engine has.  Returns the engine, or 1 after a one-line error (a
    malformed spec, R*C other than the devices -gn selected, a bad merge
    tree or an impossible composition)."""
    from .ops.engine import engine_label, negotiate_engine, resolve_axes
    from .parallel.mesh import make_mesh2d, parse_mesh_spec
    from .parallel.partition2d import Mesh2DEngine

    mesh_spec = knobs.raw("MSBFS_MESH", "").strip()
    n_chips = len(devices)
    try:
        rows, cols = parse_mesh_spec(mesh_spec)
        if rows * cols != n_chips:
            raise ValueError(
                f"MSBFS_MESH={mesh_spec} wants {rows * cols} chips "
                f"but -gn selected {n_chips}"
            )
        backend = knobs.raw("MSBFS_BACKEND", "auto")
        if backend in ("auto", "csr"):
            backend = "bitbell"  # the mesh default plane layout
        residency = (knobs.raw("MSBFS_MESH_RESIDENCY") or "hbm").strip().lower()
        plane = (knobs.raw("MSBFS_MESH_PLANE") or "").strip().lower() or None
        kernel = (knobs.raw("MSBFS_MESH_KERNEL") or "").strip().lower() or None
        async_levels = max(1, knobs.get_int("MSBFS_ASYNC_LEVELS", 1))
        axes, required = resolve_axes(
            backend, partition="mesh2d", residency=residency, plane=plane,
            kernel=kernel, async_levels=async_levels,
        )
        label = engine_label(axes, async_levels=async_levels)
        _, engine = negotiate_engine(
            required,
            [(
                label,
                Mesh2DEngine,
                lambda: Mesh2DEngine(
                    make_mesh2d(rows, cols, devices=devices), graph,
                    level_chunk=level_chunk,
                    merge_tree=knobs.raw("MSBFS_MERGE_TREE") or None,
                    residency=axes["residency"], async_levels=async_levels,
                    plane=axes["plane"], kernel=axes["kernel"], native=native,
                ),
            )],
        )
    except (TypeError, ValueError) as exc:
        print(str(exc), file=sys.stderr)
        return 1
    print(f"mesh route: {label} ({rows}x{cols}, {', '.join(sorted(required))})",
          file=sys.stderr)
    announce_chunk()
    return engine


def _unported_knob() -> Optional[str]:
    """The first knob set to a route or mode the port does not have."""
    if knobs.raw("MSBFS_COORDINATOR", ""):
        return (
            "MSBFS_COORDINATOR (the multi-process bring-up, with "
            "MSBFS_NUM_PROCESSES and MSBFS_PROCESS_ID)"
        )
    return knobs.unported_cache_dir()


def bitbell_ladder(graph, level_chunk, device, native: bool = True):
    """The default route's capacity rungs (the JAX CLI's
    ``_bitbell_ladder``): on an out-of-memory error the supervisor builds
    the next rung and runs the call again — level-chunked (only when the
    route runs unbounded), then the in-memory streamed configuration (no
    dedup CSR, bounded gather segments, 8 levels a host sync), then the
    host-streamed forest (ops.streamed), whose forest never enters device
    memory.  Factories are lazy: a rung's layout is built when reached."""
    from .models.bell import BellGraph
    from .ops.bitbell import BitBellEngine
    from .ops.streamed import StreamedBitBellEngine

    def slot_budget():
        return _OVER_MEMORY_SLOT_BUDGET if not knobs.raw("MSBFS_SLOT_BUDGET") else None

    rungs = []
    if not level_chunk:
        rungs.append((
            "level-chunked",
            lambda: BitBellEngine(
                BellGraph.from_host(graph, device, native=native),
                level_chunk=_AUTO_LEVEL_CHUNK,
            ),
        ))
    rungs.append((
        "streamed",
        lambda: BitBellEngine(
            BellGraph.from_host(graph, device, keep_sparse=False, native=native),
            sparse_budget=0,
            level_chunk=min(level_chunk or _OVER_MEMORY_LEVEL_CHUNK, _OVER_MEMORY_LEVEL_CHUNK),
            megachunk=1,
            slot_budget=slot_budget(),
        ),
    ))
    rungs.append((
        "host-streamed",
        lambda: StreamedBitBellEngine(
            BellGraph.from_host(graph, False, keep_sparse=False, native=native),
            device,
            slot_budget=slot_budget(),
        ),
    ))
    return rungs


def verify_main(argv: List[str], device=None, native: bool = True) -> int:
    """``verify``: offline certification of distance-to-set answers.

    Recomputes the distance fields with the untrusted host sweep,
    certifies the recompute against the BFS invariants (the weighted ones
    with ``--weighted`` or ``MSBFS_WEIGHTED=1``), and checks a claimed F
    vector against it.  The claim is ``--expect-f`` (a JSON list, or
    ``@PATH`` to one) or, by default, a fresh run of the stock engine
    (:mod:`.serve.registry`) under a full audit, on ``device`` (the card
    unless the caller asks for the CPU).  Exit 0: certified; exit 9
    (:class:`.runtime.supervisor.CorruptionError`): the failing invariants
    are named on stderr."""
    import argparse
    import json

    ap = argparse.ArgumentParser(
        prog="msbfs-tpu verify",
        description="Certify distance-to-set answers against the BFS "
        "invariants (docs/RESILIENCE.md)",
    )
    ap.add_argument("-g", "--graph", required=True, metavar="GRAPH.bin",
                    help="reference-format graph .bin")
    ap.add_argument("-q", "--query", required=True, metavar="QUERY.bin",
                    help="reference-format query .bin")
    ap.add_argument(
        "--expect-f", default=None, metavar="F",
        help="claimed F values to certify: a JSON list, or @PATH to a "
        "JSON file (e.g. a stored response's f_values).  Default: run "
        "the stock engine under a full audit and certify its output.",
    )
    ap.add_argument(
        "--weighted", action="store_true",
        help="certify against the weighted (edge-cost) invariants; "
        "also implied by MSBFS_WEIGHTED=1.  The graph must carry a "
        "cost section.",
    )
    args = ap.parse_args(argv)

    from .ops import certify
    from .runtime.supervisor import CorruptionError, InputError, MsbfsError
    from .utils.io import load_graph_bin, load_query_bin, pad_queries
    from .utils.report import format_failure

    weighted = args.weighted or knobs.raw("MSBFS_WEIGHTED", "") == "1"
    try:
        try:
            graph = load_graph_bin(args.graph, native=native)
            queries = pad_queries(load_query_bin(args.query))
        except (OSError, ValueError) as exc:
            raise InputError(str(exc)) from exc
        if weighted and not graph.has_weights:
            raise InputError(
                f"--weighted verify of {args.graph}: the artifact "
                "carries no edge-cost section (regenerate with "
                "gen_cli --weights)"
            )
        if args.expect_f is not None:
            raw = args.expect_f
            if raw.startswith("@"):
                try:
                    with open(raw[1:], "r", encoding="utf-8") as fh:
                        raw = fh.read()
                except OSError as exc:
                    raise InputError(str(exc)) from exc
            try:
                f_claimed = np.asarray(json.loads(raw), dtype=np.int64)
            except (ValueError, TypeError) as exc:
                raise InputError(
                    f"--expect-f is not a JSON int list: {exc}"
                ) from exc
            source = "stored F values"
        else:
            from .serve import registry

            if weighted:
                supervisor = registry.build_supervised_weighted_engine(graph, device, native)
                make = certify.make_weighted_auditor
                source = "weighted engine output"
            else:
                supervisor = registry.build_supervised_engine(graph, device, native)
                make = certify.make_auditor
                source = "engine output"
            # Full audit whatever MSBFS_AUDIT says: verification is the
            # point of this subcommand.
            if supervisor.auditor is None:
                supervisor.auditor = make(graph)
            supervisor.audit_sample = 1.0
            f_claimed = np.asarray(
                torch.as_tensor(supervisor.f_values(queries)).cpu(), dtype=np.int64
            )
        if weighted:
            failing = certify.audit_weighted_f_values(
                graph.row_offsets, graph.col_indices, graph.edge_weights,
                queries, f_claimed,
            )
        else:
            failing = certify.audit_f_values(
                graph.row_offsets, graph.col_indices, queries, f_claimed
            )
        if failing:
            raise CorruptionError(
                f"verification of {source} FAILED for {args.graph} / "
                f"{args.query}: invariants violated: "
                f"{', '.join(failing)}",
                invariants=failing,
            )
    except MsbfsError as err:
        from .utils.telemetry import dump_flight

        dump_flight(f"exit_{err.exit_code}")
        print(format_failure(err), end="", file=sys.stderr)
        return err.exit_code
    print(
        f"verify: CERTIFIED {source} — {queries.shape[0]} queries on "
        f"{graph.n} vertices / {graph.m} edges; "
        f"F = {[int(x) for x in np.atleast_1d(f_claimed)]}"
    )
    return 0


def main(argv: Optional[List[str]] = None, device=None, native: bool = True,
         mesh_devices=None) -> int:
    from .runtime.supervisor import (
        ChunkSupervisor,
        InputError,
        MsbfsError,
        RetryPolicy,
        classify,
    )
    from .utils import faults
    from .utils.report import format_failure
    from .utils.telemetry import dump_flight

    argv = list(sys.argv if argv is None else argv)

    def not_ported(what: str) -> int:
        err = InputError(f"{what} is not yet ported to the PyTorch/CUDA package")
        print(format_failure(err), end="", file=sys.stderr)
        return err.exit_code

    def failed(err, events=()) -> int:
        # A typed failure: the flight ring first (the post-mortem the
        # one-line report cannot carry), then the report, then its code.
        dump_flight(f"exit_{err.exit_code}")
        print(format_failure(err, events), end="", file=sys.stderr)
        return err.exit_code

    # The serving subcommands dispatch before the reference grammar, as in
    # the JAX CLI: ``serve`` runs the daemon (on the card unless ``device``
    # says otherwise), ``query`` the thin client, ``health`` the readiness
    # probe (``query --health``), ``trace`` the Chrome-trace export.
    if len(argv) > 1 and argv[1] == "serve":
        from .serve.server import serve_main

        return serve_main(argv[2:], device=device, native=native)
    if len(argv) > 1 and argv[1] in ("query", "health"):
        from .serve.client import query_main

        extra = ["--health"] if argv[1] == "health" else []
        return query_main(argv[2:] + extra)
    if len(argv) > 1 and argv[1] == "trace":
        from .serve.client import trace_main

        return trace_main(argv[2:])
    if len(argv) > 1 and argv[1] == "fleet":
        # The replicated fleet: N replica daemons of this package (on
        # ``device``, the card by default) behind the placement router.
        from .serve.router import fleet_main

        return fleet_main(argv[2:], device=device)
    if len(argv) > 1 and argv[1] == "verify":
        # Offline output certification: exit 0 certified, 9 corrupt.
        return verify_main(argv[2:], device=device, native=native)
    if len(argv) > 1 and argv[1] == "analyze":
        # The static passes over the port's own files (analysis/); they
        # import no torch.
        from .analysis.cli import analyze_main

        return analyze_main(argv[2:])
    if len(argv) < 5:  # argc < 5, reference main.cu:204-212
        print(
            f"Usage: python {argv[0] if argv else 'main.py'} "
            "-g <graph.bin> -q <query.bin> -gn <numChips>",
            file=sys.stderr,
        )
        return -1
    graph_file, query_file, num_gpu = parse_args(argv)
    if graph_file is None or query_file is None:
        print("Missing -g or -q argument", file=sys.stderr)
        return -1
    dev = resolve_device(device)
    # The fault plan goes in before any load, so the loader seams see it;
    # a fresh plan per call keeps repeated in-process runs deterministic,
    # and a malformed plan is an input error, not a plan that arms nothing.
    try:
        fault_plan = faults.FaultPlan.from_env()
    except ValueError as exc:
        err = InputError(str(exc))
        print(format_failure(err), end="", file=sys.stderr)
        return err.exit_code
    faults.activate(fault_plan)
    unported = _unported_knob()
    if unported:
        return not_ported(unported)

    from .ops.packed import SubBatchEngine
    from .ops.stencil import StencilEngine
    from .runtime.native_loader import NativeBuildError
    from .utils.io import load_graph_bin, load_query_bin, pad_queries
    from .utils.report import format_report
    from .utils.timing import (
        Span, dispatch_count, phase, phase_seconds, record_dispatch, record_phase,
        reset_dispatch_count, reset_phases,
    )

    # ---- preprocessing span: load + layout + upload + kernel build/warm-up
    # (main.cu:235-298; the reference compiles its kernels offline), split
    # into its phases for the record (layout, with its upload, is what the
    # others leave).
    reset_phases()
    with Span() as pre:
        with phase("load"):
            try:
                graph = load_graph_bin(graph_file, native=native)
            except NativeBuildError as exc:
                err = classify(exc)
                print(format_failure(err), end="", file=sys.stderr)
                return err.exit_code
            except (IOError, OSError, ValueError, IndexError) as exc:
                err = classify(exc)
                print(f"Could not open graph file {graph_file}", file=sys.stderr)
                print(format_failure(err), end="", file=sys.stderr)
                return err.exit_code
            try:
                queries = load_query_bin(query_file)
            except (IOError, OSError, ValueError, IndexError) as exc:
                err = classify(exc)
                print(f"Could not open query file {query_file}", file=sys.stderr)
                print(format_failure(err), end="", file=sys.stderr)
                return err.exit_code
            padded = pad_queries(queries)
        # -gn devices, clamped to the cards present (or to ``mesh_devices``,
        # which replaces the card list: a logical mesh for tests and the
        # smoke, as JAX's tests get theirs from XLA_FLAGS).
        if mesh_devices is not None:
            cards = list(mesh_devices)
        elif dev.type == "cuda":
            cards = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        else:
            cards = [dev]
        n_chips = max(1, min(num_gpu, len(cards)))
        # The weighted route runs on one device whatever -gn says, and takes
        # precedence over every other route, as in the JAX CLI.
        weighted_route = knobs.raw("MSBFS_WEIGHTED", "") == "1"
        explicit_chunk, level_chunk, megachunk = chunk_policy(graph)
        backend = knobs.raw("MSBFS_BACKEND", "auto")
        road_class = _road_class(graph)
        from .models.bell import BellGraph
        from .utils.platform import device_hbm_bytes

        hbm_need = BellGraph.estimate_hbm_bytes(
            graph.n, graph.num_directed_edges, max(32, padded.shape[0])
        )
        hbm_have = device_hbm_bytes(dev)
        hbm_warn = hbm_need > hbm_have and backend not in _NON_BITBELL_FOOTPRINT_BACKENDS

        def announce_chunk():
            # Only when the engine applies the bound and the degree profile
            # predicts a deep BFS (the JAX CLI's rule).
            if level_chunk and road_class:
                print(
                    "road-class degree profile: bounding bit-plane "
                    f"dispatches to {level_chunk} BFS levels "
                    "(MSBFS_LEVEL_CHUNK overrides)",
                    file=sys.stderr,
                )

        # The capacity rungs for the supervisor: armed on the default
        # route alone, as in the JAX CLI.
        ladder_rungs = []
        engine = None
        if weighted_route:
            # MSBFS_WEIGHTED=1: integer-cost distance-to-set by bucketed
            # delta-stepping (weighted/), F(U) a cost sum; the graph must
            # carry a cost section.  The flavor (MSBFS_WEIGHTED_ENGINE)
            # negotiates by capability tokens; an impossible ask fails
            # naming the missing tokens.
            from . import weighted as weighted_pkg

            try:
                wlabel, engine = weighted_pkg.negotiate_weighted_engine(
                    graph, device=dev, native=native
                )
            except InputError as err:
                print(format_failure(err), end="", file=sys.stderr)
                return err.exit_code
            except (TypeError, ValueError) as exc:
                print(str(exc), file=sys.stderr)
                return 1
            print(
                f"weighted route: {wlabel}, delta={engine.delta} "
                "(MSBFS_WEIGHTED_ENGINE / MSBFS_DELTA override)",
                file=sys.stderr,
            )
        elif n_chips > 1 and knobs.raw("MSBFS_MESH", "").strip():
            engine = mesh2d_route(graph, cards[:n_chips], level_chunk, announce_chunk, native)
            if isinstance(engine, int):
                return engine
        elif n_chips > 1:
            engine = mesh_route(
                graph, padded, cards[:n_chips], level_chunk, explicit_chunk, road_class,
                hbm_need, hbm_have, announce_chunk, native,
            )
            if isinstance(engine, int):
                return engine
        else:
            try:
                probed = stencil_probe(graph, dev, backend, level_chunk, explicit_chunk)
            except ValueError as exc:
                print(str(exc), file=sys.stderr)
                return 1
            if probed is not None:
                sg, stencil_chunk = probed
                print(
                    "banded adjacency detected: stencil engine "
                    f"({len(sg.offsets)} offsets, "
                    f"{int(sg.res_src.shape[0])} residual edges, "
                    f"{stencil_chunk or 'unbounded'} levels/dispatch; "
                    "MSBFS_STENCIL=0 disables)",
                    file=sys.stderr,
                )
                engine = StencilEngine(sg, level_chunk=stencil_chunk, megachunk=megachunk)
        # The low-K route: a handful of queries as byte planes (ops.lowk),
        # on auto when no earlier route took the graph; MSBFS_LOWK=0
        # disables, MSBFS_BACKEND=lowk forces, and MSBFS_STATS=2 keeps the
        # bitbell route, whose stepped loop carries the per-level trace.
        if engine is None and (
            backend == "lowk"
            or (
                backend == "auto"
                and not hbm_warn
                and 0 < padded.shape[0] <= knobs.get_int("MSBFS_LOWK_MAX_K", 4)
                and knobs.raw("MSBFS_LOWK", "") != "0"
                and knobs.raw("MSBFS_STATS", "") != "2"
            )
        ):
            from .ops.lowk import LowKEngine

            print(
                f"low-K fast path: byte-flag engine for "
                f"{padded.shape[0]} queries (MSBFS_LOWK=0 disables)",
                file=sys.stderr,
            )
            announce_chunk()
            engine = LowKEngine(
                BellGraph.from_host(graph, dev, native=native),
                level_chunk=level_chunk,
                megachunk=megachunk,
            )
        # The dense route only when asked for by name: the JAX CLI's auto
        # dense route fires on a TPU alone, and the port routes as it does
        # off a TPU.
        if engine is not None:
            pass  # stencil or low-K route above
        elif backend == "dense":
            # One (K, n_pad) @ (n_pad, n_pad) bf16 matmul a level (ops.dense).
            from .ops.dense import DenseGraph
            from .ops.engine import Engine

            engine = Engine(DenseGraph.from_host(graph, dev), level_chunk=level_chunk)
        elif backend == "vmap":
            # The distance loop over the flat CSR, a row a query (the CSR
            # pull kernel, ops.cuda_csr).
            from .ops.engine import Engine

            engine = Engine(graph.to_device(dev), level_chunk=level_chunk)
        elif backend == "mxu":
            # Tensor-core frontier expansion over densified adjacency
            # tiles, with the per-level push/matmul switch (ops.mxu).
            from .ops.mxu import MxuEngine, MxuGraph

            try:
                mg = MxuGraph.from_host(graph, dev, native=native)
            except ValueError as exc:
                # Tile cap exceeded: a user-facing engine-choice error.
                print(str(exc), file=sys.stderr)
                return 1
            announce_chunk()
            engine = MxuEngine(mg, level_chunk=level_chunk, megachunk=megachunk)
        elif backend == "pallas":
            # ELL-slab layout with the CUDA ELL kernel (ops.cuda_bfs).
            from .models.ell import EllGraph
            from .ops.engine import Engine

            engine = Engine(EllGraph.from_host(graph, dev), level_chunk=level_chunk)
        elif backend == "bell":
            # Pull-only byte planes over the forest (ops.bell): no dedup CSR.
            from .ops.bell import BellEngine

            engine = BellEngine(
                BellGraph.from_host(graph, dev, keep_sparse=False, native=native),
                level_chunk=level_chunk,
            )
        elif backend in ("push", "ppush"):
            # Frontier-compacted queue BFS for high-diameter, low-degree
            # graphs (ops.push): a queue a query, or one union queue of
            # bit-plane rows for the batch (ops.push_packed).
            from .ops.push import PaddedAdjacency, PushEngine
            from .ops.push_packed import PackedPushEngine

            try:
                adj = PaddedAdjacency.from_host(graph, dev, native=native)
            except ValueError as exc:
                # Degree beyond the width cap: an engine-choice error.
                print(str(exc), file=sys.stderr)
                return 1
            engine = (PushEngine if backend == "push" else PackedPushEngine)(adj)
        elif backend == "packed":
            # The query-minor (n, K) distances over the flat CSR
            # (ops.packed); MSBFS_EDGE_CHUNKS slices the plain pull's
            # (E, K) gather, the kernel makes none.
            from .ops.packed import PackedEngine

            engine = PackedEngine(
                graph.to_device(dev),
                edge_chunks=knobs.get_int("MSBFS_EDGE_CHUNKS", 1),
                level_chunk=level_chunk,
            )
        elif backend == "streamed":
            # The forest stays in host memory and streams through the
            # device every level (ops.streamed): the route for graphs
            # beyond even the in-memory streamed layout.
            from .ops.streamed import StreamedBitBellEngine

            engine = StreamedBitBellEngine(
                BellGraph.from_host(graph, False, keep_sparse=False, native=native), dev
            )
        else:
            # The default route: the bit-plane BELL forest (ops.bitbell).
            from .ops.bitbell import BitBellEngine

            if hbm_warn:
                # The hybrid layout would not fit: drop the dedup CSR, run
                # pure forest pulls in bounded gather segments, at most 8
                # levels between host syncs (the JAX CLI's configuration).
                streamed_chunk = (
                    min(level_chunk or _OVER_MEMORY_LEVEL_CHUNK, _OVER_MEMORY_LEVEL_CHUNK)
                    if explicit_chunk is None or explicit_chunk < 0
                    else level_chunk
                )
                if explicit_chunk == 0:
                    streamed_chunk = _OVER_MEMORY_LEVEL_CHUNK
                    print(
                        "MSBFS_LEVEL_CHUNK=0 would issue an unbounded "
                        "wide-plane dispatch on an over-HBM graph "
                        "(documented worker crash); clamping to 8 "
                        "levels/dispatch",
                        file=sys.stderr,
                    )
                print(
                    f"graph needs ~{hbm_need >> 20} MiB (hybrid "
                    f"layout) but one chip has {hbm_have >> 20} MiB: "
                    "dropping the hybrid CSR and streaming per-level "
                    "gathers within budget, "
                    f"{streamed_chunk or 'unbounded'} levels/dispatch "
                    "(slower, and a graph beyond even the streamed "
                    "layout may still exhaust memory; run with "
                    "-gn > 1 to auto-shard instead)",
                    file=sys.stderr,
                )
                engine = BitBellEngine(
                    BellGraph.from_host(graph, dev, keep_sparse=False, native=native),
                    sparse_budget=0,
                    level_chunk=streamed_chunk,
                    megachunk=1,
                    slot_budget=(
                        _OVER_MEMORY_SLOT_BUDGET
                        if not knobs.raw("MSBFS_SLOT_BUDGET")
                        else None
                    ),
                )
            else:
                announce_chunk()
                engine = BitBellEngine(
                    BellGraph.from_host(graph, dev, native=native),
                    level_chunk=level_chunk,
                    megachunk=megachunk,
                )
                ladder_rungs = bitbell_ladder(graph, level_chunk, dev, native)
        subbatch_k = knobs.get_int("MSBFS_SUBBATCH_K", 256)
        if n_chips == 1 and subbatch_k > 0 and padded.shape[0] > subbatch_k:
            print(
                f"wide batch: splitting {padded.shape[0]} queries into "
                f"{subbatch_k}-wide sub-batches (MSBFS_SUBBATCH_K=0 "
                "disables)",
                file=sys.stderr,
            )
            engine = SubBatchEngine(engine, batch_k=subbatch_k)
        # Every engine call from here on is supervised: watchdog, typed
        # errors, transient retry with backoff, the capacity ladder.
        engine = ChunkSupervisor(
            engine,
            policy=RetryPolicy(
                max_retries=knobs.get_int("MSBFS_RETRIES", 2),
                base_delay=knobs.get_float("MSBFS_BACKOFF", 0.1),
                seed=knobs.get_int("MSBFS_FAULT_SEED", 0),
            ),
            watchdog=knobs.get_float("MSBFS_WATCHDOG", 0.0) or None,
            ladder=ladder_rungs,
            plan=fault_plan,
        )
        if weighted_route:
            # MSBFS_AUDIT certifies every sampled F against the weighted
            # certificate (ops.certify.WEIGHTED_INVARIANTS); a flunk
            # escalates to CorruptionError, exit 9.
            from .ops.certify import make_weighted_auditor
            from .serve.registry import audit_sample_rate

            audit_rate = audit_sample_rate()
            if audit_rate > 0.0:
                engine.auditor = make_weighted_auditor(graph)
                engine.audit_sample = audit_rate
        stats_env = knobs.raw("MSBFS_STATS", "")
        stats_mode = stats_env in ("1", "2")
        # MSBFS_STATS=2: also trace each BFS level through the engine's
        # stepped loop, where it has one.
        stats_level = stats_env == "2" and callable(getattr(engine, "level_stats", None))
        ckpt_path = knobs.raw("MSBFS_CHECKPOINT")
        ckpt_chunk = knobs.get_int("MSBFS_CHECKPOINT_CHUNK", 64)
        try:
            with phase("compile"):
                if ckpt_path:
                    # The checkpoint runner calls f_values/query_stats on
                    # (chunk, S) slices, not best() on the whole batch: warm
                    # exactly those shapes.
                    k, s = padded.shape
                    for shape_k in {min(max(1, ckpt_chunk), max(k, 1)), *(
                        [k % ckpt_chunk] if k % ckpt_chunk else []
                    )}:
                        dummy = np.full((shape_k, s), -1, dtype=np.int32)
                        if not (stats_mode and engine.query_stats(dummy) is not None):
                            engine.f_values(dummy)
                else:
                    engine.compile(
                        padded.shape,
                        warm_stats=stats_mode and not stats_level,
                        warm_levels=stats_level,
                    )
        except MsbfsError as err:
            # The supervisor's recovery budget ran out during warm-up.
            return failed(err, engine.events)
    record_phase("layout", pre.seconds - sum(phase_seconds().values()))

    # ---- computation span: all BFS + objective + argmin (main.cu:301-400).
    # MSBFS_PROFILE_DIR traces exactly the span; the trace is written after
    # it closes, outside the reported time.
    from .utils.trace import profiler_trace

    stats = None
    level_rows = None
    reset_dispatch_count()
    try:
        with profiler_trace(device=dev), Span() as comp:
            if ckpt_path:
                from .ops.objective import select_best
                from .utils.checkpoint import CheckpointedRunner

                runner = CheckpointedRunner(
                    engine, ckpt_path, chunk=ckpt_chunk, stats=stats_mode
                )
                try:
                    f_arr, _ = runner.run(
                        graph.n, graph.num_directed_edges, np.asarray(padded)
                    )
                except MsbfsError:
                    raise
                except ValueError as exc:
                    # A stale or foreign journal: fail loud.
                    print(f"Checkpoint error: {exc}", file=sys.stderr)
                    return 1
                if (
                    stats_mode
                    and padded.shape[0]
                    and runner.last_stats is not None
                    and (runner.last_stats[0] >= 0).any()
                ):
                    # -1 rows are F-only rows resumed from a stats-less
                    # journal; the selection below derives from stats[2].
                    stats = (*runner.last_stats, f_arr)
                else:
                    if stats_mode and padded.shape[0] and runner.last_stats is not None:
                        sys.stderr.write(
                            "MSBFS_STATS: the resumed journal predates "
                            "stats journaling (F-only rows); delete it "
                            "to recompute with stats\n"
                        )
                        stats_mode = False  # suppress the generic note
                    arr = torch.from_numpy(f_arr)
                    min_f, min_k = (int(x) for x in select_best(arr, arr >= 0))
                    record_dispatch()
            elif stats_mode and padded.shape[0]:
                # One BFS pass serves the report and the stats table.
                if stats_level:
                    levels, reached, f, lvl_counts, lvl_secs = engine.level_stats(
                        np.asarray(padded)
                    )
                    stats = (levels, reached, f)
                    level_rows = (lvl_counts, lvl_secs)
                else:
                    stats = engine.query_stats(np.asarray(padded))
            if stats is not None:
                from .ops.objective import select_best

                f = torch.as_tensor(np.asarray(stats[2], dtype=np.int64))
                min_f, min_k = (int(x) for x in select_best(f, f >= 0))
                record_dispatch()
            elif not ckpt_path:
                min_f, min_k = engine.best(np.asarray(padded))
    except MsbfsError as err:
        return failed(err, engine.events)

    if stats_mode:
        # Blocking device reads of the computation span.
        sys.stderr.write(f"dispatch_count: {dispatch_count()}\n")
    if stats is not None:
        # Per-query diagnostics to stderr (stdout stays reference-exact).
        from .utils.trace import format_level_stats, format_query_stats

        if level_rows is not None:
            sys.stderr.write(format_level_stats(*level_rows))
            halo = getattr(engine, "last_halo_trace", None)
            if halo:
                from .utils.trace import format_halo_stats

                sys.stderr.write(format_halo_stats(halo))
        elif stats_env == "2":
            sys.stderr.write(
                "MSBFS_STATS=2: per-level trace not available "
                + ("under checkpointing" if ckpt_path else "on this engine")
                + "; per-query stats only\n"
            )
        sys.stderr.write(format_query_stats(*stats))
    elif stats_mode:
        if padded.shape[0] == 0:
            sys.stderr.write("MSBFS_STATS: no queries\n")
        else:
            sys.stderr.write(
                "MSBFS_STATS: per-query stats are not available on this "
                "engine; ignored for this run\n"
            )

    sys.stdout.write(
        format_report(
            graph_path=graph_file,
            query_path=query_file,
            min_k=min_k,
            min_f=min_f,
            num_gpu=num_gpu,
            preprocessing_time=pre.seconds,
            computation_time=comp.seconds,
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())

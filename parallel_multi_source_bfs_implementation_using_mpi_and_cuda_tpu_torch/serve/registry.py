"""Supervised engine builders of the serving registry (the JAX package's
serve/registry.py), holding only what the CLI calls: the ``MSBFS_AUDIT``
rate, the stock single-device route under the engine lattice (the
``verify`` subcommand's engine), and the weighted route's engine.

The daemon, its graph entries and the mxu route's content-digest tile
cache come with serving; here the mxu candidate builds its tiles anew.
"""

from __future__ import annotations

from ..runtime.supervisor import ChunkSupervisor, RetryPolicy
from ..utils import knobs


def audit_sample_rate() -> float:
    """``MSBFS_AUDIT``: ``off``/unset/``0`` disables, ``full``/``1`` audits
    every f_values call, a float in (0, 1) that sampled share; a malformed
    value is off."""
    raw = knobs.raw("MSBFS_AUDIT", "").strip().lower()
    if raw in ("", "off", "0"):
        return 0.0
    if raw in ("full", "1"):
        return 1.0
    try:
        rate = float(raw)
    except ValueError:
        return 0.0
    return min(max(rate, 0.0), 1.0)


def _supervise(engine, ladder=(), auditor=None, sample=0.0) -> ChunkSupervisor:
    """The batch CLI's supervisor knobs around ``engine``."""
    return ChunkSupervisor(
        engine,
        policy=RetryPolicy(
            max_retries=knobs.get_int("MSBFS_RETRIES", 2),
            base_delay=knobs.get_float("MSBFS_BACKOFF", 0.1),
            seed=knobs.get_int("MSBFS_FAULT_SEED", 0),
        ),
        watchdog=knobs.get_float("MSBFS_WATCHDOG", 0.0) or None,
        ladder=ladder,
        auditor=auditor,
        audit_sample=sample,
    )


def build_supervised_engine(graph, device=None, native: bool = True) -> ChunkSupervisor:
    """The stock route under the supervisor: the stencil probe as the
    batch CLI runs it, else the engine lattice (``MSBFS_BACKEND`` vmap,
    mxu or lowk by name, ``csr`` as vmap, every other name bitbell, with
    its capacity ladder).  Audited against the host-CSR certificate when
    ``MSBFS_AUDIT`` is armed.

    The lattice's choice copies the JAX registry's, not the batch CLI's
    (``MSBFS_BACKEND=push`` runs bitbell here, as it does under JAX's
    ``verify``); the chunk policy, the stencil probe and the ladder are
    the CLI's own functions."""
    from ..cli import bitbell_ladder, chunk_policy, resolve_device, stencil_probe
    from ..models.bell import BellGraph
    from ..ops.bitbell import BitBellEngine
    from ..ops.engine import Engine, negotiate_engine, resolve_axes
    from ..ops.lowk import LowKEngine
    from ..ops.mxu import MxuEngine, MxuGraph
    from ..ops.stencil import StencilEngine

    dev = resolve_device(device)
    explicit_chunk, level_chunk, megachunk = chunk_policy(graph)
    backend = knobs.raw("MSBFS_BACKEND", "auto")
    ladder = []
    probed = stencil_probe(graph, dev, backend, level_chunk, explicit_chunk)
    if probed is not None:
        sg, stencil_chunk = probed
        label = "stencil"
        engine = StencilEngine(sg, level_chunk=stencil_chunk, megachunk=megachunk)
    else:
        routed = backend if backend in ("vmap", "mxu", "lowk") else (
            "vmap" if backend == "csr" else "bitbell"
        )
        _, required = resolve_axes(routed)
        label, engine = negotiate_engine(
            required,
            [
                ("bitbell", BitBellEngine, lambda: BitBellEngine(
                    BellGraph.from_host(graph, dev, native=native),
                    level_chunk=level_chunk, megachunk=megachunk)),
                ("lowk", LowKEngine, lambda: LowKEngine(
                    BellGraph.from_host(graph, dev, native=native),
                    level_chunk=level_chunk, megachunk=megachunk)),
                ("mxu", MxuEngine, lambda: MxuEngine(
                    MxuGraph.from_host(graph, dev, native=native),
                    level_chunk=level_chunk, megachunk=megachunk)),
                ("vmap", Engine, lambda: Engine(
                    graph.to_device(dev), level_chunk=level_chunk)),
            ],
        )
        if label == "bitbell":
            ladder = bitbell_ladder(graph, level_chunk, dev, native)
    sample = audit_sample_rate()
    auditor = None
    if sample > 0.0:
        from ..ops.certify import make_auditor

        auditor = make_auditor(graph)
    sup = _supervise(engine, ladder, auditor, sample)
    sup.engine_label = label
    return sup


def build_supervised_weighted_engine(graph, device=None, native: bool = True) -> ChunkSupervisor:
    """The weighted route under the supervisor: a delta-stepping engine
    negotiated by flavor (``MSBFS_WEIGHTED_ENGINE``), audited against the
    weighted certificate when ``MSBFS_AUDIT`` is armed.  Raises
    InputError on a weightless graph."""
    from ..cli import resolve_device
    from ..weighted import negotiate_weighted_engine

    _, engine = negotiate_weighted_engine(
        graph, device=resolve_device(device), native=native
    )
    sample = audit_sample_rate()
    auditor = None
    if sample > 0.0:
        from ..ops.certify import make_weighted_auditor

        auditor = make_weighted_auditor(graph)
    return _supervise(engine, auditor=auditor, sample=sample)

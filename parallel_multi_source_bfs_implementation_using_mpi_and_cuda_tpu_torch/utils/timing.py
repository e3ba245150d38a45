"""Two-span wall-clock timing and the process-wide engine counters.

The spans mirror the reference's report (main.cu:235-298 preprocessing,
main.cu:301-400 computation); kernel builds and warm-up are charged to
preprocessing, as the reference's kernels are compiled offline by nvcc.
CUDA work is asynchronous, so a span must close after a host read of the
result (the engines' status reads are such syncs).  The CLI splits its
preprocessing span into named phases (:func:`phase`): ``load`` (graph and
query files), ``compile`` (``engine.compile``: kernel build and warm-up)
and ``layout``, the rest (dedup, the stencil probe, the BELL/ELL/tile
builds and their host->device copies, the engine's set-up);
:func:`phase_seconds` reads them.

Counters (thread-safe; serving threads may drive engines concurrently):

* dispatches — host syncs: every blocking device->host read the level
  loop waits on (one per level chunk, plus result reads);
* plane-pass bytes — the analytic full-plane-equivalent bytes each
  stencil level chunk streams (ops.stencil.stencil_level_bytes);
* mxu tiles — analytic tile FLOPs and zero-tile skip counts per chunk of
  mxu levels (ops.mxu.MxuEngine._account);
* kernel launches — one count per hand-written CUDA kernel launch, by
  kernel name, recorded by the wrapper right after a launch succeeds; a
  kernel with specialised variants also counts each launch under
  "name:variant" in a separate tally (:func:`variant_counts`).
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict


class Span:
    """``with Span() as s: ...`` then ``s.seconds``."""

    def __init__(self):
        self.seconds = 0.0
        self._t0 = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self._t0
        return False


_lock = threading.Lock()
_phases: Dict[str, float] = {}
_dispatches = 0
_plane_pass_bytes = 0
_launches: Dict[str, int] = {}
_variants: Dict[str, int] = {}


@contextlib.contextmanager
def phase(name: str):
    """Add the wall time of the block to the named preprocessing phase."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        record_phase(name, time.perf_counter() - t0)


def record_phase(name: str, seconds: float) -> None:
    with _lock:
        _phases[name] = _phases.get(name, 0.0) + seconds


def phase_seconds() -> Dict[str, float]:
    """Seconds per phase since the last :func:`reset_phases`."""
    with _lock:
        return dict(_phases)


def reset_phases() -> None:
    with _lock:
        _phases.clear()


def record_dispatch(n: int = 1) -> None:
    """Count ``n`` host syncs (device->host reads the host waited on)."""
    global _dispatches
    with _lock:
        _dispatches += int(n)


def dispatch_count() -> int:
    """Host syncs recorded since the last :func:`reset_dispatch_count`."""
    with _lock:
        return _dispatches


def reset_dispatch_count() -> None:
    global _dispatches
    with _lock:
        _dispatches = 0


def record_plane_pass(nbytes: int) -> None:
    """Account ``nbytes`` of analytic plane traffic: stencil level chunks
    and the dynamic repair's cone or its full-sweep fallback."""
    global _plane_pass_bytes
    with _lock:
        _plane_pass_bytes += int(nbytes)


def plane_pass_bytes() -> int:
    with _lock:
        return _plane_pass_bytes


def reset_plane_pass() -> None:
    global _plane_pass_bytes
    with _lock:
        _plane_pass_bytes = 0


_mxu_flops = 0
_mxu_tiles_skipped = 0
_mxu_tiles_total = 0


def record_mxu_tiles(flops: int, skipped: int, total: int) -> None:
    """Account mxu level expansions: ``flops`` analytic tile FLOPs issued,
    ``skipped`` all-zero tiles elided of ``total`` tiles in the full
    (ntr x ntr) grid.  An issued-if-matmul model: push levels count at
    the matmul rate (exact under MSBFS_MXU_SWITCH=0)."""
    global _mxu_flops, _mxu_tiles_skipped, _mxu_tiles_total
    with _lock:
        _mxu_flops += int(flops)
        _mxu_tiles_skipped += int(skipped)
        _mxu_tiles_total += int(total)


def mxu_tile_counts():
    """(flops, tiles_skipped, tiles_total) since :func:`reset_mxu_tiles`."""
    with _lock:
        return _mxu_flops, _mxu_tiles_skipped, _mxu_tiles_total


def reset_mxu_tiles() -> None:
    global _mxu_flops, _mxu_tiles_skipped, _mxu_tiles_total
    with _lock:
        _mxu_flops = _mxu_tiles_skipped = _mxu_tiles_total = 0


def counter_totals() -> dict:
    """The engine counters in one dict (the ``metrics`` verb's gauges):
    dispatches, plane_pass_bytes, mxu_flops/mxu_tiles_skipped/
    mxu_tiles_total."""
    flops, skipped, total = mxu_tile_counts()
    return {
        "dispatches": dispatch_count(),
        "plane_pass_bytes": plane_pass_bytes(),
        "mxu_flops": flops,
        "mxu_tiles_skipped": skipped,
        "mxu_tiles_total": total,
    }


def record_launch(kernel: str, variant: str = "") -> None:
    """Count one launch of the named CUDA kernel (and of its variant)."""
    with _lock:
        _launches[kernel] = _launches.get(kernel, 0) + 1
        if variant:
            key = f"{kernel}:{variant}"
            _variants[key] = _variants.get(key, 0) + 1


def launch_counts() -> Dict[str, int]:
    """Launches per kernel name since the last :func:`reset_launch_counts`."""
    with _lock:
        return dict(_launches)


def variant_counts() -> Dict[str, int]:
    """Launches per "kernel:variant" since :func:`reset_launch_counts`."""
    with _lock:
        return dict(_variants)


def reset_launch_counts() -> None:
    with _lock:
        _launches.clear()
        _variants.clear()

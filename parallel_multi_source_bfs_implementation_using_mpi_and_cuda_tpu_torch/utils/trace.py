"""Tracing beyond the reference's two wall-clock spans; stdout stays
reference-exact, everything here goes to stderr or to files.

* :func:`profiler_trace`: a ``torch.profiler`` trace of the CLI's
  computation span into ``MSBFS_PROFILE_DIR`` (the JAX package writes a
  ``jax.profiler`` xplane directory there; the port writes torch's
  Chrome-trace JSON, for Perfetto or chrome://tracing);
* :func:`format_query_stats` (``MSBFS_STATS=1``: levels run, vertices
  reached and F per query) and :func:`format_level_stats` (``=2``: the
  stepped per-level trace), the JAX package's formatters.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Iterator, Optional, Sequence


@contextlib.contextmanager
def profiler_trace(log_dir: Optional[str] = None, device=None) -> Iterator[Optional[str]]:
    """Trace the block with ``torch.profiler`` into ``log_dir`` (else
    ``$MSBFS_PROFILE_DIR``): CPU activity, and the card's kernels and
    copies when ``device`` is a CUDA device.  Yields the path the trace
    will be written to, or None, doing nothing, when no directory is set.

    The trace is written after the block, so its cost falls outside a
    span timed inside it; the top-level key ``msbfs_launches`` holds the
    hand-written kernels' launch counts over the block
    (:func:`.timing.launch_counts`).  A trace that cannot be taken is a
    typed failure, never a quiet run without one: an unusable directory
    is an ``InputError``, a profiler that cannot trace the card (no CUPTI)
    or saw none of its activity while kernels ran is an ``MsbfsError``."""
    from . import knobs

    log_dir = log_dir or knobs.raw("MSBFS_PROFILE_DIR")
    if not log_dir:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule, supported_activities

    from ..runtime.supervisor import InputError, MsbfsError
    from .timing import launch_counts

    on_card = device is not None and torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CPU]
    if on_card:
        if ProfilerActivity.CUDA not in supported_activities():
            raise MsbfsError("MSBFS_PROFILE_DIR: this torch cannot trace the card (no CUPTI)")
        activities.append(ProfilerActivity.CUDA)
    try:
        os.makedirs(log_dir, exist_ok=True)
    except OSError as exc:
        raise InputError(f"MSBFS_PROFILE_DIR={log_dir!r}: {exc}") from exc
    path = os.path.join(log_dir, f"msbfs.{os.getpid()}.{time.time_ns()}.pt.trace.json")
    # The profiler starts in a warm-up step (tracing on, its results
    # discarded) that runs one device operation to completion, so that
    # the recorded window, from the next step on, opens on a running
    # tracer; both stay outside the block and the trace.
    prof = profile(activities=activities, schedule=schedule(wait=0, warmup=1, active=1),
                   acc_events=True)  # events() is read after stop
    try:
        prof.start()
    except RuntimeError as exc:
        raise MsbfsError(f"MSBFS_PROFILE_DIR: the profiler did not start: {exc}") from exc
    if on_card:
        torch.ones(1, device=device).add_(1)
        torch.cuda.synchronize(device)
    prof.step()
    before = launch_counts()
    try:
        yield path
        after = launch_counts()
        launched = {k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)}
        # Metadata goes in while the profiler runs.
        prof.add_metadata_json("msbfs_launches", json.dumps(launched, sort_keys=True))
    finally:
        prof.stop()
    if on_card and launched and not any(
        e.device_type == torch.autograd.DeviceType.CUDA for e in prof.events()
    ):
        raise MsbfsError(
            f"MSBFS_PROFILE_DIR: the profiler saw no device activity while "
            f"{sum(launched.values())} kernel launches ran"
        )
    try:
        prof.export_chrome_trace(path)
    except OSError as exc:
        raise InputError(f"MSBFS_PROFILE_DIR: cannot write {path}: {exc}") from exc


def format_level_stats(level_counts, level_seconds) -> str:
    """Per-level trace table: one line per executed BFS level with the
    vertices discovered at that distance (summed over queries), the
    queries still active, and the level's wall time.  Row 0 is the
    source packing (distance-0 vertices)."""
    lines = ["level  discovered  active_queries  seconds"]
    for d, (counts, sec) in enumerate(zip(level_counts, level_seconds)):
        total = int(sum(int(c) for c in counts))
        active = int(sum(1 for c in counts if int(c) > 0))
        lines.append(f"{d:5d}  {total:10d}  {active:14d}  {float(sec):.6f}")
    return "\n".join(lines) + "\n"


def format_query_stats(
    levels: Sequence[int], reached: Sequence[int], f_values: Sequence[int]
) -> str:
    """Per-query stats table, one line per query, 1-based ids as in the
    report (main.cu:409)."""
    lines = ["query  levels  reached  F"]
    for i, (lv, rc, fv) in enumerate(zip(levels, reached, f_values)):
        lines.append(f"{i + 1:5d}  {int(lv):6d}  {int(rc):7d}  {int(fv)}")
    return "\n".join(lines) + "\n"

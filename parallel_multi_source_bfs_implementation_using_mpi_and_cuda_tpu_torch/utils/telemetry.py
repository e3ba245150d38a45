"""Telemetry the batch CLI and the supervisor call: trace spans and
instant markers, and the flight recorder.

The port's copy of the parts of the JAX package's utils/telemetry.py that
the batch path reaches.  :func:`span` and :func:`instant` record into the
thread's installed trace and do nothing without one; nothing installs one
yet (the trace store, its Chrome-trace export, the histograms and the
metrics registry come with serving), so here they are no-ops.

The flight recorder is a bounded ring of recent structured events (the
supervisor's audit failures, ...).  :func:`dump_flight` appends the ring
and a trailing ``flight_dump`` marker as JSONL to
``MSBFS_FLIGHT_RECORDER`` on a typed-failure exit, the same lines the
JAX package writes.
"""

from __future__ import annotations

import collections
import json
import os
import sys
import time
from contextlib import contextmanager
from typing import List, Optional

from . import knobs


class _NoopHandle:
    __slots__ = ()

    def set(self, **kw) -> None:
        pass


_NOOP = _NoopHandle()


def current_trace():
    """The thread's installed trace: always None until the trace store
    comes with serving (nothing can install one yet)."""
    return None


@contextmanager
def span(name: str, **attrs):
    """A complete span on the current trace: a no-op handle here, since
    no trace is ever installed."""
    yield _NOOP


def instant(name: str, **attrs) -> None:
    """A zero-duration marker on the current trace: a no-op here."""


FLIGHT_RING_SIZE = 256


class FlightRecorder:
    """Bounded ring of recent structured events: ``record`` is one
    deque append; serialisation is paid only at :meth:`dump`."""

    def __init__(self, maxlen: int = FLIGHT_RING_SIZE):
        self._ring: "collections.deque[dict]" = collections.deque(maxlen=maxlen)

    def record(self, kind: str, **fields) -> None:
        fields["ts"] = round(time.time(), 6)
        fields["kind"] = kind
        self._ring.append(fields)

    def snapshot(self) -> List[dict]:
        return list(self._ring)

    def clear(self) -> None:
        self._ring.clear()

    def dump(self, reason: str, path: Optional[str] = None) -> Optional[str]:
        """Append the ring and a trailing ``flight_dump`` marker as JSONL
        to ``path`` (default ``MSBFS_FLIGHT_RECORDER``); returns the path
        written, or None when no path is configured or the write failed."""
        if path is None:
            path = flight_path()
        if not path:
            return None
        events = self.snapshot()
        events.append({
            "ts": round(time.time(), 6),
            "kind": "flight_dump",
            "reason": str(reason),
            "pid": os.getpid(),
            "events": len(events),
        })
        try:
            with open(path, "a", encoding="utf-8") as fh:
                for ev in events:
                    fh.write(json.dumps(ev, default=str) + "\n")
        except OSError as exc:
            print(f"msbfs: flight recorder dump to {path} failed: {exc}",
                  file=sys.stderr)
            return None
        return path


def flight_path() -> Optional[str]:
    return knobs.raw("MSBFS_FLIGHT_RECORDER") or None


_FLIGHT = FlightRecorder()


def flight_recorder() -> FlightRecorder:
    return _FLIGHT


def record_flight(kind: str, **fields) -> None:
    _FLIGHT.record(kind, **fields)


def dump_flight(reason: str) -> Optional[str]:
    """Dump the process ring if ``MSBFS_FLIGHT_RECORDER`` names a path;
    the CLI's typed-failure exits call this."""
    return _FLIGHT.dump(reason)

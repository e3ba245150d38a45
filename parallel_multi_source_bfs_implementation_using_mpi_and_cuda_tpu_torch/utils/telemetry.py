"""Unified telemetry: per-query tracing, metrics, flight recorder.

The port's copy of the JAX package's utils/telemetry.py: three
observability primitives shared by every layer of the serving stack
(the JAX package's docs/OBSERVABILITY.md is the operator manual):

* **Per-query distributed traces.**  A :class:`TraceContext` is a
  trace id that rides the wire protocol as an optional ``trace`` field
  on request frames (legacy peers ignore unknown fields, same
  tolerated-absent posture as the crc rollout).  Each process installs
  the context thread-locally (:func:`use_trace`) and the instrumented
  hops — router legs, batcher admission, supervisor retries, engine
  level chunks — record spans into a bounded in-process store, keyed by
  trace id.  :func:`chrome_trace` renders a span list as Chrome-trace /
  Perfetto JSON (``chrome://tracing`` or https://ui.perfetto.dev).
  Span timestamps are epoch microseconds so spans from different
  processes (router vs replica) land on one comparable clock; pid/tid
  separate the tracks.  When no context is installed every span call is
  a single thread-local read — the serve path's fault-free overhead.

* **A metrics registry** with counter/gauge/histogram types rendered in
  Prometheus text exposition format.  Latency histograms use FIXED log2
  bucket bounds (:data:`LATENCY_BUCKETS_MS`) so histograms from
  different replicas merge by per-bucket addition — the fleet roll-up
  can finally aggregate latency distributions instead of dropping them.

* **A flight recorder**: a bounded, lock-cheap ring of recent
  structured events (batch shed, audit fail, vote mismatch, brownout
  transition, reshard, mutate...).  :func:`dump_flight` appends the
  ring as JSONL to ``MSBFS_FLIGHT_RECORDER`` on any typed-error exit or
  SIGTERM, leaving a machine-readable postmortem of the last moments.

Everything here is dependency-free stdlib, so the engines' drive loops
import it at no cost.  The batch CLI installs no trace, so its spans and
instants stay the single thread-local read they were before serving.
"""

from __future__ import annotations

import collections
import json
import os
import re
import sys
import threading
import time
from contextlib import contextmanager
from typing import Dict, Iterable, List, Optional

from . import knobs

# ---------------------------------------------------------------------------
# Trace context + span store
# ---------------------------------------------------------------------------

_TLS = threading.local()

# trace_id -> list of chrome events; bounded LRU so a long-lived daemon
# serving millions of queries holds only the most recent traces.
_TRACES: "collections.OrderedDict[str, List[dict]]" = collections.OrderedDict()
_TRACES_LOCK = threading.Lock()
MAX_TRACES = 64
MAX_EVENTS_PER_TRACE = 4096


class TraceContext:
    """One query's trace identity.  Deliberately tiny — the span data
    lives in the per-process store, only the id crosses the wire."""

    __slots__ = ("trace_id",)

    def __init__(self, trace_id: str):
        self.trace_id = str(trace_id)

    def to_wire(self) -> dict:
        return {"trace_id": self.trace_id}

    @classmethod
    def from_wire(cls, obj) -> Optional["TraceContext"]:
        """Tolerant parse of a frame's ``trace`` field: anything that is
        not a dict with a sane string trace_id reads as "no trace" — a
        malformed field from a buggy peer must never fail a query."""
        if not isinstance(obj, dict):
            return None
        tid = obj.get("trace_id")
        if not isinstance(tid, str) or not (1 <= len(tid) <= 64):
            return None
        return cls(tid)


def new_trace() -> TraceContext:
    return TraceContext(os.urandom(8).hex())


def trace_enabled() -> bool:
    """``MSBFS_TRACE``: unset/``0``/``off`` disable (default), anything
    else enables client-edge trace creation.  Servers do not read this —
    they adopt whatever trace rides the request, so only the edge that
    ORIGINATES queries needs the knob."""
    raw = knobs.raw("MSBFS_TRACE", "").strip().lower()
    return raw not in ("", "0", "off")


def current_trace() -> Optional[TraceContext]:
    return getattr(_TLS, "ctx", None)


@contextmanager
def use_trace(ctx: Optional[TraceContext]):
    """Install ``ctx`` as this thread's active trace for the block
    (None = explicitly no trace).  Restores the previous context on
    exit, so nested installs (batcher thread serving one batch inside a
    long-lived worker) unwind correctly."""
    prev = getattr(_TLS, "ctx", None)
    _TLS.ctx = ctx
    try:
        yield ctx
    finally:
        _TLS.ctx = prev


def record_span_event(trace_id: str, event: dict) -> None:
    with _TRACES_LOCK:
        events = _TRACES.get(trace_id)
        if events is None:
            while len(_TRACES) >= MAX_TRACES:
                _TRACES.popitem(last=False)
            events = []
            _TRACES[trace_id] = events
        else:
            _TRACES.move_to_end(trace_id)
        if len(events) < MAX_EVENTS_PER_TRACE:
            events.append(event)


def trace_events(trace_id: str) -> List[dict]:
    """Copy of the stored events for ``trace_id`` (empty when unknown —
    a replica that served none of the query's hops answers empty, and
    the front end's merge simply concatenates)."""
    with _TRACES_LOCK:
        return list(_TRACES.get(trace_id, ()))


def known_traces() -> List[str]:
    """Most-recent-last trace ids currently held (the ``trace`` verb's
    discovery mode: ask for the latest without knowing its id)."""
    with _TRACES_LOCK:
        return list(_TRACES)


def clear_traces() -> None:
    with _TRACES_LOCK:
        _TRACES.clear()


class _SpanHandle:
    """Mutable args bag yielded by :func:`span` so the body can attach
    attributes discovered mid-span (``h.set(bucket="64x128")``)."""

    __slots__ = ("args",)

    def __init__(self, args: dict):
        self.args = args

    def set(self, **kw) -> None:
        self.args.update(kw)


class _NoopHandle:
    __slots__ = ()

    def set(self, **kw) -> None:
        pass


_NOOP = _NoopHandle()


def span_begin():
    """Low-level begin marker for hot loops that cannot afford a
    contextmanager per iteration: returns an opaque (wall_us, perf)
    pair for :func:`span_end`."""
    return (time.time(), time.perf_counter())


def span_end(ctx: TraceContext, name: str, begin, **attrs) -> None:
    wall, perf0 = begin
    record_span_event(ctx.trace_id, {
        "name": name,
        "ph": "X",
        "ts": int(wall * 1e6),
        "dur": max(0, int((time.perf_counter() - perf0) * 1e6)),
        "pid": os.getpid(),
        "tid": threading.get_ident(),
        "args": attrs,
    })


@contextmanager
def span(name: str, **attrs):
    """One complete span (``ph: "X"``) on the current trace; a no-op
    handle when no trace is installed — the overhead gate."""
    ctx = current_trace()
    if ctx is None:
        yield _NOOP
        return
    begin = span_begin()
    handle = _SpanHandle(dict(attrs))
    try:
        yield handle
    finally:
        span_end(ctx, name, begin, **handle.args)


def instant(name: str, **attrs) -> None:
    """A zero-duration marker (``ph: "i"``) on the current trace — the
    supervisor's retry/audit/degrade events, the batcher's sheds."""
    ctx = current_trace()
    if ctx is None:
        return
    record_span_event(ctx.trace_id, {
        "name": name,
        "ph": "i",
        "s": "t",
        "ts": int(time.time() * 1e6),
        "pid": os.getpid(),
        "tid": threading.get_ident(),
        "args": attrs,
    })


def chrome_trace(events: Iterable[dict]) -> dict:
    """Span events -> the Chrome-trace JSON object Perfetto loads."""
    return {"traceEvents": list(events), "displayTimeUnit": "ms"}


# ---------------------------------------------------------------------------
# Metrics: histogram with fixed log2 buckets + Prometheus registry
# ---------------------------------------------------------------------------

# Fixed latency bucket upper bounds in milliseconds: 1ms .. ~16s, log2.
# FIXED so any two histograms (this process vs a replica across the
# fleet) merge by per-bucket addition; changing these bounds is a wire
# compat change for the fleet roll-up.
LATENCY_BUCKETS_MS = tuple(float(1 << i) for i in range(15))


class Histogram:
    """Counts per fixed bucket + sum; mergeable, percentile-queryable.

    ``percentile`` answers the smallest bucket UPPER BOUND covering the
    rank — a conservative (never-underestimating) quantile, which is
    the right direction for an SLO readout.  Overflow observations
    report the last finite bound (JSON has no inf)."""

    __slots__ = ("bounds", "counts", "sum")

    def __init__(self, bounds=LATENCY_BUCKETS_MS):
        self.bounds = tuple(float(b) for b in bounds)
        self.counts = [0] * (len(self.bounds) + 1)
        self.sum = 0.0

    def observe(self, value_ms: float) -> None:
        value_ms = float(value_ms)
        self.sum += value_ms
        for i, bound in enumerate(self.bounds):
            if value_ms <= bound:
                self.counts[i] += 1
                return
        self.counts[-1] += 1

    @property
    def count(self) -> int:
        return sum(self.counts)

    def merge(self, other: "Histogram") -> None:
        if tuple(other.bounds) != self.bounds:
            raise ValueError(
                f"histogram bounds differ: {other.bounds} vs {self.bounds}"
            )
        for i, c in enumerate(other.counts):
            self.counts[i] += int(c)
        self.sum += float(other.sum)

    def percentile(self, q: float) -> float:
        total = self.count
        if total == 0:
            return 0.0
        rank = max(1, int(-(-q * total // 1)))  # ceil(q * total)
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= rank:
                return self.bounds[min(i, len(self.bounds) - 1)]
        return self.bounds[-1]

    def snapshot(self) -> dict:
        return {
            "bounds_ms": list(self.bounds),
            "counts": list(self.counts),
            "sum_ms": round(self.sum, 6),
        }

    @classmethod
    def from_snapshot(cls, snap) -> Optional["Histogram"]:
        """Tolerant inverse of :meth:`snapshot` (None on junk — a
        replica running an older build simply contributes nothing)."""
        if not isinstance(snap, dict):
            return None
        bounds = snap.get("bounds_ms")
        counts = snap.get("counts")
        if (
            not isinstance(bounds, list)
            or not isinstance(counts, list)
            or len(counts) != len(bounds) + 1
        ):
            return None
        try:
            h = cls(bounds)
            h.counts = [int(c) for c in counts]
            h.sum = float(snap.get("sum_ms", 0.0))
        except (TypeError, ValueError):
            return None
        return h


_METRIC_NAME_RE = re.compile(r"[a-zA-Z_:][a-zA-Z0-9_:]*\Z")
_LABEL_NAME_RE = re.compile(r"[a-zA-Z_][a-zA-Z0-9_]*\Z")


def _fmt_value(v) -> str:
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, int):
        return str(v)
    f = float(v)
    return repr(f) if f == f else "NaN"


def _fmt_labels(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    parts = []
    for k in sorted(labels):
        if not _LABEL_NAME_RE.match(k):
            raise ValueError(f"invalid Prometheus label name {k!r}")
        val = str(labels[k]).replace("\\", "\\\\")
        val = val.replace('"', '\\"').replace("\n", "\\n")
        parts.append(f'{k}="{val}"')
    return "{" + ",".join(parts) + "}"


class MetricsRegistry:
    """A snapshot-style registry: callers set absolute values (the
    sources already keep their own counters) and :meth:`render` emits
    the whole thing as Prometheus text exposition.  Rebuilding the
    registry per ``metrics`` call keeps the adoption surgery zero — no
    counter is moved, every counter is exported."""

    def __init__(self):
        # name -> {"type", "help", "samples": [(labels, value)]}
        self._families: "collections.OrderedDict[str, dict]" = (
            collections.OrderedDict()
        )

    def _family(self, name: str, mtype: str, help_text: str) -> dict:
        if not _METRIC_NAME_RE.match(name):
            raise ValueError(f"invalid Prometheus metric name {name!r}")
        fam = self._families.get(name)
        if fam is None:
            fam = {"type": mtype, "help": help_text, "samples": []}
            self._families[name] = fam
        elif fam["type"] != mtype:
            raise ValueError(
                f"metric {name} registered as {fam['type']}, now {mtype}"
            )
        return fam

    def counter(self, name: str, value, help_text: str = "", **labels):
        self._family(name, "counter", help_text)["samples"].append(
            (dict(labels), value)
        )

    def gauge(self, name: str, value, help_text: str = "", **labels):
        self._family(name, "gauge", help_text)["samples"].append(
            (dict(labels), value)
        )

    def histogram(self, name: str, hist: Histogram, help_text: str = "",
                  **labels):
        self._family(name, "histogram", help_text)["samples"].append(
            (dict(labels), hist)
        )

    def render(self) -> str:
        lines: List[str] = []
        for name, fam in self._families.items():
            if fam["help"]:
                lines.append(f"# HELP {name} {fam['help']}")
            lines.append(f"# TYPE {name} {fam['type']}")
            for labels, value in fam["samples"]:
                if fam["type"] == "histogram":
                    cum = 0
                    for bound, c in zip(value.bounds, value.counts):
                        cum += c
                        le = dict(labels, le=_fmt_value(bound))
                        lines.append(
                            f"{name}_bucket{_fmt_labels(le)} {cum}"
                        )
                    cum += value.counts[-1]
                    inf = dict(labels, le="+Inf")
                    lines.append(f"{name}_bucket{_fmt_labels(inf)} {cum}")
                    lines.append(
                        f"{name}_sum{_fmt_labels(labels)} "
                        f"{_fmt_value(value.sum)}"
                    )
                    lines.append(f"{name}_count{_fmt_labels(labels)} {cum}")
                else:
                    lines.append(
                        f"{name}{_fmt_labels(labels)} {_fmt_value(value)}"
                    )
        return "\n".join(lines) + "\n"


_SAMPLE_RE = re.compile(
    r"(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?P<labels>\{[^{}]*\})?\s+"
    r"(?P<value>[-+]?(?:\d+\.?\d*(?:[eE][-+]?\d+)?|\.\d+|Inf|NaN))\s*\Z"
)
_LABEL_PAIR_RE = re.compile(
    r'\s*[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\]|\\.)*"\s*(?:,|\Z)'
)


def parse_prometheus(text: str) -> Dict[str, str]:
    """Validate Prometheus text exposition; returns family name ->
    declared type.  Raises ``ValueError`` on any malformed line — this
    is the perf-smoke lint and the tests' oracle, deliberately strict:
    a sample for an undeclared family, a bad label quote, an unparsable
    value all fail loud."""
    families: Dict[str, str] = {}
    for lineno, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith("# HELP ") or line.startswith("# TYPE "):
            parts = line.split(None, 3)
            if len(parts) < 3 or not _METRIC_NAME_RE.match(parts[2]):
                raise ValueError(f"line {lineno}: malformed {parts[1]}")
            if parts[1] == "TYPE":
                mtype = parts[3].strip() if len(parts) > 3 else ""
                if mtype not in ("counter", "gauge", "histogram",
                                 "summary", "untyped"):
                    raise ValueError(
                        f"line {lineno}: unknown metric type {mtype!r}"
                    )
                families[parts[2]] = mtype
            continue
        if line.startswith("#"):
            continue  # plain comment
        m = _SAMPLE_RE.match(line)
        if not m:
            raise ValueError(f"line {lineno}: unparsable sample {line!r}")
        raw_labels = m.group("labels")
        if raw_labels:
            body = raw_labels[1:-1]
            while body.strip():
                pm = _LABEL_PAIR_RE.match(body)
                if not pm:
                    raise ValueError(
                        f"line {lineno}: malformed labels {raw_labels!r}"
                    )
                body = body[pm.end():]
        name = m.group("name")
        base = name
        for suffix in ("_bucket", "_sum", "_count"):
            if name.endswith(suffix) and name[: -len(suffix)] in families:
                base = name[: -len(suffix)]
                break
        if base not in families:
            raise ValueError(
                f"line {lineno}: sample {name!r} has no # TYPE declaration"
            )
    return families


# ---------------------------------------------------------------------------
# Flight recorder
# ---------------------------------------------------------------------------

FLIGHT_RING_SIZE = 256


class FlightRecorder:
    """Bounded ring of recent structured events.  ``record`` is a
    single deque.append (GIL-atomic, no lock) so it is safe on the
    batcher/supervisor hot paths; JSON serialization cost is paid only
    at :meth:`dump` time, which only ever runs on the way out."""

    def __init__(self, maxlen: int = FLIGHT_RING_SIZE):
        self._ring: "collections.deque[dict]" = collections.deque(
            maxlen=maxlen
        )

    def record(self, kind: str, **fields) -> None:
        fields["ts"] = round(time.time(), 6)
        fields["kind"] = kind
        self._ring.append(fields)

    def snapshot(self) -> List[dict]:
        return list(self._ring)

    def clear(self) -> None:
        self._ring.clear()

    def dump(self, reason: str, path: Optional[str] = None) -> Optional[str]:
        """Append the ring + a trailing marker as JSONL to ``path``
        (default ``MSBFS_FLIGHT_RECORDER``); returns the path written,
        or None when no path is configured.  Append mode on purpose:
        several processes (fleet replicas) or several dumps (drain then
        exit) share one postmortem file without clobbering."""
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
    the typed-error exit hooks and the SIGTERM handler call this."""
    return _FLIGHT.dump(reason)


# ---------------------------------------------------------------------------
# Structured logging
# ---------------------------------------------------------------------------

def log_json_enabled() -> bool:
    """``MSBFS_LOG_FORMAT=json`` switches server logs to one-JSON-object
    -per-line; anything else (default) keeps the plain human lines
    byte-identical to before."""
    return knobs.raw("MSBFS_LOG_FORMAT", "").strip().lower() == "json"


def log_line(msg: str, level: str = "info", stream=None, **fields) -> None:
    """One server log line on stderr.  Plain mode writes ``msg``
    unchanged; json mode emits ``{ts, level, msg, trace_id?, ...}`` so
    fleet logs are jq-able and join traces on trace_id."""
    if stream is None:
        stream = sys.stderr
    if not log_json_enabled():
        print(msg, file=stream)
        return
    rec = {"ts": round(time.time(), 6), "level": level, "msg": msg}
    ctx = current_trace()
    if ctx is not None:
        rec["trace_id"] = ctx.trace_id
    rec.update(fields)
    print(json.dumps(rec, default=str), file=stream)


__all__ = [
    "TraceContext",
    "new_trace",
    "trace_enabled",
    "current_trace",
    "use_trace",
    "span",
    "span_begin",
    "span_end",
    "instant",
    "record_span_event",
    "trace_events",
    "known_traces",
    "clear_traces",
    "chrome_trace",
    "LATENCY_BUCKETS_MS",
    "Histogram",
    "MetricsRegistry",
    "parse_prometheus",
    "FlightRecorder",
    "flight_recorder",
    "flight_path",
    "record_flight",
    "dump_flight",
    "log_json_enabled",
    "log_line",
]

"""The ``trace`` and ``metrics`` verbs: export-side observability.

utils/telemetry.py owns the primitives (span store, histogram, registry,
flight ring); this module owns the ASSEMBLY — turning a live server's or
fleet front end's state into the two wire artifacts:

* ``trace`` verb: the span events recorded for one trace_id in THIS
  process (raw event list; every event carries pid/tid/epoch-µs, so a
  front end merging several processes' lists only concatenates).
* ``metrics`` verb: Prometheus text exposition covering every counter
  the daemon already keeps — requests, queue/admission, sheds, caches,
  audits, repairs, compiles, per-bucket latency histograms, and the
  process-global engine counters (dispatches, plane-pass bytes, mxu
  tiles; the port runs on one card, so the JAX package's collective-bytes
  gauge has nothing to count and is not exported), and the port's own
  card-memory gauges (the daemon's caching allocator, 0 off the card).
* fleet front end: ``fleet_metrics_text`` (the router's leg accounting
  and the replicas' roll-up) and ``merge_trace_events`` (one trace's
  events from the front end and every replica, merged by time).

Both verbs are read-only and answerable while draining, like ``stats``.

The port's copy of the JAX package's serve/observe.py.  The JAX
package's docs/OBSERVABILITY.md is the operator manual.
"""

from __future__ import annotations

from typing import List

import torch

from ..utils import telemetry, timing
from ..utils.telemetry import Histogram, MetricsRegistry


def op_trace(request: dict) -> dict:
    """Shared ``trace`` verb body (server and fleet front end): the
    events this process recorded for ``trace_id`` (default: the most
    recent trace), plus the ids currently held so a client can discover
    what to ask for."""
    traces = telemetry.known_traces()
    trace_id = request.get("trace_id")
    if trace_id is None and traces:
        trace_id = traces[-1]
    events: List[dict] = (
        telemetry.trace_events(trace_id) if trace_id else []
    )
    return {
        "ok": True,
        "op": "trace",
        "trace_id": trace_id,
        "events": events,
        "traces": traces,
    }


def engine_counter_metrics(reg: MetricsRegistry) -> None:
    """The process-global engine counters (utils/timing.py) as gauges:
    they are resettable by benchmarks, so "counter" semantics (strictly
    monotone) would be a lie Prometheus rate() could trip over."""
    totals = timing.counter_totals()
    reg.gauge("msbfs_engine_dispatches", totals["dispatches"],
              "Blocking device commits recorded since last reset")
    reg.gauge("msbfs_engine_plane_pass_bytes", totals["plane_pass_bytes"],
              "Analytic full-plane-equivalent stencil stream bytes")
    reg.gauge("msbfs_engine_mxu_flops", totals["mxu_flops"],
              "Analytic mxu tile FLOPs issued")
    reg.gauge("msbfs_engine_mxu_tiles_skipped", totals["mxu_tiles_skipped"],
              "All-zero adjacency tiles elided by the mxu engine")
    reg.gauge("msbfs_engine_mxu_tiles_total", totals["mxu_tiles_total"],
              "Adjacency tiles considered by the mxu engine")


def device_memory_metrics(reg: MetricsRegistry, device) -> None:
    """What this process's caching allocator holds on the card (0 on the
    CPU): the per-replica reading that shows each daemon of a fleet on
    one card holds its own memory there."""
    on_card = device.type == "cuda"
    reg.gauge("msbfs_device_memory_allocated_bytes",
              torch.cuda.memory_allocated(device) if on_card else 0,
              "Card bytes held by live tensors of this process")
    reg.gauge("msbfs_device_memory_reserved_bytes",
              torch.cuda.memory_reserved(device) if on_card else 0,
              "Card bytes the caching allocator of this process reserved")


def _cache_metrics(reg: MetricsRegistry, name: str, snap: dict) -> None:
    for key in ("hits", "misses", "evictions"):
        if key in snap:
            reg.counter(f"msbfs_cache_{key}_total", snap[key],
                        "Cache hit/miss/eviction counts by cache",
                        cache=name)
    for key in ("size", "capacity", "bytes", "max_bytes", "entries"):
        if key in snap:
            reg.gauge(f"msbfs_cache_{key}", snap[key],
                      "Cache occupancy gauges by cache", cache=name)


def server_metrics_text(server) -> str:
    """One daemon's counters as Prometheus text exposition.  Built
    fresh per call from :meth:`MsbfsServer.stats` — the sources stay
    the single writers of their counters, the registry is a view."""
    stats = server.stats()
    reg = MetricsRegistry()
    reg.gauge("msbfs_uptime_seconds", stats["uptime_s"],
              "Seconds since this daemon constructed its runtime")
    reg.gauge("msbfs_ready", stats["ready"],
              "1 once journal replay and re-warm finished")
    reg.gauge("msbfs_draining", stats["draining"],
              "1 while the daemon refuses new stateful work")
    reg.counter("msbfs_requests_total", stats["requests_total"],
                "Query requests admitted for parsing")
    reg.counter("msbfs_requests_failed_total", stats["requests_failed"],
                "Query requests that failed typed")
    reg.counter("msbfs_requests_shed_total", stats["requests_shed"],
                "Requests shed after their client deadline expired")
    reg.counter("msbfs_requests_quarantined_total",
                stats["requests_quarantined"],
                "Poisoned requests isolated by batch bisection")
    reg.counter("msbfs_shed_brownout_total",
                stats["posture"]["shed_brownout"],
                "Batch requests shed by the brownout cache-only rung")
    queue = stats["queue"]
    reg.gauge("msbfs_queue_depth", queue["depth"],
              "Admission queue depth now")
    reg.gauge("msbfs_queue_capacity", queue["capacity"],
              "Admission queue capacity")
    reg.gauge("msbfs_queue_oldest_age_seconds", queue["oldest_age_s"],
              "Monotonic age of the queue head (0 when empty)")
    reg.counter("msbfs_queue_rejected_total", queue["rejected"],
                "Admissions refused: queue full")
    reg.counter("msbfs_queue_rejected_batch_total", queue["rejected_batch"],
                "Admissions refused: batch-priority fraction exceeded")
    reg.counter("msbfs_queue_rejected_client_total",
                queue["rejected_client"],
                "Admissions refused: per-client token bucket empty")
    reg.counter("msbfs_queue_shed_overload_total", queue["shed_overload"],
                "Queued requests shed by the CoDel overload controller")
    reg.counter("msbfs_batches_total", queue["batches"],
                "Batches dispatched by the micro-batcher")
    reg.counter("msbfs_batches_coalesced_total", queue["coalesced"],
                "Requests that rode a batch they did not open")
    reg.counter("msbfs_audited_total", stats["audited"],
                "Engine dispatches that ran the output certificate")
    reg.counter("msbfs_audit_failures_total", stats["audit_failures"],
                "Output-certificate failures (CorruptionError, exit 9)")
    dyn = stats["dynamic"]
    reg.counter("msbfs_mutations_total", dyn["mutations"],
                "Edge-delta batches applied via the mutate verb")
    reg.counter("msbfs_requests_repaired_total", dyn["requests_repaired"],
                "Queries answered by incremental host repair")
    reg.counter("msbfs_repair_fallbacks_total", dyn["repair_fallbacks"],
                "Repairs that degraded to the full host sweep")
    reg.counter("msbfs_planes_retained_total", dyn["planes_retained"],
                "Distance planes retained as repair seeds")
    reg.counter("msbfs_repair_audited_total", dyn["repair_audited"],
                "Repaired answers that ran the output certificate")
    reg.counter("msbfs_repair_audit_failures_total",
                dyn["repair_audit_failures"],
                "Repaired answers that flunked the certificate")
    compiles = stats["compiles"]  # per-bucket map from the stats verb
    reg.gauge("msbfs_compiles",
              len(compiles) if isinstance(compiles, dict) else compiles,
              "Executable-cache entries compiled this process")
    reg.counter("msbfs_compiles_total", stats["compiles_total"],
                "Bucket compiles ever run by this process")
    reg.counter("msbfs_journal_bytes", stats["journal_bytes"],
                "Append-only state journal size in bytes")
    device_memory_metrics(reg, server.registry.device)
    _cache_metrics(reg, "result", stats["result_cache"])
    _cache_metrics(reg, "planes", dyn["planes"])
    try:
        from .registry import mxu_tile_cache_stats

        _cache_metrics(reg, "mxu_tiles", mxu_tile_cache_stats())
    except Exception:  # noqa: BLE001 — optional engine cache
        pass
    for label, b in sorted(stats["buckets"].items()):
        reg.counter("msbfs_bucket_requests_total", b["requests"],
                    "Requests answered, by shape bucket", bucket=label)
        reg.counter("msbfs_bucket_batches_total", b["batches"],
                    "Batches dispatched, by shape bucket", bucket=label)
        reg.counter("msbfs_bucket_rows_total", b["rows"],
                    "Padded rows dispatched, by shape bucket",
                    bucket=label)
        reg.counter("msbfs_bucket_cache_hits_total", b["cache_hits"],
                    "Result-cache hits, by shape bucket", bucket=label)
        hist = Histogram.from_snapshot(b.get("hist"))
        if hist is not None:
            reg.histogram("msbfs_request_latency_ms", hist,
                          "Request latency distribution (fixed log2 "
                          "ms buckets)", bucket=label)
    engine_counter_metrics(reg)
    return reg.render()


def fleet_metrics_text(frontend) -> str:
    """The fleet front end's counters as Prometheus text: router
    leg accounting plus the cross-replica roll-up totals (including the
    merged latency histogram the roll-up carries)."""
    stats = frontend._op_stats()
    reg = MetricsRegistry()
    router = stats["router"]
    for key in ("routed", "failovers", "net_drops", "hedged", "shed",
                "votes", "votes_suppressed", "vote_mismatches",
                "vote_unresolved", "quarantined"):
        reg.counter(f"msbfs_fleet_{key}_total", router.get(key, 0),
                    "Fleet router leg accounting")
    for replica, n in sorted(router.get("per_replica", {}).items()):
        reg.counter("msbfs_fleet_routed_by_replica_total", n,
                    "Primary routes served, by replica", replica=replica)
    fleet = stats["fleet"]
    for key in ("size", "ready", "restarts", "quarantined"):
        if key in fleet:
            value = fleet[key]
            if isinstance(value, (list, tuple, set)):
                # FleetSupervisor.status() lists the ready replicas' names
                # (the JAX package renders the list and fails): count them.
                value = len(value)
            reg.gauge(f"msbfs_fleet_replicas_{key}", value,
                      "Fleet supervisor replica accounting")
    totals = stats.get("totals", {})
    for key, value in sorted(totals.items()):
        if key == "latency_hist":
            hist = Histogram.from_snapshot(value)
            if hist is not None:
                reg.histogram("msbfs_fleet_request_latency_ms", hist,
                              "Cross-replica merged request latency "
                              "(fixed log2 ms buckets)")
            continue
        if isinstance(value, (int, float)):
            reg.counter(f"msbfs_fleet_totals_{key}", value,
                        "Summed per-replica counters from the roll-up")
    engine_counter_metrics(reg)
    return reg.render()


def merge_trace_events(
    local: List[dict], remote_batches: List[List[dict]]
) -> List[dict]:
    """Concatenate + time-sort span events from several processes into
    one Chrome-trace event list (every event is self-describing — the
    pid/tid/epoch-µs fields make plain concatenation a correct merge)."""
    merged = list(local)
    for batch in remote_batches:
        if isinstance(batch, list):
            merged.extend(e for e in batch if isinstance(e, dict))
    merged.sort(key=lambda e: e.get("ts", 0))
    return merged


def chrome_trace_json(events: List[dict]) -> dict:
    return telemetry.chrome_trace(events)


__all__ = [
    "op_trace",
    "server_metrics_text",
    "engine_counter_metrics",
    "fleet_metrics_text",
    "chrome_trace_json",
    "merge_trace_events",
]

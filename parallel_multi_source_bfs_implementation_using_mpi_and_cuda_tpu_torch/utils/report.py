"""The stdout report — the reference's CLI output contract (main.cu:403-414):
fixed 9-decimal times, the winning query 1-based, the literal ``GPU #``
line — the serving daemon's stats report, and the one-line typed failure
report on stderr."""

from __future__ import annotations


def format_report(
    graph_path: str,
    query_path: str,
    min_k: int,
    min_f: int,
    num_gpu: int,
    preprocessing_time: float,
    computation_time: float,
) -> str:
    return (
        f"Graph: {graph_path}\n"
        f"Query: {query_path}\n"
        f"Query number (k) with minimum F value: {min_k + 1}\n"
        f"Minimum F value: {min_f}\n"
        f"GPU # : {num_gpu} GPU\n"
        f"Preprocessing time: {preprocessing_time:.9f} s\n"
        f"Computation time: {computation_time:.9f} s\n"
    )


def format_server_stats(stats: dict) -> str:
    """Human-readable rendering of the serving daemon's ``stats`` verb:
    the client CLI's --stats output (the JAX package's lines).  The wire
    form is the JSON object itself."""
    lines = [f"uptime: {stats.get('uptime_s', 0):.1f} s"]
    for name, g in sorted(stats.get("graphs", {}).items()):
        lines.append(
            f"graph {name}: v{g['version']} hash {g['hash']} "
            f"({g['n']} vertices, {g['directed_edges']} directed edges)"
        )
    q = stats.get("queue", {})
    lines.append(
        f"queue: depth {q.get('depth', 0)}/{q.get('capacity', 0)}, "
        f"rejected {q.get('rejected', 0)}, batches {q.get('batches', 0)}, "
        f"coalesced {q.get('coalesced', 0)}"
    )
    rc = stats.get("result_cache", {})
    lines.append(
        f"result cache: {rc.get('hits', 0)} hits / "
        f"{rc.get('misses', 0)} misses, size {rc.get('size', 0)}/"
        f"{rc.get('capacity', 0)}, evictions {rc.get('evictions', 0)}"
    )
    lines.append(
        f"requests: {stats.get('requests_total', 0)} total, "
        f"{stats.get('requests_failed', 0)} failed, "
        f"{stats.get('requests_shed', 0)} shed, "
        f"{stats.get('requests_quarantined', 0)} quarantined; "
        f"compiles: {stats.get('compiles_total', 0)}"
    )
    if stats.get("draining"):
        lines.append("state: DRAINING (refusing new work)")
    if stats.get("journal"):
        lines.append(f"journal: {stats['journal']}")
    for label, b in sorted(stats.get("buckets", {}).items()):
        lines.append(
            f"bucket {label}: {b['requests']} requests in {b['batches']} "
            f"batches, p50 {b['p50_ms']} ms, p95 {b['p95_ms']} ms, "
            f"p99 {b['p99_ms']} ms"
        )
    n_rec = len(stats.get("recovery_events", []))
    if n_rec:
        lines.append(f"recovery events: {n_rec} (see stats JSON)")
    return "\n".join(lines) + "\n"


def format_failure(err, recovery_events=()) -> str:
    """``msbfs: <class>: <msg> (exit <code>)`` plus a recovery-attempt
    count when the supervisor tried before giving up."""
    tried = (
        f" after {len(recovery_events)} recovery attempt"
        f"{'s' if len(recovery_events) != 1 else ''}"
        if recovery_events
        else ""
    )
    return (
        f"msbfs: {type(err).__name__}: {err}{tried} "
        f"(exit {getattr(err, 'exit_code', 1)})\n"
    )

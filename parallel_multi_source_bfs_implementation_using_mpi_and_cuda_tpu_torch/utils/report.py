"""The stdout report — the reference's CLI output contract (main.cu:403-414):
fixed 9-decimal times, the winning query 1-based, the literal ``GPU #``
line — and the one-line typed failure report on stderr."""

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

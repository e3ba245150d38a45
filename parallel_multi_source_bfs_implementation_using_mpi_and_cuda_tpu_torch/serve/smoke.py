"""Serving smoke: daemon up, three client queries, stats asserts.

End to end over a real unix socket: start the daemon on a fabricated
graph, probe ``health``, run three client queries — two distinct (the
second in the same shape bucket as the first) and a repeat of the first
(a result-cache hit) — then assert the ``stats`` verb shows exactly one
compile for the bucket, one cache hit, and zero failed requests.  Exit
0 on success, 1 with a reason on stderr otherwise.  The daemon is torn
down in a ``finally`` — a failed smoke never leaves a listener behind.

Run directly::

    python -m parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.serve.smoke

It runs on the card; :func:`run_smoke` takes ``device="cpu"`` for tests.
"""

from __future__ import annotations

import sys
import tempfile


def run_smoke(device=None) -> int:
    import numpy as np

    from ..models import generators
    from ..utils.io import save_graph_bin
    from ..utils.report import format_server_stats
    from .client import MsbfsClient
    from .server import MsbfsServer

    tmp = tempfile.TemporaryDirectory(prefix="msbfs_serve_smoke_")
    failures = []
    # Everything from construction on sits inside the try: a daemon that
    # came up half-way (socket bound, batcher running) before an assert
    # or an exception must still be torn down.
    server = None

    def check(cond, what):
        if not cond:
            failures.append(what)

    try:
        gpath = f"{tmp.name}/g.bin"
        n, edges = generators.gnm_edges(200, 600, seed=7)
        save_graph_bin(gpath, n, edges)
        sock = f"{tmp.name}/msbfs.sock"
        server = MsbfsServer(listen=f"unix:{sock}", graphs={"default": gpath},
                             device=device)
        server.start()
        rng = np.random.default_rng(11)
        q1 = [[int(v) for v in rng.integers(0, n, size=3)] for _ in range(4)]
        q2 = [[int(v) for v in rng.integers(0, n, size=3)] for _ in range(4)]
        with MsbfsClient(f"unix:{sock}") as client:
            check(client.ping(), "ping answered")
            health = client.health()
            check(health.get("ready"), "health reports ready")
            check(health.get("pid"), "health carries the daemon pid")
            r1 = client.query(q1)
            check(r1["compiled"], "first query compiles its bucket")
            check(not r1["cached"], "first query is not cached")
            r2 = client.query(q2)
            check(not r2["compiled"],
                  "same-bucket second query reuses the executable")
            check(not r2["cached"], "distinct second query is not cached")
            check(r2["bucket"] == r1["bucket"], "q1/q2 share a bucket")
            r3 = client.query(q1)
            check(r3["cached"], "repeat query hits the result cache")
            check(r3["min_f"] == r1["min_f"] and r3["min_k"] == r1["min_k"],
                  "cached result matches the computed one")
            stats = client.stats()
        check(stats["compiles_total"] == 1,
              f"exactly one compile, got {stats['compiles_total']}")
        check(stats["result_cache"]["hits"] == 1,
              f"one cache hit, got {stats['result_cache']['hits']}")
        check(stats["requests_failed"] == 0,
              f"zero failed requests, got {stats['requests_failed']}")
        check(stats["requests_total"] == 3,
              f"three requests, got {stats['requests_total']}")
        sys.stderr.write(format_server_stats(stats))
    except BaseException as exc:  # noqa: BLE001 — report, then teardown
        failures.append(f"unexpected exception: {exc!r}")
    finally:
        if server is not None:
            server.stop()
        tmp.cleanup()
    if failures:
        for f in failures:
            print(f"serve smoke FAILED: {f}", file=sys.stderr)
        return 1
    print("serve smoke OK: 3 queries, 1 compile, 1 result-cache hit",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(run_smoke())

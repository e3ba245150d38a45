"""Client side of the serving protocol: importable API + thin CLI.

Importable::

    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.serve.client \
        import MsbfsClient
    with MsbfsClient("unix:/tmp/msbfs.sock") as c:
        out = c.query([[0, 5], [17]])          # -> response dict
        print(out["min_f"], out["min_k"], out["cached"])

CLI (``python -m parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch
query ...``)::

    python -m <port> query --connect unix:/tmp/msbfs.sock -q query.bin
    python -m <port> query --connect unix:/tmp/msbfs.sock --health

The port's copy of the JAX package's serve/client.py: it speaks the same
frames, so it queries a daemon of either package.

The query verb prints the reference report's two selection lines on
stdout (the serving analog of main.cu:403-414; there are no process
timing spans to report — that is the point of the daemon) and serving
metadata (bucket, cache/batch status, latency) on stderr.  Server-side
failures raise :class:`ServerError` carrying the taxonomy class name
and documented exit code, which the CLI uses as its own exit code —
the same contract as the batch CLI (docs/RESILIENCE.md).

Resilience (docs/SERVING.md "Crash recovery & probes"): a lost
connection mid-call is wrapped in the same typed :class:`ServerError`
taxonomy (``TransientError``, exit 5) rather than leaking raw socket
errors to scripts; *idempotent* verbs (ping/health/stats/query/load —
load is load-once on the server, so re-sending it is safe — and
``mutate``, which rides a client-minted idempotency token the server
dedups, docs/SERVING.md "Cross-machine transport & fencing")
additionally reconnect with the PR-1 bounded backoff schedule before
giving up.
Round 9 decorrelates that schedule: each client instance seeds its own
backoff jitter (pid + an instance counter), because N clients born
from one event — a replica restart dropping every connection at once —
would otherwise all share seed 0 and retry in lockstep, re-forming the
very thundering herd the backoff exists to spread.  The schedule is
additionally capped by ``reconnect_max_elapsed_s`` of wall clock:
whatever the per-delay arithmetic says, a client gives up (typed,
exit 5) once the cap elapses, so fleet failover happens within the
caller's deadline instead of after a worst-case backoff sum.
``query`` accepts a per-call ``deadline_s`` propagated on the wire (the
server sheds work whose client has stopped waiting) and an optional
``hedge_after_s``: if the primary connection has not answered by then,
the same query races on a second connection and the first answer wins —
the classic tail-latency hedge, safe precisely because query is
idempotent and results are deterministic.
"""

from __future__ import annotations

import itertools
import os
import secrets
import sys
import threading
import time
from typing import List, Optional, Sequence

from ..runtime.supervisor import RetryPolicy
from ..utils import telemetry
from . import protocol

# Per-process client counter: combined with the pid it decorrelates the
# default backoff jitter across clients AND across client processes.
_instance_counter = itertools.count(1)


def _instance_seed() -> int:
    return (os.getpid() << 20) ^ (next(_instance_counter) * 0x9E3779B1)


def reconnect_schedule(
    retry: RetryPolicy, max_elapsed_s: float
) -> List[float]:
    """The bounded reconnect sleep schedule: the policy's jittered
    delays, truncated where their running sum would exceed
    ``max_elapsed_s``.  Pure (one materialized list per call) so the
    unit tests can pin it without sleeping."""
    out: List[float] = []
    elapsed = 0.0
    for delay in retry.delays():
        if elapsed + delay > max_elapsed_s:
            break
        out.append(delay)
        elapsed += delay
    return out


class ServerError(Exception):
    """A typed failure with the wire taxonomy's class name + exit code —
    raised both for ``ok: false`` responses (server-side taxonomy) and
    for transport failures (wrapped as ``TransientError``, exit 5, so
    scripting sees one stable contract either way)."""

    def __init__(self, type_name: str, message: str, exit_code: int):
        super().__init__(f"{type_name}: {message}")
        self.type_name = type_name
        self.exit_code = int(exit_code)


def _transport_error(address: str, exc: BaseException) -> ServerError:
    return ServerError(
        "TransientError",
        f"connection to {address} failed: {exc}",
        5,
    )


class MsbfsClient:
    """One connection to a serving daemon; context-managed.

    Thread-compatible, not thread-safe: frames on one connection are
    strictly request/response ordered, so share a client across threads
    only with external locking (or open one client per thread — unix
    socket connects are microseconds).  The hedged-query path honors
    this by racing on a *separate* connection.
    """

    def __init__(
        self,
        address: str,
        timeout: Optional[float] = 300.0,
        retry: Optional[RetryPolicy] = None,
        reconnect_max_elapsed_s: float = 15.0,
        epoch: Optional[int] = None,
    ):
        self.address = address
        self.timeout = timeout
        # Fleet-membership epoch (docs/SERVING.md "Cross-machine
        # transport & fencing"): when set, every request carries it and
        # a replica holding a different view refuses with FencedError
        # instead of serving under a stale membership.  None (the
        # single-daemon default) sends no epoch — tolerated-absent.
        self.epoch = None if epoch is None else int(epoch)
        # Bounded reconnect schedule for idempotent calls; PR-1's policy
        # so backoff behavior is one story repo-wide — but seeded per
        # client instance, so a replica restart's dropped connections do
        # not resurrect as a lockstep retry storm.
        self.retry = retry if retry is not None else RetryPolicy(
            max_retries=2, base_delay=0.05, max_delay=2.0,
            seed=_instance_seed(),
        )
        self.reconnect_max_elapsed_s = float(reconnect_max_elapsed_s)
        self._sock = protocol.connect(address, timeout=timeout)

    def close(self) -> None:
        self._drop_sock()

    def _drop_sock(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def _ensure_sock(self):
        if self._sock is None:
            self._sock = protocol.connect(self.address, timeout=self.timeout)
        return self._sock

    def __enter__(self) -> "MsbfsClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ---- request plumbing -------------------------------------------------
    def _call_once(self, sock, request: dict) -> dict:
        protocol.send_frame(sock, request)
        response = protocol.recv_frame(sock)
        if response is None:
            raise ConnectionError(
                f"server at {self.address} closed the connection"
            )
        if not response.get("ok"):
            err = response.get("error") or {}
            raise ServerError(
                err.get("type", "MsbfsError"),
                err.get("message", "unspecified server error"),
                err.get("exit_code", 6),
            )
        return response

    def call(self, request: dict, idempotent: bool = False) -> dict:
        """Send one request object, return the ``ok: true`` response or
        raise :class:`ServerError`.  Transport failures are wrapped
        typed; when ``idempotent`` they first retry on a fresh
        connection per the bounded backoff schedule, capped at
        ``reconnect_max_elapsed_s`` of total wall clock (the connect
        attempts themselves burn budget too, so the cap is enforced
        against the clock, not just the planned sleeps)."""
        if self.epoch is not None and "epoch" not in request:
            request = dict(request)
            request["epoch"] = self.epoch
        # A mutate WITHOUT an idempotency token must never be retried,
        # whatever the caller claimed: a transport error leaves its
        # outcome unknown, and a blind re-send could append the delta
        # twice.  Tokened mutates retry safely — the server's dedup
        # window re-acks the applied copy (docs/SERVING.md
        # "Cross-machine transport & fencing").
        tokenless_mutate = (
            request.get("op") == "mutate" and not request.get("token")
        )
        if tokenless_mutate:
            idempotent = False
        delays = (
            reconnect_schedule(self.retry, self.reconnect_max_elapsed_s)
            if idempotent
            else []
        )
        start = time.monotonic()
        attempt = 0
        while True:
            try:
                return self._call_once(self._ensure_sock(), request)
            except ServerError:
                raise  # the server answered; nothing to reconnect from
            except (protocol.ProtocolError, OSError) as exc:
                # One dead socket must not poison later calls either way.
                self._drop_sock()
                if attempt >= len(delays) or (
                    time.monotonic() - start + delays[attempt]
                    > self.reconnect_max_elapsed_s
                ):
                    if tokenless_mutate:
                        raise ServerError(
                            "TransientError",
                            f"mutate to {self.address} had no idempotency"
                            f" token and its transport failed ({exc}); "
                            "NOT retried — the outcome is unknown and a "
                            "blind re-send could double-apply; check "
                            "'versions' or resend with a token",
                            5,
                        ) from exc
                    raise _transport_error(self.address, exc) from exc
                time.sleep(delays[attempt])
                attempt += 1

    # ---- verbs ------------------------------------------------------------
    def ping(self) -> bool:
        return bool(self.call({"op": "ping"}, idempotent=True).get("ok"))

    def health(self) -> dict:
        """The daemon's readiness report (docs/SERVING.md probe table)."""
        return self.call({"op": "health"}, idempotent=True)

    def load(self, path: str, graph: str = "default") -> dict:
        # Idempotent by the registry's load-once rule: same bytes under
        # the same name is a no-op hit, so re-sending after a lost
        # connection cannot double-register.
        return self.call(
            {"op": "load", "graph": graph, "path": path}, idempotent=True
        )

    def reload(self, graph: str = "default") -> dict:
        # NOT idempotent: each reload bumps the version; blind re-send
        # after an ambiguous failure could bump twice.
        return self.call({"op": "reload", "graph": graph})

    def mutate(
        self,
        inserts: Sequence[Sequence[int]] = (),
        deletes: Sequence[Sequence[int]] = (),
        graph: str = "default",
        token: Optional[str] = None,
    ) -> dict:
        """Append one edge-delta batch to ``graph``'s version chain
        (docs/SERVING.md "Mutations & versions").  Exactly-once over a
        lossy transport: every call carries an idempotency ``token``
        (auto-minted when None) that the server's bounded dedup window
        remembers, so the retried/hedged/duplicated copy of an applied
        mutate RE-ACKS the original version+digest instead of appending
        a second chain version — which is what makes the retry below
        safe where a blind re-send was not.  Pass ``token`` explicitly
        to retry an earlier ambiguous call under the same identity."""
        if token is None:
            token = secrets.token_hex(16)
        return self.call(
            {
                "op": "mutate",
                "graph": graph,
                "inserts": [[int(u), int(v)] for u, v in inserts],
                "deletes": [[int(u), int(v)] for u, v in deletes],
                "token": str(token),
            },
            idempotent=True,
        )

    def versions(self, graph: str = "default") -> dict:
        """The graph's version chain (read-only, idempotent)."""
        return self.call({"op": "versions", "graph": graph},
                         idempotent=True)

    def query(
        self,
        queries: Sequence[Sequence[int]],
        graph: str = "default",
        deadline_s: Optional[float] = None,
        hedge_after_s: Optional[float] = None,
        priority: Optional[str] = None,
        client_id: Optional[str] = None,
        weighted: bool = False,
        degraded: bool = False,
    ) -> dict:
        qs = [[int(v) for v in group] for group in queries]
        request = {"op": "query", "graph": graph, "queries": qs}
        if weighted:
            # Absent = unit-cost: legacy servers never see the field, so
            # old deployments keep answering exactly as before.
            request["weighted"] = True
        if degraded:
            # Sharded-graph opt-in (docs/SERVING.md "Sharded graphs"):
            # when every copy of a shard is down, accept a PARTIAL
            # answer flagged ``degraded: true`` instead of the typed
            # ShardUnavailableError refusal.  Absent = exact-or-refuse;
            # single-daemon and whole-graph fleets ignore the field.
            request["degraded"] = True
        if deadline_s is not None:
            request["deadline_s"] = float(deadline_s)
        if priority is not None:
            # "interactive" (default when absent) or "batch"; the server
            # validates, so a typo fails typed rather than silently
            # running at the wrong priority.
            request["priority"] = str(priority)
        if client_id is not None:
            request["client_id"] = str(client_id)
        # Distributed tracing (docs/OBSERVABILITY.md): forward the
        # thread's active trace, or mint one at this edge under
        # MSBFS_TRACE=1.  The ``trace`` field rides the JSON body;
        # legacy servers ignore unknown fields, same tolerated-absent
        # posture as the crc rollout.
        ctx = telemetry.current_trace()
        if ctx is None and telemetry.trace_enabled():
            ctx = telemetry.new_trace()
        if ctx is not None:
            request["trace"] = ctx.to_wire()
            with telemetry.use_trace(ctx):
                with telemetry.span("client.query", graph=graph,
                                    address=self.address):
                    if hedge_after_s is None:
                        out = self.call(request, idempotent=True)
                    else:
                        out = self._hedged_call(
                            request, float(hedge_after_s)
                        )
            out = dict(out)
            out["trace_id"] = ctx.trace_id
            return out
        if hedge_after_s is None:
            return self.call(request, idempotent=True)
        return self._hedged_call(request, float(hedge_after_s))

    def shard_step(
        self, graph: str, rows: Sequence[int],
        frontier: Sequence[Sequence[int]],
    ) -> dict:
        """One scatter/gather frontier expansion against a row-range
        shard registered on this daemon (docs/SERVING.md "Sharded
        graphs").  Read-only and deterministic, hence idempotent —
        re-sending a lost fragment is exactly the router's surviving-
        copy retry."""
        return self.call(
            {
                "op": "shard_step",
                "graph": graph,
                "rows": [int(rows[0]), int(rows[1])],
                "frontier": [[int(v) for v in g] for g in frontier],
            },
            idempotent=True,
        )

    def stats(self) -> dict:
        return self.call({"op": "stats"}, idempotent=True)["stats"]

    def trace(self, trace_id: Optional[str] = None) -> dict:
        """Fetch the span events one daemon (or fleet front end, which
        merges its replicas') recorded for ``trace_id`` — default: the
        most recent trace it holds.  Read-only, idempotent."""
        request: dict = {"op": "trace"}
        if trace_id is not None:
            request["trace_id"] = str(trace_id)
        return self.call(request, idempotent=True)

    def metrics(self) -> str:
        """The daemon's Prometheus text exposition (the ``metrics``
        verb; docs/OBSERVABILITY.md lists every family)."""
        return str(self.call({"op": "metrics"}, idempotent=True)["text"])

    def posture(self, audit_sample=None, cache_only=None) -> dict:
        """Push a brownout posture (docs/SERVING.md "Autoscaling &
        overload"): ``audit_sample`` a rate in [0, 1] or ``"restore"``,
        ``cache_only`` a bool.  Omitted fields are left unchanged.
        Idempotent: re-pushing the same posture is a no-op."""
        request: dict = {"op": "posture"}
        if audit_sample is not None:
            request["audit_sample"] = audit_sample
        if cache_only is not None:
            request["cache_only"] = bool(cache_only)
        return self.call(request, idempotent=True)

    def shutdown(self) -> dict:
        return self.call({"op": "shutdown"})

    # ---- hedged retry -----------------------------------------------------
    def _hedged_call(self, request: dict, hedge_after_s: float) -> dict:
        """Race the primary connection against a late-started spare;
        first answer wins.  If the spare wins, the primary socket is
        dropped (its response is still in flight and would desynchronize
        the frame stream), so the next call reconnects cleanly."""
        outcome: dict = {}
        lock = threading.Lock()
        done = threading.Event()

        def settle(source: str, result=None, error=None) -> bool:
            with lock:
                if outcome:
                    return False
                outcome.update(
                    {"source": source, "result": result, "error": error}
                )
            done.set()
            return True

        def primary() -> None:
            try:
                result = self.call(request, idempotent=True)
            except BaseException as exc:  # noqa: BLE001 — relayed to caller
                settle("primary", error=exc)
                return
            settle("primary", result=result)

        def spare() -> None:
            try:
                with MsbfsClient(
                    self.address, timeout=self.timeout, retry=self.retry
                ) as second:
                    result = second.call(request, idempotent=True)
            except BaseException as exc:  # noqa: BLE001 — loser may fail
                settle("hedge", error=exc)
                return
            settle("hedge", result=result)

        t_primary = threading.Thread(
            target=primary, name="msbfs-hedge-primary", daemon=True
        )
        t_primary.start()
        if not done.wait(hedge_after_s):
            threading.Thread(
                target=spare, name="msbfs-hedge-spare", daemon=True
            ).start()
        done.wait()
        if outcome["source"] == "hedge" and t_primary.is_alive():
            self._drop_sock()  # abandon the in-flight primary exchange
        if outcome["error"] is not None:
            raise outcome["error"]
        result = dict(outcome["result"])
        result["hedged"] = outcome["source"] == "hedge"
        return result


def _queries_from_file(path: str) -> List[List[int]]:
    """Reference-format query.bin -> wire lists (utils/io.py loader, so
    the thin client accepts exactly the batch CLI's -q files)."""
    from ..utils.io import load_query_bin

    return [[int(v) for v in group] for group in load_query_bin(path)]


def query_main(argv: Optional[List[str]] = None) -> int:
    """The ``query`` subcommand's entry point."""
    import argparse

    ap = argparse.ArgumentParser(
        prog="msbfs-tpu query",  # the JAX CLI's name: usage lines match
        description="Thin client for the serving daemon (docs/SERVING.md)",
    )
    ap.add_argument(
        "--connect",
        required=True,
        metavar="ADDR",
        help="daemon address: unix:<path> or <host>:<port>",
    )
    ap.add_argument("-q", "--query-file", default=None,
                    help="reference-format query .bin to run")
    ap.add_argument("--graph", default="default",
                    help="registered graph name (default 'default')")
    ap.add_argument("--load", default=None, metavar="PATH",
                    help="register PATH under --graph before querying")
    ap.add_argument("--mutate", default=None, metavar="FILE",
                    help="apply an edge-delta file (gen_cli --deltas "
                    "format) to --graph, one mutate per batch")
    ap.add_argument("--versions", action="store_true",
                    help="print --graph's version chain")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="per-query deadline; the server sheds the "
                    "request once it expires")
    ap.add_argument("--hedge-ms", type=float, default=None,
                    help="hedge the query on a second connection after "
                    "this many ms without an answer")
    ap.add_argument("--weighted", action="store_true",
                    help="answer with weighted distance-to-set (integer "
                    "edge costs); the graph must carry a cost section")
    ap.add_argument("--stats", action="store_true",
                    help="print the daemon's stats report")
    ap.add_argument("--ping", action="store_true", help="liveness check")
    ap.add_argument("--health", action="store_true",
                    help="readiness probe (exit 0 only when the daemon "
                    "reports ready)")
    ap.add_argument("--shutdown", action="store_true",
                    help="ask the daemon to exit")
    args = ap.parse_args(argv)
    if not (args.query_file or args.stats or args.ping or args.health
            or args.shutdown or args.load or args.mutate
            or args.versions):
        ap.error("nothing to do: give -q, --load, --mutate, --versions, "
                 "--stats, --ping, --health or --shutdown")
    try:
        client = MsbfsClient(args.connect)
    except (OSError, ValueError) as exc:
        print(f"msbfs query: cannot reach {args.connect}: {exc}",
              file=sys.stderr)
        return 5  # TransientError's code: the daemon may just be starting
    with client:
        try:
            if args.ping:
                client.ping()
                print("pong", file=sys.stderr)
            if args.health:
                h = client.health()
                ready = bool(h.get("ready"))
                print(
                    f"pid {h.get('pid')}; "
                    f"{'ready' if ready else 'NOT ready'}"
                    f"{' (draining)' if h.get('draining') else ''}; "
                    f"{h.get('graphs_warm', 0)} graph(s), "
                    f"{h.get('warm_buckets', 0)} warm bucket(s); "
                    f"queue depth {h.get('queue_depth', 0)}",
                    file=sys.stderr,
                )
                if not ready:
                    return 5  # probe contract: non-zero until ready
            if args.load:
                info = client.load(args.load, graph=args.graph)["graph"]
                print(
                    f"loaded {info['name']} v{info['version']} "
                    f"({info['n']} vertices, {info['directed_edges']} "
                    f"directed edges, hash {info['hash']})",
                    file=sys.stderr,
                )
            if args.mutate:
                from ..dynamic.delta import load_delta_bin

                _, batches = load_delta_bin(args.mutate)
                for ins, dels in batches:
                    info = client.mutate(
                        inserts=[[int(u), int(v)] for u, v in ins],
                        deletes=[[int(u), int(v)] for u, v in dels],
                        graph=args.graph,
                    )
                    g = info["graph"]
                    print(
                        f"mutated {g['name']} -> delta version "
                        f"{g['delta_version']} (digest {g['digest']}; "
                        f"+{info['applied']['inserts']}/"
                        f"-{info['applied']['deletes']} edges)",
                        file=sys.stderr,
                    )
            if args.versions:
                chain = client.versions(graph=args.graph)
                for row in chain["chain"]:
                    sys.stdout.write(
                        f"v{row['version']} {row['digest']} "
                        f"+{row['inserts']} -{row['deletes']}\n"
                    )
            if args.query_file:
                out = client.query(
                    _queries_from_file(args.query_file),
                    graph=args.graph,
                    deadline_s=(
                        None if args.deadline_ms is None
                        else args.deadline_ms / 1000.0
                    ),
                    hedge_after_s=(
                        None if args.hedge_ms is None
                        else args.hedge_ms / 1000.0
                    ),
                    weighted=args.weighted,
                )
                # The reference report's selection lines, 1-based winner
                # (main.cu:409) — stdout carries results only.
                sys.stdout.write(
                    f"Query number (k) with minimum F value: "
                    f"{out['min_k'] + 1}\n"
                    f"Minimum F value: {out['min_f']}\n"
                )
                k_exec, s_pad = out["bucket"]
                if out["cached"]:
                    # compiled/latency in a cached response describe the
                    # original computation, not this round trip.
                    note = "result-cache hit"
                else:
                    note = (
                        f"computed"
                        f"{' (compiled)' if out.get('compiled') else ''}; "
                        f"latency {out.get('latency_ms', 0)} ms"
                    )
                if out.get("weighted"):
                    note += "; weighted"
                if out.get("hedged"):
                    note += "; answered by the hedge connection"
                print(f"bucket {k_exec}x{s_pad}; {note}", file=sys.stderr)
            if args.stats:
                from ..utils.report import format_server_stats

                sys.stdout.write(format_server_stats(client.stats()))
            if args.shutdown:
                client.shutdown()
                print("daemon shutting down", file=sys.stderr)
        except ServerError as err:
            print(f"msbfs query: {err}", file=sys.stderr)
            return err.exit_code
        except (protocol.ProtocolError, ConnectionError, OSError) as exc:
            print(f"msbfs query: {exc}", file=sys.stderr)
            return 5
    return 0


def trace_main(argv: Optional[List[str]] = None) -> int:
    """The ``trace`` subcommand: export a query's
    distributed trace as Chrome-trace/Perfetto JSON
    (docs/OBSERVABILITY.md "Reading a trace").  Against a fleet front
    end the events already include every replica's spans — the front
    end's ``trace`` verb fans out and merges."""
    import argparse
    import json

    ap = argparse.ArgumentParser(
        prog="msbfs-tpu trace",
        description="Export a per-query distributed trace as "
        "Chrome-trace JSON (load in chrome://tracing or "
        "https://ui.perfetto.dev)",
    )
    ap.add_argument(
        "--connect", required=True, metavar="ADDR",
        help="daemon or fleet front end: unix:<path> or <host>:<port>",
    )
    ap.add_argument(
        "--trace-id", default=None,
        help="trace to export (default: the most recent one the server "
        "holds; run queries with MSBFS_TRACE=1 to create traces)",
    )
    ap.add_argument(
        "--list", action="store_true",
        help="list the trace ids the server currently holds and exit",
    )
    ap.add_argument(
        "-o", "--out", default=None, metavar="PATH",
        help="write the Chrome-trace JSON here (default: stdout)",
    )
    args = ap.parse_args(argv)
    try:
        client = MsbfsClient(args.connect)
    except (OSError, ValueError) as exc:
        print(f"msbfs trace: cannot reach {args.connect}: {exc}",
              file=sys.stderr)
        return 5
    with client:
        try:
            out = client.trace(trace_id=args.trace_id)
        except ServerError as err:
            print(f"msbfs trace: {err}", file=sys.stderr)
            return err.exit_code
        except (protocol.ProtocolError, ConnectionError, OSError) as exc:
            print(f"msbfs trace: {exc}", file=sys.stderr)
            return 5
    if args.list:
        for tid in out.get("traces", []):
            sys.stdout.write(f"{tid}\n")
        return 0
    events = out.get("events", [])
    trace_id = out.get("trace_id")
    if not events:
        print(
            "msbfs trace: no trace events held"
            + (f" for {trace_id}" if trace_id else "")
            + " (run queries with MSBFS_TRACE=1 first)",
            file=sys.stderr,
        )
        return 1
    doc = json.dumps(telemetry.chrome_trace(events), indent=2)
    if args.out:
        with open(args.out, "w", encoding="utf-8") as fh:
            fh.write(doc + "\n")
    else:
        sys.stdout.write(doc + "\n")
    print(
        f"msbfs trace: {len(events)} span event(s) for trace "
        f"{trace_id}"
        + (f" -> {args.out}" if args.out else ""),
        file=sys.stderr,
    )
    return 0

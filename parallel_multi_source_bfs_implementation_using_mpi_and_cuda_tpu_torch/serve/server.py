"""The serving daemon: socket front end, supervised dispatch, stats.

The port's copy of the JAX package's serve/server.py (its docs/SERVING.md
is the operator manual).  ``python -m <port> serve --listen
unix:/tmp/msbfs.sock -g graph.bin`` holds registered graphs resident on
the card (serve/registry.py), coalesces concurrent queries into
power-of-two shape buckets (serve/batcher.py), fronts execution with an
LRU result cache and a warm-up ledger (serve/caches.py), and answers over
the JAX package's length-prefixed JSON frames (serve/protocol.py), so a
client of either package talks to a daemon of either.  Every dispatch
runs under the :class:`ChunkSupervisor`: retries, the capacity ladder and
the watchdog apply per request, and an exhausted recovery budget fails
that request typed while the daemon keeps serving.

The daemon runs on ``cuda`` unless the caller passes ``device="cpu"`` (the
tests); without a card it raises.  It carries the JAX daemon's crash
safety (the journal, replay and re-warm, drain on SIGTERM/SIGINT, the
``health`` readiness report, quarantine of a poisoned query by batch
bisection, client deadlines) and its dynamic graphs (``mutate`` with
exactly-once tokens, ``versions``, and host repair of a retained distance
plane, dynamic/repair.py, exact and sampled through the certificate).

Differences on purpose:

* **One engine call at a time per entry.**  JAX's jitted functions are
  pure, so its warm thread may compile while the batcher dispatches on
  the same entry.  The port's engines update their device carries in
  place, so every engine call — warm-up, dispatch, quarantine
  re-dispatch, the weighted engine's too — holds the entry's
  ``engine_lock``.  Each thread that touches an engine (the batcher, the
  journal's warm thread, the connection threads that build engines) sets
  the registry's CUDA device first.
* **The answer crosses to the host once per dispatch**: the F tensor of
  the coalesced batch is read back in one copy and sliced per request.
* **A "compile" is a warm-up**: ``engine.compile(shape)`` runs one batch
  of the bucket's shape; the CUDA kernels build once per process at first
  use.  The compile ledger keeps JAX's meaning (one per new bucket).
* **``MSBFS_CACHE_DIR``** (JAX's persistent XLA cache, configured where
  its daemon starts) is refused with exit 1: the port builds its kernels
  into the package's ``build/``.
"""

from __future__ import annotations

import os
import random
import socket
import sys
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch


from ..runtime.supervisor import (
    BackpressureError,
    CorruptionError,
    FencedError,
    InputError,
    MsbfsError,
    PoisonQueryError,
    StorageError,
    TransientError,
    classify,
)
from ..utils import faults, knobs, telemetry
from ..utils.telemetry import (
    Histogram,
    TraceContext,
    dump_flight,
    log_line,
    record_flight,
    span,
    use_trace,
)
from . import lifecycle, observe, protocol
from .batcher import (
    PRIORITIES,
    MicroBatcher,
    QueryRequest,
    bucket_label,
    pow2_pad,
)
from .caches import ExecutableCache, LRUCache, PlaneCache
from .journal import StateJournal, _valid_pairs as _valid_edge_pairs
from .registry import GraphEntry, GraphRegistry

DEFAULT_RESULT_CACHE = 1024
# Repair-seed plane budget (docs/SERVING.md "Mutations & versions"):
# one (K, n) int32 plane per distinct query shape per graph, so the cap
# is sized for a handful of hot queries, not the whole result cache.
DEFAULT_PLANE_CACHE_BYTES = 256 << 20
# A request parked behind a full pipeline must eventually fail typed
# rather than hold its connection forever.
DEFAULT_REQUEST_TIMEOUT_S = 300.0
# Graceful-drain budget: queued + in-flight batches get this long to
# finish before the remainder fails typed and the process exits.
DEFAULT_DRAIN_S = 10.0

# Query-shape sanity bounds, the reference's own format limits: K and
# group size are uint8 on disk (main.cu:143-152).  The wire accepts more
# (a service is not bound to the file format) but still bounds both so a
# hostile frame cannot demand a terabyte batch.
MAX_WIRE_QUERIES = 4096
MAX_WIRE_GROUP = 4096


def _pkg_version() -> str:
    """Package version for stats/health: a restarted replica running a
    different build must be tellable apart in fleet roll-ups.  Lazy so
    the parent package's own import of this module cannot cycle."""
    try:
        from .. import __version__

        return str(__version__)
    except Exception:  # noqa: BLE001 — versioning must never fail a verb
        return "unknown"


def _env_int(name: str, default: int) -> int:
    return knobs.get_int(name, default)


def _env_float(name: str, default: float) -> float:
    return knobs.get_float(name, default)


def _plane_policy() -> str:
    """``MSBFS_SERVE_PLANES``: when does a query retain its distance
    plane as a repair seed?  ``auto`` (default) retains only for graphs
    that already carry a delta chain — the one case a seed provably pays
    off; ``1`` always retains (operator knows mutations are coming);
    ``0`` never does (repair still runs off planes stored by earlier
    repairs).  Malformed values fall back to the default with a stderr
    note, the repo-wide knob convention."""
    raw = knobs.raw("MSBFS_SERVE_PLANES", "auto").strip().lower()
    if raw in ("auto", ""):
        return "auto"
    if raw in ("1", "on", "always"):
        return "1"
    if raw in ("0", "off", "never"):
        return "0"
    print(
        f"msbfs serve: MSBFS_SERVE_PLANES={raw!r} is not auto/1/0; "
        "using auto",
        file=sys.stderr,
    )
    return "auto"


def _percentile(sorted_vals: List[float], q: float) -> float:
    """Nearest-rank percentile over an already-sorted sample."""
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, max(0, int(round(q * (len(sorted_vals) - 1)))))
    return sorted_vals[idx]


class _BucketStats:
    """Per-bucket latency/throughput ledger: a bounded reservoir for the
    exact recent percentiles plus a fixed-log2-bucket histogram
    (utils/telemetry.py) that the fleet roll-up can merge across
    replicas — the reservoir cannot merge, the histogram can."""

    __slots__ = ("requests", "batches", "rows", "cache_hits",
                 "samples_ms", "hist")

    MAX_SAMPLES = 1024

    def __init__(self):
        self.requests = 0
        self.batches = 0
        self.rows = 0
        self.cache_hits = 0
        self.samples_ms: List[float] = []
        self.hist = Histogram()

    def record(self, latency_ms: float) -> None:
        self.requests += 1
        self.hist.observe(latency_ms)
        if len(self.samples_ms) >= self.MAX_SAMPLES:
            # Keep the freshest window: percentile reports should track
            # current behavior, not the cold-start tail forever.
            self.samples_ms.pop(0)
        self.samples_ms.append(latency_ms)

    def snapshot(self) -> dict:
        s = sorted(self.samples_ms)
        return {
            "requests": self.requests,
            "batches": self.batches,
            "rows": self.rows,
            "cache_hits": self.cache_hits,
            "p50_ms": round(_percentile(s, 0.50), 3),
            "p95_ms": round(_percentile(s, 0.95), 3),
            "p99_ms": round(_percentile(s, 0.99), 3),
            "hist": self.hist.snapshot(),
        }


class MsbfsServer:
    """One process-wide serving runtime; embeddable (tests run it
    in-process on a unix socket) or daemonized via :func:`serve_main`."""

    def __init__(
        self,
        listen: str,
        graphs: Optional[Dict[str, str]] = None,
        queue_capacity: Optional[int] = None,
        window_s: Optional[float] = None,
        result_cache_size: Optional[int] = None,
        request_timeout_s: Optional[float] = None,
        journal_path: Optional[str] = None,
        drain_deadline_s: Optional[float] = None,
        epoch_path: Optional[str] = None,
        device=None,
        native: bool = True,
    ):
        unported = knobs.unported_cache_dir()
        if unported:
            raise InputError(
                f"{unported} is not yet ported to the PyTorch/CUDA package"
            )
        self.listen = listen
        self.registry = GraphRegistry(device, native)
        self.result_cache = LRUCache(
            result_cache_size
            if result_cache_size is not None
            else _env_int("MSBFS_SERVE_RESULT_CACHE", DEFAULT_RESULT_CACHE)
        )
        self.executables = ExecutableCache()
        # Repair seeds for the dynamic-graph path: planes survive
        # mutations BY DESIGN (serve/caches.py module docstring) —
        # only reload and eviction drop them.
        self.planes = PlaneCache(
            _env_int("MSBFS_SERVE_PLANE_CACHE_BYTES",
                     DEFAULT_PLANE_CACHE_BYTES)
        )
        self.plane_policy = _plane_policy()
        self.batcher = MicroBatcher(
            self._execute_batch, capacity=queue_capacity, window_s=window_s
        )
        self.request_timeout_s = (
            request_timeout_s
            if request_timeout_s is not None
            else _env_float("MSBFS_SERVE_TIMEOUT", DEFAULT_REQUEST_TIMEOUT_S)
        )
        if journal_path is None:
            journal_path = knobs.raw("MSBFS_SERVE_JOURNAL", "") or None
        self.journal = StateJournal(journal_path) if journal_path else None
        self.drain_deadline_s = (
            drain_deadline_s
            if drain_deadline_s is not None
            else _env_float("MSBFS_SERVE_DRAIN", DEFAULT_DRAIN_S)
        )
        self.started = time.time()
        self._stats_lock = threading.Lock()
        self._buckets: Dict[str, _BucketStats] = {}
        self._recovery_events: List[dict] = []
        self._failed_requests = 0
        self._requests_total = 0
        self._shard_steps = 0
        self._shed_requests = 0
        self._shed_brownout = 0
        self._quarantined_requests = 0
        # Dynamic-graph ledger: one mutate at a time per daemon (the
        # registry would survive concurrency, but the journal's chain
        # order must match the applied order exactly).
        self._mutate_lock = threading.Lock()
        self._mutations = 0
        # Exactly-once mutate (docs/SERVING.md "Cross-machine transport
        # & fencing"): applied idempotency tokens, insertion-ordered so
        # the bounded window evicts oldest-first.  Guarded by
        # _mutate_lock (the same lock that orders the journal chain).
        self._mutate_tokens: Dict[str, dict] = {}
        self._mutate_dedup_window = _env_int("MSBFS_MUTATE_DEDUP_WINDOW",
                                             1024)
        self._mutations_deduplicated = 0
        # Epoch fencing: the fleet supervisor's fsync'd membership
        # counter, read (stat-cached) per epoch-carrying frame so a
        # stale peer is refused without a syscall storm.
        self._epoch_path = epoch_path
        self._epoch_cache: Tuple[Optional[tuple], int] = (None, 0)
        self._fenced_requests = 0
        self._requests_repaired = 0
        self._repair_fallbacks = 0
        self._planes_retained = 0
        self._repair_audited = 0
        self._repair_audit_failures = 0
        # Brownout posture (serve/brownout.py, pushed by the fleet's
        # ``posture`` verb): an audit-sample override applied to every
        # supervisor — including ones registered later — and the
        # cache-only switch for batch-priority traffic.
        self._posture_audit: Optional[float] = None
        self._posture_cache_only = False
        self._audit_saved: Dict[str, float] = {}  # pre-override samples
        self._last_batch_ts: Optional[float] = None
        self._sock: Optional[socket.socket] = None
        self._accept_thread: Optional[threading.Thread] = None
        self._warm_thread: Optional[threading.Thread] = None
        self._stopping = threading.Event()
        self._wake = threading.Event()  # wait() wakes on stop OR drain
        self._draining = False
        self._drain_signal = threading.Event()  # caps supervisor backoffs
        self._active_requests = 0  # connections mid handle/send
        self._active_zero = threading.Condition(self._stats_lock)
        self._replayed = threading.Event()  # registry restored from journal
        self._ready = threading.Event()  # replay AND re-warm finished
        self._journal_stats = {"replayed": 0, "dropped": 0}
        # Silent-data-corruption defenses (docs/RESILIENCE.md): graphs
        # whose on-disk bytes flunked the journaled digest at replay.
        self._refused_graphs: Dict[str, str] = {}
        for name, path in (graphs or {}).items():
            self._register(name, path)

    # ---- registration (journal-aware) -------------------------------------
    def _register(
        self, name: str, path: str, expected_hash: Optional[str] = None
    ) -> GraphEntry:
        """registry.load + drain-signal hookup + journal append.  Every
        registration path (CLI -g, the load verb, journal replay) funnels
        through here so none can silently skip the journal.
        ``expected_hash`` (journal replay) refuses typed when the file
        no longer matches the journaled content digest."""
        known = self.registry.maybe_get(name)
        entry = self.registry.load(name, path, expected_hash=expected_hash)
        entry.supervisor.drain_signal = self._drain_signal
        if self._posture_audit is not None:
            # A graph registered mid-brownout inherits the pushed
            # posture; its configured rate is stashed like the rest so
            # the restore push puts it back.
            self._audit_saved.setdefault(
                name, float(entry.supervisor.audit_sample)
            )
            entry.supervisor.audit_sample = self._posture_audit
        if self.journal is not None and (known is None or known is not entry):
            try:
                self.journal.append(
                    {"op": "load", "name": name, "path": path,
                     "hash": entry.hash}
                )
            except StorageError:
                # The refusal must unwind the in-memory registration too:
                # keeping the entry would make a retry after freeing disk
                # hit load-once and skip the append forever — registered,
                # acked, and still invisible to the next journal replay
                # (docs/RESILIENCE.md "Disk exhaustion").
                self.registry.evict(name)
                raise
        return entry

    # ---- lifecycle --------------------------------------------------------
    @property
    def draining(self) -> bool:
        return self._draining

    @property
    def stopping(self) -> bool:
        return self._stopping.is_set()

    def start(self) -> None:
        """Bind, arm the fault plan, start batcher + acceptor, kick off
        journal replay.  Returns once the socket accepts connections
        (callers/tests need no poll-until-up loop); replay + re-warm run
        on a background thread — ``health`` reports when they finish."""
        # Same bring-up order as the batch CLI (cli.py): the fault plan
        # first so every later seam sees it.  (JAX configures its
        # persistent XLA cache here; the port refused MSBFS_CACHE_DIR in
        # the constructor.)
        plan = faults.FaultPlan.from_env()
        faults.activate(plan)
        # A pre-existing unix socket is either a live daemon (refuse,
        # typed) or a crash leftover (reclaim) — never blind-unlinked.
        lifecycle.reclaim_stale_socket(self.listen)
        family, target = protocol.parse_address(self.listen)
        self._sock = socket.socket(family, socket.SOCK_STREAM)
        if family == socket.AF_INET:
            self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind(target)
        # Deep backlog: under a stampede burst the acceptor thread can
        # be GIL-starved by query compute for whole seconds; a shallow
        # queue then BLOCKS further unix connect()s until the dialer's
        # timeout, shedding queries the replica could have served.
        # Parked-in-backlog dials cost nothing and drain as the acceptor
        # catches up (the kernel caps this at net.core.somaxconn).
        self._sock.listen(512)
        # Closing a socket does NOT wake a thread blocked in accept() on
        # Linux; a short accept timeout bounds how long the acceptor can
        # outlive stop() (the leak check in tests/conftest.py watches).
        self._sock.settimeout(0.2)
        self.batcher.start()
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="msbfs-accept", daemon=True
        )
        self._accept_thread.start()
        if self.journal is None:
            self._replayed.set()
            self._ready.set()
        else:
            self._warm_thread = threading.Thread(
                target=self._replay_journal, name="msbfs-warm", daemon=True
            )
            self._warm_thread.start()

    def _replay_journal(self) -> None:
        """Restore registered graphs, then re-warm journaled buckets.
        Stateful verbs wait on ``_replayed`` (registry restored) so a
        client query racing the restart sees the pre-crash registry, not
        an empty one; ``_ready`` additionally waits out the warm-up
        compiles and is what external probes should gate traffic on."""
        self._bind_device()
        try:
            state = self.journal.replay()
            with self._stats_lock:
                self._journal_stats = {
                    "replayed": state.replayed,
                    "dropped": state.dropped,
                }
            for name, (path, digest) in sorted(state.graphs.items()):
                if self._stopping.is_set():
                    return
                try:
                    # The journaled digest is an integrity contract, not
                    # a hint: a file whose bytes changed underneath the
                    # journal is REFUSED typed (CorruptionError) and
                    # stays out of the registry — an operator must
                    # re-load it deliberately.  The record stays in the
                    # journal so a restored file recovers on the next
                    # restart.
                    self._register(name, path, expected_hash=digest)
                except CorruptionError as exc:
                    with self._stats_lock:
                        self._refused_graphs[name] = str(exc)
                    print(
                        f"msbfs serve: journal replay refused graph "
                        f"{name!r}: {exc}",
                        file=sys.stderr,
                    )
                    continue
                except (MsbfsError, OSError, ValueError) as exc:
                    print(
                        f"msbfs serve: journal replay cannot restore "
                        f"graph {name!r} from {path}: {exc}",
                        file=sys.stderr,
                    )
                    continue
            for name, chain in sorted(state.deltas.items()):
                if self._stopping.is_set():
                    return
                self._replay_deltas(name, chain)
            # Replay folded the history; rewrite the journal down to the
            # reconciled state so it cannot grow without bound.  This
            # MUST happen before _replayed opens the verb gate: every
            # journal append after boot comes from a verb handler (or
            # the batcher serving an admitted query), all of which wait
            # on _replayed — compacting later would race those appends
            # and silently erase a freshly journaled mutate/load/warm.
            self.journal.compact(state)
            self._replayed.set()
            for name, digest, k_exec, s_pad in sorted(state.warm):
                if self._stopping.is_set() or self._draining:
                    return
                entry = self.registry.maybe_get(name)
                if entry is None or entry.hash != digest:
                    continue
                self._warm_bucket(entry, k_exec, s_pad)
        finally:
            self._replayed.set()  # never leave verbs gated by a crash here
            self._ready.set()

    def _replay_deltas(self, name: str, chain: List[dict]) -> None:
        """Re-apply one graph's journaled delta chain in order, holding
        each re-derived digest against the journaled one — the mutation
        analog of the loader's ``expected_hash`` contract.  A chain that
        stops reproducing its digests means the journal (or the base
        content it chains from) was corrupted: the whole registration is
        REFUSED typed and evicted, because serving any version of it
        would silently answer from different data than the journal
        promised."""
        for i, rec in enumerate(chain):
            if self._stopping.is_set():
                return
            try:
                entry, batch = self.registry.mutate(
                    name, rec["inserts"], rec["deletes"]
                )
            except MsbfsError as exc:
                reason = (
                    f"delta {i + 1}/{len(chain)} failed to re-apply: {exc}"
                )
                self._refuse_replayed_graph(name, reason)
                return
            entry.supervisor.drain_signal = self._drain_signal
            if batch.digest != rec["digest"]:
                reason = (
                    f"delta {i + 1}/{len(chain)} re-derives digest "
                    f"{batch.digest}, journal records {rec['digest']}: "
                    "the chain no longer verifies"
                )
                self._refuse_replayed_graph(name, reason)
                return
            # Restore the dedup window BEFORE the verb gate opens: a
            # retry whose original landed just before the kill must
            # re-ack, not re-apply.  The i-th delta produced version
            # i+1 (version 0 is the base file content).
            self._record_mutate_token(rec.get("token"), name, i + 1,
                                      rec["digest"])

    def _refuse_replayed_graph(self, name: str, reason: str) -> None:
        self.registry.evict(name)
        with self._stats_lock:
            self._refused_graphs[name] = reason
        print(
            f"msbfs serve: journal replay refused graph {name!r}: "
            f"{reason}",
            file=sys.stderr,
        )

    def _bind_device(self) -> None:
        """Make the registry's card this thread's current CUDA device (a
        no-op on the CPU)."""
        dev = self.registry.device
        if dev.type == "cuda":
            torch.cuda.set_device(dev)

    def _warm_bucket(self, entry: GraphEntry, k_exec: int, s_pad: int) -> None:
        label = bucket_label(entry.key, k_exec, s_pad)

        def warm():
            with entry.engine_lock:
                entry.supervisor.compile((k_exec, s_pad))

        try:
            self.executables.warm((entry.key, k_exec, s_pad, False), label, warm)
        except Exception as exc:  # noqa: BLE001 — warmth is best-effort
            print(
                f"msbfs serve: re-warm of bucket {label} failed: "
                f"{classify(exc)}",
                file=sys.stderr,
            )

    def request_drain(self) -> None:
        """Flip into drain mode: refuse new stateful work, stop
        accepting connections, cap supervisor backoff sleeps.  Safe from
        signal handlers (only sets flags/events); the blocking part is
        :meth:`drain`, run by the thread parked in :meth:`wait`."""
        self._draining = True
        self._drain_signal.set()
        self.batcher.begin_drain()
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
        self._wake.set()

    def drain(self, deadline_s: Optional[float] = None) -> bool:
        """Finish queued + in-flight batches within the deadline, flush
        connection handlers, then stop.  True = everything completed;
        False = the deadline expired and the remainder failed typed."""
        if not self._draining:
            self.request_drain()
        deadline_s = (
            self.drain_deadline_s if deadline_s is None else deadline_s
        )
        clean = self.batcher.drain(deadline_s)
        if not clean:
            failed = self.batcher.fail_pending(
                TransientError(
                    f"server drained away before this request ran "
                    f"(deadline {deadline_s:g}s); retry elsewhere"
                )
            )
            print(
                f"msbfs serve: drain deadline ({deadline_s:g}s) expired; "
                f"failed {failed} queued request(s) typed",
                file=sys.stderr,
            )
        # Let connection threads flush the responses they now hold.
        flush_limit = time.time() + 5.0
        with self._active_zero:
            while self._active_requests > 0 and time.time() < flush_limit:
                self._active_zero.wait(0.05)
        self.stop()
        return clean

    def stop(self) -> None:
        self._stopping.set()
        self._drain_signal.set()
        self._wake.set()
        self.batcher.stop()
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
        family, target = protocol.parse_address(self.listen)
        if family == socket.AF_UNIX and isinstance(target, str):
            try:
                os.unlink(target)
            except FileNotFoundError:
                pass

    def wait(self) -> str:
        """Block until stop() or request_drain() (the daemon's
        main-thread parking spot).  Returns ``"stop"`` or ``"drain"`` so
        :func:`serve_main` knows whether a drain still has to run."""
        self._wake.wait()
        return "stop" if self._stopping.is_set() else "drain"

    # ---- socket front end -------------------------------------------------
    def _accept_loop(self) -> None:
        while not self._stopping.is_set():
            try:
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue  # periodic stop-flag check
            except OSError:
                return  # listener closed
            # Accepted sockets inherit the listener's timeout; connection
            # handlers must block indefinitely between frames instead.
            conn.settimeout(None)
            threading.Thread(
                target=self._serve_connection,
                args=(conn,),
                name="msbfs-conn",
                daemon=True,
            ).start()

    def _serve_connection(self, conn: socket.socket) -> None:
        self._bind_device()  # load/reload/mutate build engines here
        with conn:
            while not self._stopping.is_set():
                try:
                    request = protocol.recv_frame(conn)
                except protocol.ProtocolError as exc:
                    # Answer if the socket still writes, then drop the
                    # connection: framing is unrecoverable mid-stream.
                    # A crc32 mismatch is the one TRANSIENT shape — the
                    # frame was damaged in flight, so the caller (and
                    # the fleet router's failover walk) should resend,
                    # not fix their input.
                    err = (
                        TransientError(str(exc))
                        if isinstance(exc, protocol.FrameCorruptError)
                        else InputError(str(exc))
                    )
                    try:
                        protocol.send_frame(conn, protocol.error_body(err))
                    except OSError:
                        pass
                    return
                except OSError:
                    return
                if request is None:
                    return
                # The handle+send pair counts as "active": drain() waits
                # for this window so a completed batch's response cannot
                # be lost in the exit race.
                with self._active_zero:
                    self._active_requests += 1
                try:
                    response = self.handle(request)
                    try:
                        protocol.send_frame(conn, response)
                    except OSError:
                        return
                finally:
                    with self._active_zero:
                        self._active_requests -= 1
                        if self._active_requests == 0:
                            self._active_zero.notify_all()
                if request.get("op") == "shutdown":
                    self.stop()
                    return

    # ---- verbs ------------------------------------------------------------
    def handle(self, request: dict) -> dict:
        """One request object -> one response object (transport-free:
        the tests may call this directly; the wire path goes through
        :meth:`_serve_connection`).  A request carrying a ``trace``
        field gets its context installed for the handler's duration so
        every span below — admission, batch, supervisor, engine —
        lands on the caller's trace_id (docs/OBSERVABILITY.md)."""
        ctx = TraceContext.from_wire(request.get("trace"))
        if ctx is None:
            return self._handle(request)
        with use_trace(ctx):
            return self._handle(request)

    def _current_epoch(self, refresh: bool = False) -> int:
        """The fleet-membership epoch this replica serves under: the
        supervisor's fsync'd counter file, cached by (mtime_ns, size) so
        the steady state is one stat per frame, not one read.  No epoch
        file (single-daemon deployment) = epoch 0."""
        path = self._epoch_path
        if path is None:
            return 0
        try:
            st = os.stat(path)
        except OSError:
            return self._epoch_cache[1]
        key = (st.st_mtime_ns, st.st_size)
        if not refresh and self._epoch_cache[0] == key:
            return self._epoch_cache[1]
        try:
            with open(path, "r", encoding="utf-8") as f:
                val = int(f.read().strip() or 0)
        except (OSError, ValueError):
            val = self._epoch_cache[1]
        self._epoch_cache = (key, val)
        return val

    def _check_epoch(self, frame_epoch) -> None:
        """Fence a frame's membership view against ours (docs/SERVING.md
        "Cross-machine transport & fencing").  Equal serves; stale is
        refused — a partition-healed or resurrected peer must never be
        served under an old view; FUTURE is also refused (after a
        cache-busting re-read, in case the supervisor bumped the file
        an instant ago): this replica's own view is the stale one, and
        serving would journal/answer under a membership it does not yet
        hold.  Frames without an epoch (pre-fencing peers, single-daemon
        clients) pass — tolerated-absent, like the crc flag."""
        if self._epoch_path is None:
            return
        try:
            frame_epoch = int(frame_epoch)
        except (TypeError, ValueError):
            raise InputError(
                f"frame 'epoch' must be an integer, got {frame_epoch!r}"
            ) from None
        local = self._current_epoch()
        if frame_epoch != local:
            local = self._current_epoch(refresh=True)
        if frame_epoch == local:
            return
        with self._stats_lock:
            self._fenced_requests += 1
        if frame_epoch < local:
            raise FencedError(
                f"frame epoch {frame_epoch} is stale: fleet membership "
                f"is at epoch {local}; refresh the view and resend",
                frame_epoch=frame_epoch, local_epoch=local,
            )
        raise FencedError(
            f"frame epoch {frame_epoch} is ahead of this replica's view "
            f"({local}): the sender knows a membership this replica has "
            "not observed; refusing to serve under a stale local view",
            frame_epoch=frame_epoch, local_epoch=local,
        )

    def _handle(self, request: dict) -> dict:
        op = request.get("op")
        try:
            if "epoch" in request and request["epoch"] is not None:
                self._check_epoch(request["epoch"])
            if op == "ping":
                return {"ok": True, "op": "ping", "pid": os.getpid()}
            if op == "health":
                return self._op_health()
            if op in ("load", "reload", "query", "mutate", "versions",
                      "shard_step"):
                if self._draining and op != "versions":
                    # versions is read-only (like stats) and stays
                    # answerable while draining; the rest is refused.
                    raise TransientError(
                        "server is draining; retry against another "
                        "instance"
                    )
                # Stateful verbs see the post-replay registry: a query
                # racing a crash-restart must not observe the window
                # where journaled graphs are still being restored.
                if not self._replayed.wait(self.request_timeout_s):
                    raise TransientError(
                        "journal replay still running after "
                        f"{self.request_timeout_s:g}s; retry"
                    )
            if op == "load":
                return self._op_load(request)
            if op == "reload":
                return self._op_reload(request)
            if op == "query":
                return self._op_query(request)
            if op == "shard_step":
                return self._op_shard_step(request)
            if op == "mutate":
                return self._op_mutate(request)
            if op == "versions":
                return self._op_versions(request)
            if op == "stats":
                return {"ok": True, "op": "stats", "stats": self.stats()}
            if op == "trace":
                # Read-only, like stats: answerable while draining.
                return observe.op_trace(request)
            if op == "metrics":
                return {
                    "ok": True,
                    "op": "metrics",
                    "text": observe.server_metrics_text(self),
                }
            if op == "posture":
                return self._op_posture(request)
            if op == "shutdown":
                return {"ok": True, "op": "shutdown"}
            raise InputError(f"unknown op {op!r}")
        except MsbfsError as err:
            return protocol.error_body(err)
        except Exception as exc:  # noqa: BLE001 — daemon must answer typed
            return protocol.error_body(classify(exc))

    def _op_health(self) -> dict:
        """Readiness probe, deliberately richer than ``ping``: a load
        balancer should admit traffic on ``ready``, not on "the socket
        answers" (a daemon mid-replay answers pings)."""
        with self._stats_lock:
            journal_stats = dict(self._journal_stats)
            last_batch = self._last_batch_ts
        warm = self.executables.warmed_count()
        return {
            "ok": True,
            "op": "health",
            "pid": os.getpid(),
            "version": _pkg_version(),
            "ready": self._ready.is_set(),
            "draining": self._draining,
            "fleet_epoch": self._current_epoch(),
            "uptime_s": round(time.time() - self.started, 3),
            "graphs": sorted(self.registry.describe()),
            "graphs_warm": len(self.registry.describe()),
            "warm_buckets": warm,
            "queue_depth": self.batcher.depth(),
            # The autoscaler's input gauge: depth over capacity plus the
            # monotonic-clock age of the queue head (0.0 when empty; a
            # wall-clock step can never read as a drained queue).
            # Semantics pinned by tests/test_stampede.py.
            "queue": {
                "depth": self.batcher.depth(),
                "capacity": self.batcher.capacity,
                "oldest_age_s": round(self.batcher.oldest_age(), 6),
            },
            "last_batch_age_s": (
                None if last_batch is None
                else round(time.time() - last_batch, 3)
            ),
            "journal": {
                "path": self.journal.path if self.journal else None,
                "replay_done": self._ready.is_set(),
                **journal_stats,
            },
            # Disk-exhaustion gauge (docs/RESILIENCE.md "Disk
            # exhaustion"): latched False by a failed append until one
            # lands again.  A daemon with no journal is vacuously
            # writable — there is nothing to lose.
            "journal_writable": (
                self.journal.writable if self.journal else True
            ),
        }

    def _op_load(self, request: dict) -> dict:
        path = request.get("path")
        if not isinstance(path, str) or not path:
            raise InputError("load needs a 'path' string")
        name = request.get("graph", "default")
        entry = self._register(name, path)
        return {"ok": True, "op": "load", "graph": entry.describe()}

    def _op_reload(self, request: dict) -> dict:
        name = request.get("graph", "default")
        old = self.registry.get(name)
        entry = self.registry.reload(name)
        entry.supervisor.drain_signal = self._drain_signal
        if self.journal is not None:
            self.journal.append(
                {"op": "reload", "name": name, "path": entry.path,
                 "hash": entry.hash}
            )
        # Version bump already unreaches old entries; drop them eagerly
        # so a reloaded daemon's cache is not half full of dead weight.
        dropped = self.result_cache.drop_where(
            lambda k: isinstance(k, tuple) and k[0] == old.key
        )
        self.executables.drop_where(
            lambda k: isinstance(k, tuple) and k[0] == old.key
        )
        # Unlike a mutate, a reload DOES kill repair seeds: the new file
        # is fresh content with no delta chain connecting the old planes
        # to it.
        self.planes.drop_where(
            lambda k: isinstance(k, tuple) and k[0] == name
        )
        return {
            "ok": True,
            "op": "reload",
            "graph": entry.describe(),
            "invalidated_results": dropped,
        }

    def _op_shard_step(self, request: dict) -> dict:
        """Expand one scatter/gather frontier round against a locally
        registered row-range shard (docs/SERVING.md "Sharded graphs").
        The fleet router drives the level-synchronous BFS and owns the
        distance state; this verb is one fragment of one level — for
        each query, the union of the neighbors of the given frontier
        vertices.  Every frontier vertex must fall inside the shard's
        declared row range [lo, hi): a shard artifact carries complete
        adjacency only for its own rows (out-of-range rows exist in the
        loaded CSR as loader-doubled reverse records, i.e. PARTIAL
        adjacency), so expanding one would return a silently wrong
        neighbor set — exactly the class of bug this check fails loud
        on."""
        name = request.get("graph", "default")
        entry = self.registry.get(name)
        g = entry.graph
        rows = request.get("rows")
        if (
            not isinstance(rows, (list, tuple))
            or len(rows) != 2
            or not all(
                isinstance(x, int) and not isinstance(x, bool) for x in rows
            )
        ):
            raise InputError("shard_step needs 'rows': [lo, hi]")
        lo, hi = int(rows[0]), int(rows[1])
        if not (0 <= lo < hi <= g.n):
            raise InputError(
                f"shard_step rows [{lo}, {hi}) fall outside graph "
                f"{name!r}'s vertex space [0, {g.n})"
            )
        frontier = request.get("frontier")
        if not isinstance(frontier, list):
            raise InputError(
                "shard_step needs 'frontier': one vertex list per query"
            )
        ro = np.asarray(g.row_offsets, dtype=np.int64)
        ci = np.asarray(g.col_indices, dtype=np.int64)
        frontier_out: List[List[int]] = []
        expanded = 0
        for i, group in enumerate(frontier):
            if not isinstance(group, list):
                raise InputError(
                    f"shard_step frontier group {i} is not a list"
                )
            try:
                verts = np.asarray(group, dtype=np.int64)
            except (TypeError, ValueError, OverflowError):
                raise InputError(
                    f"shard_step frontier group {i} has a non-int vertex"
                ) from None
            if verts.size == 0:
                frontier_out.append([])
                continue
            if int(verts.min()) < lo or int(verts.max()) >= hi:
                raise InputError(
                    f"shard_step frontier group {i} has vertices outside "
                    f"the shard's row range [{lo}, {hi}); the router must "
                    "scatter each row to the shard that owns it"
                )
            starts = ro[verts]
            counts = ro[verts + 1] - starts
            total = int(counts.sum())
            if total == 0:
                frontier_out.append([])
                continue
            # Vectorized ragged gather: edge index = per-vertex start
            # repeated over its degree, plus the within-row offset.
            within = np.arange(total, dtype=np.int64) - np.repeat(
                np.cumsum(counts) - counts, counts
            )
            neigh = np.unique(ci[np.repeat(starts, counts) + within])
            frontier_out.append([int(v) for v in neigh])
            expanded += total
        with self._stats_lock:
            self._shard_steps += 1
        return {
            "ok": True,
            "op": "shard_step",
            "graph": name,
            "rows": [lo, hi],
            "frontier_out": frontier_out,
            "edges_expanded": expanded,
        }

    def _op_mutate(self, request: dict) -> dict:
        """Append one edge-delta batch to a graph's version chain
        (docs/SERVING.md "Mutations & versions").  The registry swaps in
        an entry serving the patched CSR; the journal records the
        CANONICALIZED batch plus its chained digest, so a kill -9
        restart replays the exact chain and can verify it; result/
        executable caches keyed to the pre-delta entry are dropped
        (unreachable anyway — the delta digest rides the key — but a
        mutated daemon's cache should not fill with dead weight).
        Distance planes are deliberately NOT dropped: a stale plane is
        the repair path's seed."""
        name = request.get("graph", "default")
        inserts = request.get("inserts", [])
        deletes = request.get("deletes", [])
        if not _valid_edge_pairs(inserts) or not _valid_edge_pairs(deletes):
            raise InputError(
                "mutate needs 'inserts'/'deletes': lists of [u, v] "
                "integer vertex pairs"
            )
        if len(inserts) + len(deletes) > MAX_WIRE_QUERIES * 4:
            raise InputError(
                f"{len(inserts) + len(deletes)} mutations exceed the "
                f"{MAX_WIRE_QUERIES * 4} per-request bound; split the "
                "batch"
            )
        token = request.get("token")
        if token is not None and (not isinstance(token, str) or not token):
            raise InputError("mutate 'token' must be a non-empty string")
        with self._mutate_lock:
            if token is not None:
                hit = self._mutate_tokens.get(token)
                if hit is not None:
                    # Exactly-once: a retry/hedge/duplicated frame whose
                    # original already applied re-acks the ORIGINAL
                    # version+digest — the chain advances once per token,
                    # however many copies the network delivers.
                    with self._stats_lock:
                        self._mutations_deduplicated += 1
                    entry = self.registry.maybe_get(hit["name"])
                    record_flight("mutate_dedup", graph=hit["name"],
                                  version=hit["version"])
                    return {
                        "ok": True,
                        "op": "mutate",
                        "graph": (entry.describe() if entry is not None
                                  else {"name": hit["name"]}),
                        "applied": {"inserts": 0, "deletes": 0},
                        "deduplicated": True,
                        "version": hit["version"],
                        "digest": hit["digest"],
                        "invalidated_results": 0,
                    }
            old = self.registry.get(name)
            entry, batch = self.registry.mutate(name, inserts, deletes)
            entry.supervisor.drain_signal = self._drain_signal
            if self._posture_audit is not None:
                # A mid-brownout mutate inherits the pushed posture,
                # same as a mid-brownout load (see _register).
                self._audit_saved.setdefault(
                    name, float(old.supervisor.audit_sample)
                )
                entry.supervisor.audit_sample = self._posture_audit
            if self.journal is not None:
                journal_record = {
                    "op": "mutate",
                    "name": name,
                    "inserts": [
                        [int(u), int(v)] for u, v in batch.inserts
                    ],
                    "deletes": [
                        [int(u), int(v)] for u, v in batch.deletes
                    ],
                    "digest": batch.digest,
                }
                if token is not None:
                    # Token rides the journal so a retry that straddles
                    # a kill -9 still dedups after replay.
                    journal_record["token"] = token
                self.journal.append(journal_record)
            self._record_mutate_token(
                token, name, entry.delta_version, batch.digest
            )
        dropped = self.result_cache.drop_where(
            lambda k: isinstance(k, tuple) and k[0] == old.key
        )
        self.executables.drop_where(
            lambda k: isinstance(k, tuple) and k[0] == old.key
        )
        with self._stats_lock:
            self._mutations += 1
        record_flight("mutate", graph=name,
                      inserts=int(batch.inserts.shape[0]),
                      deletes=int(batch.deletes.shape[0]),
                      version=entry.delta_version)
        return {
            "ok": True,
            "op": "mutate",
            "graph": entry.describe(),
            "applied": {
                "inserts": int(batch.inserts.shape[0]),
                "deletes": int(batch.deletes.shape[0]),
            },
            "deduplicated": False,
            "version": entry.delta_version,
            "digest": batch.digest,
            "invalidated_results": dropped,
        }

    def _record_mutate_token(self, token: Optional[str], name: str,
                             version: int, digest: str) -> None:
        """Remember an applied token in the bounded dedup window
        (``MSBFS_MUTATE_DEDUP_WINDOW``, FIFO eviction; <= 0 disables).
        Caller holds ``_mutate_lock`` (or is the single-threaded replay
        before the verb gate opens)."""
        if not token or self._mutate_dedup_window <= 0:
            return
        self._mutate_tokens[token] = {
            "name": name, "version": int(version), "digest": digest,
        }
        while len(self._mutate_tokens) > self._mutate_dedup_window:
            self._mutate_tokens.pop(next(iter(self._mutate_tokens)))

    def _op_versions(self, request: dict) -> dict:
        """The graph's version chain: one row per delta version, digests
        chained from the base content hash (read-only; a client can
        diff its last-seen digest against the chain tail to learn
        whether anything changed)."""
        name = request.get("graph", "default")
        entry = self.registry.get(name)
        return {
            "ok": True,
            "op": "versions",
            "graph": name,
            "delta_version": entry.delta_version,
            "digest": entry.digest,
            "chain": entry.version_chain(),
        }

    def _parse_queries(self, request: dict) -> np.ndarray:
        """Wire queries (list of lists of ints) -> (K, s_pad) int32 array
        padded to the power-of-two group-width bucket."""
        raw = request.get("queries")
        if not isinstance(raw, list) or not raw:
            raise InputError("query needs 'queries': a non-empty list of "
                             "vertex-id lists")
        if len(raw) > MAX_WIRE_QUERIES:
            raise InputError(
                f"{len(raw)} query groups exceed the {MAX_WIRE_QUERIES} "
                "per-request bound"
            )
        widest = 0
        for i, group in enumerate(raw):
            if not isinstance(group, list) or not group:
                raise InputError(f"query group {i} must be a non-empty list")
            if len(group) > MAX_WIRE_GROUP:
                raise InputError(
                    f"query group {i} has {len(group)} sources, bound is "
                    f"{MAX_WIRE_GROUP}"
                )
            widest = max(widest, len(group))
        s_pad = pow2_pad(widest)
        rows = np.full((len(raw), s_pad), -1, dtype=np.int32)
        for i, group in enumerate(raw):
            try:
                rows[i, : len(group)] = np.asarray(group, dtype=np.int32)
            except (ValueError, OverflowError):
                raise InputError(
                    f"query group {i} has a non-int32 vertex id"
                ) from None
        return rows

    def _op_query(self, request: dict) -> dict:
        # One span covers the whole in-daemon serve path — cache lookup,
        # admission, the queue wait and the scatter — so the trace shows
        # where a query's latency went before the engine even ran.
        with span("serve.query", graph=request.get("graph", "default"),
                  pid=os.getpid()) as sp:
            return self._op_query_traced(request, sp)

    def _op_query_traced(self, request: dict, sp) -> dict:
        name = request.get("graph", "default")
        entry = self.registry.get(name)
        rows = self._parse_queries(request)
        s_pad = int(rows.shape[1])
        priority = request.get("priority", "interactive")
        if priority not in PRIORITIES:
            raise InputError(
                f"priority must be one of {PRIORITIES}, got {priority!r}"
            )
        client_id = request.get("client_id")
        if client_id is not None and not isinstance(client_id, str):
            raise InputError("client_id must be a string")
        weighted = request.get("weighted", False)
        if not isinstance(weighted, bool):
            raise InputError("weighted must be a boolean")
        if weighted and not getattr(entry.graph, "has_weights", False):
            # Fail at admission, before the queue: a weighted ask
            # against a weightless artifact can never be answered.
            raise InputError(
                f"weighted query against weightless graph {name!r}: the "
                "artifact carries no edge-cost section (regenerate with "
                "gen_cli --weights, or drop the weighted flag)"
            )
        with self._stats_lock:
            self._requests_total += 1
        # ``weighted`` is part of the answer's identity: the same rows
        # against the same graph yield different F under unit vs edge
        # costs, so the result cache must never alias the two.
        cache_key = (entry.key, rows.shape, rows.tobytes(), weighted)
        cached = self.result_cache.get(cache_key)
        if cached is not None:
            sp.set(cached=True)
            out = dict(cached)
            out["cached"] = True
            return out
        if self._posture_cache_only and priority == "batch":
            # Deepest brownout rung: batch traffic is answered only from
            # the result cache — a fresh batch query is shed typed
            # BEFORE touching the queue, keeping what headroom remains
            # for interactive work (docs/SERVING.md).
            with self._stats_lock:
                self._shed_brownout += 1
            record_flight("batch_shed", reason="brownout_cache_only",
                          graph=name, priority=priority)
            raise BackpressureError(
                "brownout: batch queries are served from the result "
                "cache only; retry later"
            )
        if entry.deltas is not None:
            # Dynamic-graph fast path: a retained plane certified at an
            # earlier delta version is repaired across the net delta on
            # the host — the affected cone only — instead of paying a
            # full device sweep.  None = no usable seed; fall through.
            repaired = self._try_repair(
                entry, name, rows, s_pad, cache_key, weighted
            )
            if repaired is not None:
                return repaired
        deadline = None
        raw_deadline = request.get("deadline_s")
        if raw_deadline is not None:
            try:
                deadline_s = float(raw_deadline)
            except (TypeError, ValueError):
                raise InputError(
                    f"deadline_s must be a number, got {raw_deadline!r}"
                ) from None
            if deadline_s <= 0:
                raise InputError("deadline_s must be positive")
            deadline = time.time() + deadline_s
        req = QueryRequest(
            graph_key=entry.key,
            graph_name=name,
            version=entry.version,
            rows=rows,
            s_pad=s_pad,
            submitted=time.time(),
            deadline=deadline,
            priority=priority,
            client_id=client_id,
            weighted=weighted,
            # The batcher consumer thread re-installs this context so
            # batch/supervisor/engine spans land on the query's trace.
            trace=telemetry.current_trace(),
        )
        sp.set(k=int(rows.shape[0]), s_pad=s_pad, priority=priority,
               weighted=weighted)
        self.batcher.submit(req)  # raises BackpressureError when full
        if not req.done.wait(self.request_timeout_s):
            with self._stats_lock:
                self._failed_requests += 1
            raise TransientError(
                f"request timed out after {self.request_timeout_s:g}s in "
                "the serving pipeline"
            )
        if req.error is not None:
            with self._stats_lock:
                self._failed_requests += 1
            raise req.error
        response = req.result
        self.result_cache.put(cache_key, response)
        self._maybe_retain_plane(entry, name, rows, weighted)
        out = dict(response)
        out["cached"] = False
        return out

    # ---- dynamic-graph repair path ----------------------------------------
    def _try_repair(
        self,
        entry: GraphEntry,
        name: str,
        rows: np.ndarray,
        s_pad: int,
        cache_key,
        weighted: bool = False,
    ) -> Optional[dict]:
        """Answer a query by repairing a cached distance plane across
        the delta span from its certified version to the live one.
        Returns the response dict, or None when there is no usable seed
        (plane cache miss, or a seed from a different content chain).
        The repair is exact — bit-identical to a cold recompute (BFS
        distance fields are unique; positive costs make the weighted
        field unique too) — and the cost model inside the repair
        routines already degrades to the full host sweep when the cone
        is too large, so the answer contract never depends on which
        path ran.  Weighted and unit-cost planes live under DISJOINT
        cache keys: the same rows seed different fields."""
        if self.planes.max_bytes <= 0:
            return None
        pkey = (name, rows.shape, rows.tobytes(), weighted)
        hit = self.planes.get(pkey)
        if hit is None:
            return None
        plane_version, plane_digest, plane = hit
        log = entry.deltas
        if (
            plane_version > entry.delta_version
            or log.digest(plane_version) != plane_digest
        ):
            # A seed whose chain position does not reproduce its
            # recorded digest belongs to some other content lineage
            # (a reload raced the cache): dead, drop it.
            self.planes.drop_where(lambda k: k == pkey)
            return None
        started = time.time()
        from ..dynamic.repair import repair_distances, repair_weighted_distances
        from ..ops.certify import (
            certify_distances,
            certify_weighted_distances,
            f_from_distances,
        )

        inserts, deletes = log.net_delta(plane_version, entry.delta_version)
        try:
            if weighted:
                dist, rstats = repair_weighted_distances(
                    entry.graph, rows, plane, inserts, deletes
                )
            else:
                dist, rstats = repair_distances(
                    entry.graph, rows, plane, inserts, deletes
                )
        except (MsbfsError, ValueError, MemoryError) as exc:
            print(
                f"msbfs serve: plane repair for {name!r} failed "
                f"({exc}); answering via full dispatch",
                file=sys.stderr,
            )
            return None
        audited = False
        if random.random() < float(entry.supervisor.audit_sample):
            # Same sampled-certification contract as the engine path's
            # output audit: the repaired plane must pass the full
            # (weighted, when asked weighted) certificate against the
            # live CSR.
            audited = True
            if weighted:
                failing = certify_weighted_distances(
                    entry.graph.row_offsets,
                    entry.graph.col_indices,
                    entry.graph.edge_weights,
                    rows,
                    dist,
                )
            else:
                failing = certify_distances(
                    entry.graph.row_offsets,
                    entry.graph.col_indices,
                    rows,
                    dist,
                )
            with self._stats_lock:
                self._repair_audited += 1
                if failing:
                    self._repair_audit_failures += 1
            if failing:
                self.planes.drop_where(lambda k: k == pkey)
                raise CorruptionError(
                    f"repaired plane for {name!r} flunked the output "
                    f"certificate ({', '.join(failing)}); seed dropped "
                    "— retry recomputes from scratch",
                    invariants=tuple(failing),
                )
        f_req = f_from_distances(dist)
        valid = f_req >= 0
        if valid.any():
            min_k = int(
                np.argmin(
                    np.where(valid, f_req, np.iinfo(np.int64).max)
                )
            )
            min_f = int(f_req[min_k])
        else:
            min_f, min_k = -1, -1
        self.planes.put(pkey, entry.delta_version, entry.digest, dist)
        latency_ms = (time.time() - started) * 1000.0
        with self._stats_lock:
            self._requests_repaired += 1
            if rstats.fallback:
                self._repair_fallbacks += 1
        response = {
            "ok": True,
            "op": "query",
            "graph": name,
            "version": entry.version,
            "f_values": [int(x) for x in f_req],
            "min_f": min_f,
            "min_k": min_k,
            "bucket": [int(rows.shape[0]), s_pad],
            "compiled": False,
            "batched_with": 0,
            "audited": audited,
            "weighted": weighted,
            "repaired": True,
            "dynamic": rstats.as_dict(),
            "latency_ms": round(latency_ms, 3),
        }
        self.result_cache.put(cache_key, response)
        out = dict(response)
        out["cached"] = False
        return out

    def _maybe_retain_plane(
        self,
        entry: GraphEntry,
        name: str,
        rows: np.ndarray,
        weighted: bool = False,
    ) -> None:
        """Repair-aware warm plane retention (``MSBFS_SERVE_PLANES``):
        after an engine answer, keep the query's host distance plane so
        the NEXT mutate can repair instead of recompute.  ``auto``
        retains only for graphs already carrying a delta chain; the
        host-side sweep runs on the connection thread, off the device
        path."""
        policy = self.plane_policy
        if policy == "0" or self.planes.max_bytes <= 0:
            return
        if policy == "auto" and entry.deltas is None:
            return
        pkey = (name, rows.shape, rows.tobytes(), weighted)
        have = self.planes.get(pkey)
        if (
            have is not None
            and have[0] == entry.delta_version
            and have[1] == entry.digest
        ):
            return  # seed already version-fresh
        from ..ops.certify import (
            reference_distances,
            reference_weighted_distances,
        )

        try:
            if weighted:
                dist = reference_weighted_distances(
                    entry.graph.row_offsets,
                    entry.graph.col_indices,
                    entry.graph.edge_weights,
                    rows,
                )
            else:
                dist = reference_distances(
                    entry.graph.row_offsets, entry.graph.col_indices, rows
                )
        except MemoryError:
            return  # retention is an optimization, never a failure
        self.planes.put(pkey, entry.delta_version, entry.digest, dist)
        with self._stats_lock:
            self._planes_retained += 1

    def _op_posture(self, request: dict) -> dict:
        """Brownout posture push (serve/brownout.py, docs/SERVING.md
        "Autoscaling & overload").  ``audit_sample``: a number in [0, 1]
        overrides every registered supervisor's output-audit rate
        (configured rates are stashed), ``"restore"`` puts the stashed
        rates back; ``cache_only``: bool flips the batch-traffic
        cache-only switch.  Control-plane: answered even while
        draining, so a recovering fleet can always step quality back
        up."""
        out_fields = {}
        if "audit_sample" in request:
            raw = request["audit_sample"]
            if raw == "restore":
                for gname, sample in self._audit_saved.items():
                    entry = self.registry.maybe_get(gname)
                    if entry is not None:
                        entry.supervisor.audit_sample = sample
                self._audit_saved = {}
                self._posture_audit = None
            else:
                try:
                    sample = float(raw)
                except (TypeError, ValueError):
                    raise InputError(
                        "posture audit_sample must be a number or "
                        f"'restore', got {raw!r}"
                    ) from None
                if not (0.0 <= sample <= 1.0):
                    raise InputError(
                        f"posture audit_sample must be in [0, 1], "
                        f"got {sample:g}"
                    )
                self._posture_audit = sample
                for gname in self.registry.describe():
                    entry = self.registry.maybe_get(gname)
                    if entry is not None:
                        self._audit_saved.setdefault(
                            gname, float(entry.supervisor.audit_sample)
                        )
                        entry.supervisor.audit_sample = sample
        if "cache_only" in request:
            self._posture_cache_only = bool(request["cache_only"])
        out_fields["audit_sample_override"] = self._posture_audit
        out_fields["cache_only"] = self._posture_cache_only
        if "audit_sample" in request or "cache_only" in request:
            record_flight("brownout_transition", **out_fields)
        return {"ok": True, "op": "posture", "posture": out_fields}

    # ---- execution (batcher consumer thread) ------------------------------
    def _shed_expired(
        self, requests: List[QueryRequest]
    ) -> List[QueryRequest]:
        """Fail requests whose client deadline has already passed before
        spending device time on them; returns the still-live remainder."""
        now = time.time()
        live: List[QueryRequest] = []
        for req in requests:
            if req.deadline is not None and now > req.deadline:
                with self._stats_lock:
                    self._shed_requests += 1
                record_flight("batch_shed", reason="deadline_expired",
                              graph=req.graph_name, priority=req.priority)
                req.error = TransientError(
                    "request deadline expired before dispatch "
                    "(client gave up); work shed"
                )
                req.done.set()
            else:
                live.append(req)
        return live

    def _dispatch_group(
        self,
        entry: GraphEntry,
        requests: List[QueryRequest],
        k_exec: int,
        s_pad: int,
    ):
        """Pack, warm-once, dispatch one group of requests under the
        supervisor.  Returns ``(f, offsets, compiled)``; raises on an
        exhausted recovery budget (the caller decides blanket-fail vs
        bisection).  First-time compiles journal their bucket so a
        restart re-warms it."""
        from ..parallel.scheduler import pack_padded_requests

        batch, offsets = pack_padded_requests(
            [r.rows for r in requests], k_exec, s_pad
        )
        weighted = requests[0].weighted  # coalescing never mixes modes
        supervisor = (
            entry.get_weighted_supervisor() if weighted else entry.supervisor
        )
        label = bucket_label(entry.key, k_exec, s_pad, weighted=weighted)

        def warm():
            with entry.engine_lock:
                supervisor.compile((k_exec, s_pad))

        compiled = self.executables.warm(
            (entry.key, k_exec, s_pad, weighted), label, warm
        )
        if compiled and self.journal is not None and not weighted:
            # Weighted warms are deliberately NOT journaled: the warm
            # record grammar is a 4-tuple shared with older journals,
            # and a restart that loses weighted warmth only re-pays a
            # compile, never an answer.
            try:
                self.journal.append(
                    {"op": "warm", "name": entry.name, "hash": entry.hash,
                     "k_exec": k_exec, "s_pad": s_pad}
                )
            except StorageError as exc:
                # A warm record is a restart-warmth HINT, not a promise:
                # a full disk must not fail the admitted batch riding
                # this compile.  Health already degrades via the
                # journal's latched writable flag; the durable verbs
                # (load/reload/mutate) still fail typed.
                print(
                    f"msbfs serve: warm hint not journaled: {exc}",
                    file=sys.stderr,
                )
        with entry.engine_lock:
            out = supervisor.f_values(batch)
        # One read-back of the whole coalesced batch's F.
        f = torch.as_tensor(out).cpu().numpy().astype(np.int64)
        # MSBFS_AUDIT: the supervisor just audited (or sampled past)
        # this dispatch; carry the verdict to the per-request responses.
        return f, offsets, compiled, bool(supervisor.last_audited)

    def _execute_batch(
        self, requests: List[QueryRequest], k_exec: int, s_pad: int
    ) -> None:
        """Run one coalesced bucket: shed expired work, dispatch
        supervised, scatter per-request results.  A failed
        *multi-request* batch is bisected (:meth:`_quarantine`) so one
        poisoned query cannot take its batchmates down with it; a failed
        singleton keeps its classified error — there is nothing left to
        isolate."""
        self._bind_device()
        entry = self.registry.maybe_get(requests[0].graph_name)
        if entry is None or entry.key != requests[0].graph_key:
            # Graph was reloaded after admission: the old engine may
            # already be released — fail typed, client retries against
            # the new version.
            err = TransientError(
                f"graph {requests[0].graph_name!r} was reloaded while "
                "the request was queued; retry"
            )
            for req in requests:
                req.error = err
                req.done.set()
            return
        requests = self._shed_expired(requests)
        if not requests:
            return
        # A coalesced batch is one device dispatch serving several
        # queries: its batch/supervisor/engine spans land on the FIRST
        # traced request's trace (documented in docs/OBSERVABILITY.md —
        # batchmates see the work attributed once, not duplicated).
        ctx = next((r.trace for r in requests if r.trace is not None), None)
        if ctx is None:
            self._execute_admitted(entry, requests, s_pad)
            return
        with use_trace(ctx):
            with span("batch.execute", graph=requests[0].graph_name,
                      coalesced=len(requests)):
                self._execute_admitted(entry, requests, s_pad)

    def _execute_admitted(
        self, entry: GraphEntry, requests: List[QueryRequest], s_pad: int
    ) -> None:
        k_exec = pow2_pad(sum(r.k for r in requests))
        try:
            f, offsets, compiled, audited = self._dispatch_group(
                entry, requests, k_exec, s_pad
            )
        except Exception as exc:  # noqa: BLE001 — typed per-request failure
            err = classify(exc)
            self._note_recovery(entry)
            if len(requests) > 1:
                self._quarantine(entry, requests, s_pad, err)
                return
            # _op_query counts the failure when it re-raises req.error —
            # counting here too would double-book every failed request.
            for req in requests:
                req.error = err
                req.done.set()
            return
        self._note_recovery(entry)
        self._finish_batch(
            requests, f, offsets, compiled, k_exec, s_pad, audited
        )

    def _quarantine(
        self,
        entry: GraphEntry,
        requests: List[QueryRequest],
        s_pad: int,
        batch_err: MsbfsError,
    ) -> None:
        """Bisect a failed multi-request batch to isolate the poison.

        Each half re-dispatches under the same supervisor (retries and
        all); halves that succeed answer normally — bit-identical to a
        clean run, since the dispatch math is deterministic for a given
        (k_exec, s_pad) bucket and row content.  A half that fails keeps
        splitting; a *singleton* that fails is the poison and gets the
        typed :class:`PoisonQueryError` (exit 8).  Cost: O(log K) extra
        dispatches per poisoned row, paid only on the failure path.
        """
        mid = len(requests) // 2
        for group in (requests[:mid], requests[mid:]):
            if not group:
                continue
            group = self._shed_expired(group)
            if not group:
                continue
            k_exec = pow2_pad(sum(r.k for r in group))
            try:
                f, offsets, compiled, audited = self._dispatch_group(
                    entry, group, k_exec, s_pad
                )
            except Exception as exc:  # noqa: BLE001 — keep bisecting
                err = classify(exc)
                self._note_recovery(entry)
                if len(group) == 1:
                    req = group[0]
                    with self._stats_lock:
                        self._quarantined_requests += 1
                    record_flight("quarantine", graph=req.graph_name,
                                  error=str(err))
                    req.error = PoisonQueryError(
                        "query quarantined: its batch failed and "
                        f"bisection isolated this request ({err})"
                    )
                    req.done.set()
                else:
                    self._quarantine(entry, group, s_pad, err)
                continue
            self._note_recovery(entry)
            self._finish_batch(
                group, f, offsets, compiled, k_exec, s_pad, audited
            )

    def _finish_batch(
        self,
        requests: List[QueryRequest],
        f: np.ndarray,
        offsets,
        compiled: bool,
        k_exec: int,
        s_pad: int,
        audited: bool = False,
    ) -> None:
        """Scatter one successful dispatch back to its requests."""
        label = bucket_label(
            requests[0].graph_key, k_exec, s_pad,
            weighted=requests[0].weighted,
        )
        now = time.time()
        with self._stats_lock:
            stats = self._buckets.setdefault(label, _BucketStats())
            stats.batches += 1
            stats.rows += k_exec
            self._last_batch_ts = now
        for req, lo in zip(requests, offsets):
            f_req = f[lo : lo + req.k]
            # Reference selection semantics (ops/objective.select_best):
            # valid entries are F >= 0, ties break to the lowest index,
            # none valid -> (-1, -1).
            valid = f_req >= 0
            if valid.any():
                min_k = int(np.argmin(np.where(valid, f_req, np.iinfo(np.int64).max)))
                min_f = int(f_req[min_k])
            else:
                min_f, min_k = -1, -1
            latency_ms = (now - req.submitted) * 1000.0
            with self._stats_lock:
                stats.record(latency_ms)
            req.result = {
                "ok": True,
                "op": "query",
                "graph": req.graph_name,
                "version": req.version,
                "f_values": [int(x) for x in f_req],
                "min_f": min_f,
                "min_k": min_k,
                "bucket": [k_exec, s_pad],
                "compiled": bool(compiled),
                "batched_with": len(requests) - 1,
                "audited": bool(audited),
                "weighted": bool(req.weighted),
                "latency_ms": round(latency_ms, 3),
            }
            req.done.set()

    def _note_recovery(self, entry: Optional[GraphEntry]) -> None:
        """Drain the supervisor's recovery log into server stats
        (bounded — each event reported once, docs/RESILIENCE.md)."""
        if entry is None:
            return
        events = entry.supervisor.drain_events()
        if events:
            with self._stats_lock:
                self._recovery_events.extend(events)
                del self._recovery_events[:-_BucketStats.MAX_SAMPLES]

    # ---- stats ------------------------------------------------------------
    def stats(self) -> dict:
        with self._stats_lock:
            buckets = {k: v.snapshot() for k, v in self._buckets.items()}
            recovery = list(self._recovery_events)
            failed = self._failed_requests
            total = self._requests_total
            shard_steps = self._shard_steps
            shed = self._shed_requests
            shed_brownout = self._shed_brownout
            quarantined = self._quarantined_requests
            refused = dict(self._refused_graphs)
            dynamic = {
                "mutations": self._mutations,
                "mutations_deduplicated": self._mutations_deduplicated,
                "dedup_window": {
                    "capacity": self._mutate_dedup_window,
                    "tokens": len(self._mutate_tokens),
                },
                "requests_repaired": self._requests_repaired,
                "repair_fallbacks": self._repair_fallbacks,
                "planes_retained": self._planes_retained,
                "repair_audited": self._repair_audited,
                "repair_audit_failures": self._repair_audit_failures,
            }
        dynamic["planes"] = self.planes.snapshot()
        audited = 0
        audit_failures = 0
        for entry in self.registry.describe():
            sup = self.registry.maybe_get(entry)
            if sup is not None:
                audited += int(sup.supervisor.audited_total)
                audit_failures += int(sup.supervisor.audit_failures_total)
        return {
            "uptime_s": round(time.time() - self.started, 3),
            "pid": os.getpid(),
            "version": _pkg_version(),
            "ready": self._ready.is_set(),
            "draining": self._draining,
            "journal": self.journal.path if self.journal else None,
            "journal_bytes": self.journal.bytes() if self.journal else 0,
            "journal_compactions": (
                self.journal.compactions if self.journal else 0
            ),
            "graphs": self.registry.describe(),
            "queue": {
                "depth": self.batcher.depth(),
                "capacity": self.batcher.capacity,
                "oldest_age_s": round(self.batcher.oldest_age(), 6),
                "rejected": self.batcher.rejected,
                "rejected_batch": self.batcher.rejected_batch,
                "rejected_client": self.batcher.rejected_client,
                "shed_overload": self.batcher.shed_overload,
                "batches": self.batcher.batches,
                "coalesced": self.batcher.coalesced,
            },
            "posture": {
                "audit_sample_override": self._posture_audit,
                "cache_only": self._posture_cache_only,
                "shed_brownout": shed_brownout,
            },
            "result_cache": self.result_cache.snapshot(),
            "dynamic": dynamic,
            "compiles": self.executables.compiles(),
            "compiles_total": self.executables.total_compiles(),
            "buckets": buckets,
            "requests_total": total,
            "requests_failed": failed,
            "shard_steps": shard_steps,
            "requests_shed": shed,
            "requests_quarantined": quarantined,
            "fleet_epoch": self._current_epoch(),
            "fenced_requests": self._fenced_requests,
            "audited": audited,
            "audit_failures": audit_failures,
            "refused_graphs": refused,
            "recovery_events": recovery,
        }


def serve_main(argv: Optional[List[str]] = None, device=None,
               native: bool = True) -> int:
    """The ``serve`` subcommand's entry point: the daemon on ``--device``,
    else ``device``, else the card (``cpu`` for tests).  Asked for the card
    where there is none, it raises and serves nothing."""
    import argparse

    ap = argparse.ArgumentParser(
        prog="msbfs-tpu serve",
        description="Persistent multi-source-BFS query daemon "
        "(docs/SERVING.md)",
    )
    ap.add_argument(
        "--listen",
        default=knobs.raw("MSBFS_SERVE_LISTEN", "unix:/tmp/msbfs.sock"),
        help="unix:<path> or <host>:<port> (default unix:/tmp/msbfs.sock)",
    )
    ap.add_argument(
        "-g",
        "--graph",
        action="append",
        default=[],
        metavar="[NAME=]PATH",
        help="register a graph at startup (repeatable; bare PATH registers "
        "as 'default')",
    )
    ap.add_argument(
        "--queue", type=int, default=None,
        help="admission queue capacity (default MSBFS_SERVE_QUEUE or 64)",
    )
    ap.add_argument(
        "--window-ms", type=float, default=None,
        help="micro-batch coalescing window in ms (default "
        "MSBFS_SERVE_WINDOW*1000 or 2)",
    )
    ap.add_argument(
        "--result-cache", type=int, default=None,
        help="LRU result-cache capacity, 0 disables (default "
        "MSBFS_SERVE_RESULT_CACHE or 1024)",
    )
    ap.add_argument(
        "--journal", default=None, metavar="PATH",
        help="append-only state journal; restart replays it to restore "
        "registered graphs and re-warm buckets (default "
        "MSBFS_SERVE_JOURNAL or no journal)",
    )
    ap.add_argument(
        "--drain-s", type=float, default=None,
        help="graceful-drain deadline on SIGTERM/SIGINT in seconds "
        "(default MSBFS_SERVE_DRAIN or 10)",
    )
    ap.add_argument(
        "--epoch-file", default=None, metavar="PATH",
        help="fleet-membership epoch file (written by the fleet "
        "supervisor); frames carrying a different epoch are refused "
        "with FencedError (exit 10, docs/SERVING.md)",
    )
    ap.add_argument(
        "--device", default=None,
        help="the engines' torch device (default cuda; cpu runs the "
        "kernels' plain versions, for tests); without a card, cuda "
        "exits 1",
    )
    args = ap.parse_args(argv)
    from ..cli import resolve_device

    # No card where one is asked for: raise before anything binds (the
    # process exits 1; a fleet shows the replica down, then failed).
    want = args.device if args.device is not None else device
    device = resolve_device(want)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"no CUDA device for --device {want}: the daemon runs on the "
            "card (--device cpu runs the plain versions, for tests)"
        )
    claim = None
    if device.type == "cuda":
        # Take the card before serving: its context and one block of the
        # caching allocator, held for the daemon's life, so that a card it
        # cannot take fails the boot rather than the first load, and a
        # replica that answers ready holds memory on the card.
        torch.cuda.set_device(device)
        claim = torch.zeros(1, device=device)
    graphs: Dict[str, str] = {}
    for spec in args.graph:
        name, sep, path = spec.partition("=")
        if not sep:
            name, path = "default", spec
        graphs[name] = path
    try:
        server = MsbfsServer(
            listen=args.listen,
            graphs=graphs,
            queue_capacity=args.queue,
            window_s=None if args.window_ms is None else args.window_ms / 1000.0,
            result_cache_size=args.result_cache,
            journal_path=args.journal,
            drain_deadline_s=args.drain_s,
            epoch_path=args.epoch_file,
            device=device,
            native=native,
        )
        server.start()
    except MsbfsError as err:
        from ..utils.report import format_failure

        dump_flight(f"exit_{err.exit_code}")
        print(format_failure(err), file=sys.stderr)
        return err.exit_code
    except ValueError as exc:
        print(f"msbfs serve: {exc}", file=sys.stderr)
        return 1
    lifecycle.install_signal_handlers(server)
    names = ", ".join(sorted(graphs)) or "none (use the load verb)"
    log_line(
        f"msbfs serve: listening on {args.listen}; graphs: {names}; "
        f"journal: {server.journal.path if server.journal else 'off'}",
        event="serve_start", listen=args.listen,
        graphs=sorted(graphs), pid=os.getpid(),
    )
    try:
        reason = server.wait()
    except KeyboardInterrupt:
        # Belt-and-braces: the SIGINT handler normally converts this
        # into a drain request before the exception can surface.
        reason = "drain"
    if reason == "drain" and not server.stopping:
        server.drain()
        log_line("msbfs serve: drained; exiting", event="serve_drained")
    del claim
    return 0

"""Front-end router: ring-placed forwarding, failover, hedging, shed.

The port's copy of the JAX package's serve/router.py: the same walk,
counters and frames, over replicas that are the port's own daemons
(:mod:`.fleet`).  ``fleet_main`` takes the replicas' device (``--device``,
``cuda`` unless asked for the CPU), and a sharded query's answer carries
one port-only field, ``largest_fragment_ids`` (the most vertex ids one
fragment frame carried each way, to hold the frames against the wire's
bound).

The fleet's query path (docs/SERVING.md "Fleet"): a query for graph
``g`` goes to the first live ring owner of ``g``'s content digest; on a
connection error, an injected ``net_drop``, or a replica answering with
the transport-wrapped ``TransientError``, the router *fails over* to
the next ring member — same preference walk on every node, so there is
nothing to coordinate.  Stragglers are hedged through the existing
client hedge path (a second connection races the first; results are
deterministic, so either answer is THE answer).  Saturation is not
failure-masked: a replica answering ``BackpressureError`` is counted
and skipped, and only when EVERY live owner is saturated does the
router shed the query with the same typed ``BackpressureError`` — the
fleet-level admission contract (exit 7, docs/RESILIENCE.md).

Deterministic failure taxonomy is preserved through failover: an
``InputError`` or ``PoisonQueryError`` from a replica is the *query's*
fault and re-raising it from another replica would give the same
answer, so those propagate immediately without burning failover
attempts.

Chaos seam: every forwarding attempt to replica ``i`` trips fault site
``route<i>`` — ``net_drop`` kills the attempt before any bytes move
(failover rehearsal), ``replica_slow`` stalls it (hedge rehearsal),
``wire_corrupt`` taints the next frame sent on the attempt's thread
(crc rehearsal: the replica's checksum rejects it, the failover walk
recovers).

Cross-replica voting (docs/RESILIENCE.md "Silent data corruption"): a
sampled fraction of answered queries (``MSBFS_VOTE`` / ``vote_rate``)
is shadow-routed to the NEXT live ring owner and the two answers'
:func:`~..ops.certify.fold_digest` fingerprints are compared.  The
graphs and query batches are identical and every engine is
deterministic, so the digests must agree; a mismatch means one replica
served a silently corrupt answer.  The router then recomputes on a
third owner to form a majority, quarantines the outvoted replica via
``quarantine_fn`` (the fleet supervisor's kill-and-let-heartbeat-heal
path), and returns the majority answer.  With no third opinion
available the vote is counted ``vote_unresolved``, the shadow replica
is quarantined (the ring-preferred primary is the better bet), and the
primary's answer stands.
"""

from __future__ import annotations

import os
import queue
import re
import secrets
import socket
import sys
import tempfile
import threading
import time
from typing import Dict, List, Optional, Sequence, Set

import numpy as np

from ..ops.certify import fold_digest
from ..runtime.supervisor import (
    BackpressureError,
    FencedError,
    InputError,
    MsbfsError,
    RetryPolicy,
    ShardUnavailableError,
    TransientError,
)
from ..utils import faults, knobs
from ..utils.telemetry import (
    Histogram,
    TraceContext,
    instant,
    log_line,
    record_flight,
    span,
    use_trace,
)
from . import observe, protocol
from .client import MsbfsClient, ServerError
from .ring import PlacementRing
from .shards import ShardPlan, or_merge_fragments, scatter_frontier


def vote_rate_from_env() -> float:
    """``MSBFS_VOTE`` -> [0, 1] shadow-vote sampling rate.  Same parse
    convention as the server's ``MSBFS_AUDIT``: ``off``/``0``/unset
    disable, ``full``/``on``/``1`` vote every query, a float samples;
    malformed values fall back to off (the repo-wide knob convention).
    """
    raw = knobs.raw("MSBFS_VOTE", "").strip().lower()
    if raw in ("", "off", "0"):
        return 0.0
    if raw in ("full", "on", "1"):
        return 1.0
    try:
        rate = float(raw)
    except ValueError:
        return 0.0
    return min(max(rate, 0.0), 1.0)


def _answer_digest(out: dict) -> int:
    """Fingerprint of the answer-bearing response fields.  Routing
    metadata (latency, bucket, replica) legitimately differs between
    replicas and is excluded; F values and the argmin selection must be
    bit-identical — the engines are deterministic functions of (graph
    digest, query batch)."""
    f = np.asarray(out.get("f_values", []), dtype=np.int64)
    best = np.asarray(
        [out.get("min_f", -1), out.get("min_k", -1),
         1 if out.get("weighted") else 0],
        dtype=np.int64,
    )
    return fold_digest(f, best)


class FleetRouter:
    """Stateless-per-query forwarding over a placement ring.

    ``addresses`` maps ring member name -> daemon address; ``digests``
    maps graph name -> content digest (the ring key); ``alive_fn``
    returns the currently-ready member set (None routes over full
    membership — static placement).  Each attempt uses a fresh
    connection with NO client-side reconnect retries: the ring walk IS
    the retry loop, and lockstep reconnect storms are the failure mode
    the fleet exists to avoid.
    """

    def __init__(
        self,
        ring: PlacementRing,
        addresses: Dict[str, str],
        digests: Dict[str, str],
        alive_fn=None,
        timeout: float = 300.0,
        hedge_after_s: Optional[float] = None,
        vote_rate: Optional[float] = None,
        quarantine_fn=None,
        brownout_fn=None,
        shard_plans: Optional[Dict[str, ShardPlan]] = None,
        shard_ring: Optional[PlacementRing] = None,
    ):
        missing = [m for m in ring.members if m not in addresses]
        if missing:
            raise ValueError(f"ring members without addresses: {missing}")
        self.ring = ring
        self.addresses = dict(addresses)
        self.digests = dict(digests)
        self.alive_fn = alive_fn
        self.timeout = float(timeout)
        self.hedge_after_s = hedge_after_s
        self.vote_rate = (
            vote_rate_from_env() if vote_rate is None
            else min(max(float(vote_rate), 0.0), 1.0)
        )
        self.quarantine_fn = quarantine_fn
        # Brownout hook (docs/SERVING.md "Autoscaling & overload"): a
        # callable answering "suppress voting right now?".  Rung 1 of
        # the ladder turns the vote's shadow traffic off router-side.
        self.brownout_fn = brownout_fn
        # Sharded graphs (serve/shards.py): parent name -> ShardPlan and
        # the shard-replication ring.  A fleet router shares the
        # supervisor's live tables (for_fleet below); both empty means
        # every graph routes whole — the scatter path never engages.
        self.shard_plans: Dict[str, ShardPlan] = (
            shard_plans if shard_plans is not None else {}
        )
        self.shard_ring = shard_ring
        self.shard_fragment_timeout_s = knobs.get_float(
            "MSBFS_SHARD_FRAGMENT_TIMEOUT_S", 30.0
        )
        self.shard_hedge_ms = knobs.get_float("MSBFS_SHARD_HEDGE_MS", 0.0)
        self._vote_acc = 0.0
        self._index = {m: i for i, m in enumerate(ring.members)}
        self._lock = threading.Lock()
        self._stats = {
            "routed": 0,
            "failovers": 0,
            "net_drops": 0,
            "fenced": 0,
            "mutations_routed": 0,
            "hedged": 0,
            "shed": 0,
            "votes": 0,
            "votes_suppressed": 0,
            "vote_mismatches": 0,
            "vote_unresolved": 0,
            "quarantined": 0,
            "scatter_queries": 0,
            "scatter_rounds": 0,
            "scatter_fragments": 0,
            "scatter_retries": 0,
            "scatter_degraded": 0,
            "scatter_shard_lost": 0,
            "per_replica": {m: 0 for m in ring.members},
        }

    @classmethod
    def for_fleet(cls, supervisor, **kw) -> "FleetRouter":
        """Router over a live :class:`~.fleet.FleetSupervisor`: shares
        its digest table (registrations made after construction are
        visible), routes only to ready replicas, and wires vote
        quarantine to the supervisor's kill-and-heal path (duck-typed
        like every other read here — a supervisor without one simply
        gets voting without quarantine)."""
        kw.setdefault(
            "quarantine_fn", getattr(supervisor, "quarantine", None)
        )
        ladder = getattr(supervisor, "brownout", None)
        if ladder is not None:
            kw.setdefault("brownout_fn", ladder.vote_suppressed)
        router = cls(
            ring=supervisor.ring,
            addresses={r.name: r.address for r in supervisor.replicas},
            digests=supervisor.digests,
            alive_fn=supervisor.ready_names,
            **kw,
        )
        # The constructor snapshots its digests and addresses (static
        # placement); a fleet router must instead share the supervisor's
        # live tables so graphs registered after construction route
        # immediately (the `msbfs fleet` boot order is router first,
        # -g registrations second) and replicas added or removed by the
        # autoscaler are routable the moment the ring knows them.
        router.digests = supervisor.digests
        addresses = getattr(supervisor, "addresses", None)
        if addresses is not None:
            router.addresses = addresses
        # Same live-share for shard topology: a graph sharded after
        # construction scatters immediately, and the shard ring tracks
        # elastic membership through the supervisor's mirroring.
        plans = getattr(supervisor, "shard_plans", None)
        if plans is not None:
            router.shard_plans = plans
        sring = getattr(supervisor, "shard_ring", None)
        if sring is not None:
            router.shard_ring = sring
        return router

    def _bump(self, key: str, member: Optional[str] = None) -> None:
        with self._lock:
            self._stats[key] += 1
            if member is not None:
                per = self._stats["per_replica"]
                per[member] = per.get(member, 0) + 1

    _SLOT_RE = re.compile(r"r(\d+)\Z")

    def _route_index(self, member: str) -> int:
        """Chaos-site index for a member.  Supervisor slot names encode
        their index (``r<i>`` -> ``route<i>``), which keeps fault sites
        stable across elastic membership churn; anything else gets the
        next free index on first sight."""
        with self._lock:
            i = self._index.get(member)
            if i is None:
                m = self._SLOT_RE.match(member)
                i = int(m.group(1)) if m else len(self._index)
                self._index[member] = i
                self._stats["per_replica"].setdefault(member, 0)
            return i

    def _epoch(self) -> Optional[int]:
        """The membership epoch every routed frame is stamped with
        (docs/SERVING.md "Cross-machine transport & fencing").  Rings
        predating the epoch field stamp nothing — tolerated-absent."""
        epoch = getattr(self.ring, "epoch", None)
        return None if epoch is None else int(epoch)

    # ---- query path -------------------------------------------------------
    def owners_for(self, graph: str) -> List[str]:
        digest = self.digests.get(graph)
        if digest is None:
            raise InputError(
                f"no graph registered as {graph!r} in the fleet "
                f"(have: {', '.join(sorted(self.digests)) or 'none'})"
            )
        alive = self.alive_fn() if self.alive_fn is not None else None
        return self.ring.owners(digest, alive=alive)

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
        """Forward one query batch; returns the replica's response dict
        plus routing metadata (``replica``, ``failovers``).  The
        admission-control fields (``priority``, ``client_id``) and the
        ``weighted`` answer mode ride through unchanged — shedding
        decisions belong to the replica's batcher, not the router.

        A graph with a shard plan takes the scatter/gather path instead
        (docs/SERVING.md "Sharded graphs"); ``degraded`` is the client's
        opt-in to a *partial* answer when every copy of some shard is
        gone — without it, total shard loss is the typed
        :class:`~..runtime.supervisor.ShardUnavailableError` (exit 11),
        never a silently wrong F."""
        plan = self.shard_plans.get(graph)
        if plan is not None:
            with span("route.scatter", graph=graph) as sp:
                if weighted:
                    raise InputError(
                        f"graph {graph!r} is served sharded; weighted "
                        "distance-to-set is whole-graph only (raise "
                        "MSBFS_SHARD_MAX_BYTES to serve it whole)"
                    )
                out = self._scatter_query(
                    graph,
                    plan,
                    queries,
                    deadline_s=deadline_s,
                    degraded=degraded,
                )
                sp.set(
                    rounds=int(out.get("rounds", 0)),
                    degraded=bool(out.get("degraded")),
                )
                return out
        with span("route.query", graph=graph) as sp:
            out = self._query_walk(
                queries,
                graph=graph,
                deadline_s=deadline_s,
                hedge_after_s=hedge_after_s,
                priority=priority,
                client_id=client_id,
                weighted=weighted,
            )
            sp.set(
                replica=out.get("replica", ""),
                failovers=int(out.get("failovers", 0)),
                voted=bool(out.get("voted")),
            )
            return out

    def _query_walk(
        self,
        queries: Sequence[Sequence[int]],
        graph: str = "default",
        deadline_s: Optional[float] = None,
        hedge_after_s: Optional[float] = None,
        priority: Optional[str] = None,
        client_id: Optional[str] = None,
        weighted: bool = False,
    ) -> dict:
        owners = self.owners_for(graph)
        if not owners:
            raise TransientError(
                f"no live owner for graph {graph!r} "
                "(fleet booting or all owners down)"
            )
        if hedge_after_s is None:
            hedge_after_s = self.hedge_after_s
        start = time.monotonic()
        saturated = 0
        last_err: Optional[Exception] = None
        failovers = 0
        for member in owners:
            remaining = None
            if deadline_s is not None:
                remaining = deadline_s - (time.monotonic() - start)
                if remaining <= 0:
                    break  # out of budget: report shed/transient below
            try:
                faults.trip(f"route{self._route_index(member)}")
            except faults.SimulatedNetDrop as drop:
                self._bump("net_drops")
                failovers += 1
                last_err = drop
                continue
            address = self.addresses.get(member)
            if address is None:
                # Membership race: the member left (scale-down drain)
                # between the owners snapshot and this attempt.
                failovers += 1
                last_err = KeyError(member)
                continue
            try:
                with span(
                    "route.attempt", member=member, failover=failovers
                ), MsbfsClient(
                    address,
                    timeout=(
                        self.timeout if remaining is None
                        else min(self.timeout, remaining)
                    ),
                    retry=_NO_RETRY,
                    epoch=self._epoch(),
                ) as client:
                    out = client.query(
                        queries,
                        graph=graph,
                        deadline_s=remaining,
                        hedge_after_s=hedge_after_s,
                        priority=priority,
                        client_id=client_id,
                        weighted=weighted,
                    )
            except (faults.SimulatedNetDrop, faults.SimulatedHalfOpen) as nd:
                # Frame-level chaos fired at the protocol seam — a
                # partition cut dropped the frame mid-send, or a
                # half-open peer swallowed it and the read timed out.
                # Same failover semantics as the pre-wire drop above:
                # the replica never (usably) saw the query.
                self._bump("net_drops")
                failovers += 1
                last_err = nd
                continue
            except ServerError as err:
                if err.type_name == "BackpressureError":
                    saturated += 1
                    failovers += 1
                    last_err = err
                    continue
                if err.type_name == "TransientError":
                    # Transport loss, drain refusal, injected transient:
                    # the next owner holds the same graph — walk on.
                    failovers += 1
                    last_err = err
                    continue
                if err.type_name == "FencedError":
                    # The replica's membership view and ours disagree —
                    # usually a topology change mid-walk.  Count it and
                    # walk on: the next attempt re-reads the live ring
                    # epoch, so a healed view converges within the walk.
                    self._bump("fenced")
                    failovers += 1
                    last_err = err
                    continue
                raise  # deterministic failures belong to the query
            except (protocol.ProtocolError, OSError, socket.timeout) as exc:
                failovers += 1
                last_err = exc
                continue
            self._bump("routed", member)
            if failovers:
                with self._lock:
                    self._stats["failovers"] += failovers
            if out.get("hedged"):
                self._bump("hedged")
            out = dict(out)
            out["replica"] = member
            out["failovers"] = failovers
            if self._vote_due():
                if self._vote_suppressed():
                    # Brownout rung >= 1: the sample was due but the
                    # ladder says capacity beats redundancy right now.
                    self._bump("votes_suppressed")
                else:
                    deadline = (
                        None if deadline_s is None else start + deadline_s
                    )
                    out = self._vote(member, owners, queries, graph,
                                     deadline, out, weighted=weighted)
            return out
        if saturated and saturated >= failovers:
            # Every owner we reached said "queue full": the fleet is
            # saturated, and masking that as a retryable transient would
            # invite the retry storm backpressure exists to stop.
            self._bump("shed")
            raise BackpressureError(
                f"all {saturated} live owner(s) of graph {graph!r} are "
                "saturated; retry with backoff or grow the fleet"
            )
        raise TransientError(
            f"no owner of graph {graph!r} answered "
            f"({failovers} attempt(s); last: {last_err})"
        )

    # ---- sharded scatter/gather (docs/SERVING.md "Sharded graphs") --------
    def _scatter_query(
        self,
        graph: str,
        plan: ShardPlan,
        queries: Sequence[Sequence[int]],
        deadline_s: Optional[float] = None,
        degraded: bool = False,
    ) -> dict:
        """Level-synchronous distance-to-set over the shard fleet: each
        BFS round splits the frontier by owning shard
        (:func:`~.shards.scatter_frontier`), fans the fragments to their
        ring owners concurrently, and OR-merges the returned neighbor
        sets — the :class:`~..parallel.partition2d.Partition2D`
        row-gather/OR-merge discipline rebuilt over the wire.  Distances
        and the F objective are computed router-side exactly as the
        single daemon's engine computes them (sum of reached distances,
        lowest-index argmin tie-break), so the merged answer is
        bit-identical to the whole-graph oracle.

        A fragment whose every copy is gone raises the typed
        :class:`ShardUnavailableError` — unless the client opted into
        ``degraded``, in which case the shard is dropped for the REST of
        the query (its rows never expand), and the answer carries
        ``degraded: true`` plus ``missing_shards``: explicitly partial,
        never silently wrong."""
        if self.shard_ring is None:
            raise InputError(
                f"graph {graph!r} has a shard plan but this router has "
                "no shard ring; route through the fleet front end"
            )
        # Validation mirrors the daemon's _parse_queries bound for bound
        # so a malformed batch gets the SAME typed verdict whether the
        # graph happens to be sharded or whole.
        if not isinstance(queries, (list, tuple)) or not len(queries):
            raise InputError(
                "query needs 'queries': a non-empty list of vertex-id "
                "lists"
            )
        k = len(queries)
        n = plan.n
        start = time.monotonic()
        deadline = None if deadline_s is None else start + float(deadline_s)
        dist = np.full((k, n), -1, dtype=np.int64)
        frontier: List[np.ndarray] = []
        for qi, group in enumerate(queries):
            if not isinstance(group, (list, tuple)) or not len(group):
                raise InputError(
                    f"query group {qi} must be a non-empty list"
                )
            try:
                verts = np.unique(np.asarray(list(group), dtype=np.int64))
            except (TypeError, ValueError, OverflowError) as exc:
                raise InputError(
                    f"query group {qi}: source ids must be integers "
                    f"({exc})"
                ) from None
            if verts.min() < 0 or verts.max() >= n:
                raise InputError(
                    f"query group {qi}: source ids must be in [0, {n})"
                )
            dist[qi, verts] = 0
            frontier.append(verts)
        self._bump("scatter_queries")
        missing: Dict[int, str] = {}  # shard index -> name (degraded)
        rounds = 0
        fragments = 0
        largest = {"sent": 0, "received": 0}
        while any(f.size for f in frontier):
            fan = {
                si: rows
                for si, rows in scatter_frontier(plan, frontier).items()
                if si not in missing
            }
            if not fan:
                break  # every live frontier row belongs to a lost shard
            results: "queue.Queue" = queue.Queue()

            def run(si: int, rows: List[List[int]], rq=results) -> None:
                try:
                    rq.put((si, "ok", self._fragment_call(
                        plan.shards[si], rows, deadline
                    )))
                except MsbfsError as err:
                    rq.put((si, "err", err))
                except Exception as err:  # noqa: BLE001 — typed or bust
                    rq.put((si, "err", MsbfsError(str(err))))

            for si, rows in sorted(fan.items()):
                threading.Thread(
                    target=run,
                    args=(si, rows),
                    name="msbfs-fleet-scatter",
                    daemon=True,
                ).start()
            outs: List[List[List[int]]] = []
            for _ in range(len(fan)):
                si, kind, payload = results.get()
                if kind == "ok":
                    outs.append(payload)
                    continue
                if isinstance(payload, ShardUnavailableError) and degraded:
                    missing[si] = plan.shards[si].name
                    self._bump("scatter_shard_lost")
                    continue
                raise payload
            fragments += len(fan)
            for rows in fan.values():
                largest["sent"] = max(largest["sent"], sum(map(len, rows)))
            for out in outs:
                largest["received"] = max(largest["received"], sum(map(len, out)))
            nxt: List[np.ndarray] = []
            for qi, cand in enumerate(or_merge_fragments(n, outs, k)):
                new = cand[dist[qi, cand] < 0] if cand.size else cand
                if new.size:
                    dist[qi, new] = rounds + 1
                nxt.append(new)
            frontier = nxt
            rounds += 1
            self._bump("scatter_rounds")
        # F and selection mirror the engine and the daemon's
        # _finish_batch exactly: f = sum of distances over REACHED
        # vertices (ops/objective.py f_of_u), argmin with the
        # lowest-index tie-break, (-1, -1) for an empty batch.
        f_vals = np.where(dist >= 0, dist, 0).sum(axis=1).astype(np.int64)
        if k:
            keyed = np.where(
                f_vals >= 0, f_vals, np.iinfo(np.int64).max
            )
            min_k = int(np.argmin(keyed))
            min_f = int(f_vals[min_k])
        else:
            min_f, min_k = -1, -1
        if missing:
            self._bump("scatter_degraded")
        return {
            "ok": True,
            "op": "query",
            "graph": graph,
            "n": int(n),
            "k": int(k),
            "f_values": [int(v) for v in f_vals],
            "min_f": min_f,
            "min_k": min_k,
            "weighted": False,
            "sharded": True,
            "shards": len(plan.shards),
            "rounds": rounds,
            "fragments": fragments,
            "largest_fragment_ids": largest,
            "degraded": bool(missing),
            "missing_shards": sorted(missing.values()),
            "latency_s": time.monotonic() - start,
        }

    def _fragment_call(self, shard, rows_frontier, deadline):
        """One shard fragment, delivered or typed: walk the shard's ring
        owners with the query walk's full failover taxonomy, one attempt
        thread at a time, racing a second copy after
        ``MSBFS_SHARD_HEDGE_MS`` when armed (the fragment analog of the
        client's straggler hedge — results are deterministic, either
        answer is THE answer, and the OR-merge is idempotent).
        ``deadline`` is absolute ``time.monotonic()``; spending it is a
        :class:`TransientError` (the copies may be fine — the budget is
        not), while exhausting every copy is the typed
        :class:`ShardUnavailableError` naming the shard."""
        alive = self.alive_fn() if self.alive_fn is not None else None
        owners = self.shard_ring.owners(shard.digest, alive=alive)
        if not owners:
            raise ShardUnavailableError(
                f"no live owner for shard {shard.name!r} (rows "
                f"[{shard.lo}, {shard.hi})): every copy is gone; "
                "re-replication converges when a member recovers",
                shards=(shard.name,),
            )
        hedge_s = (
            self.shard_hedge_ms / 1000.0 if self.shard_hedge_ms > 0 else None
        )
        results: "queue.Queue" = queue.Queue()

        def attempt(member: str) -> None:
            results.put(
                self._fragment_attempt(member, shard, rows_frontier, deadline)
            )

        launched = 0
        done = 0
        saturated = 0
        failures: List[str] = []
        while True:
            if launched < len(owners) and launched == done:
                # Walk: everything in flight has failed — next copy.
                threading.Thread(
                    target=attempt,
                    args=(owners[launched],),
                    name="msbfs-fleet-scatter",
                    daemon=True,
                ).start()
                launched += 1
            if done >= launched and launched >= len(owners):
                break
            wait = None
            if deadline is not None:
                wait = deadline - time.monotonic()
                if wait <= 0:
                    raise TransientError(
                        f"deadline spent mid-scatter on shard "
                        f"{shard.name!r} ({done}/{launched} attempt(s) "
                        "returned)"
                    )
            if hedge_s is not None and launched < len(owners):
                wait = hedge_s if wait is None else min(wait, hedge_s)
            try:
                kind, member, payload = results.get(timeout=wait)
            except queue.Empty:
                if hedge_s is not None and launched < len(owners):
                    # Straggler: race the next copy WITHOUT abandoning
                    # the in-flight one; first success wins.
                    self._bump("hedged")
                    threading.Thread(
                        target=attempt,
                        args=(owners[launched],),
                        name="msbfs-fleet-scatter",
                        daemon=True,
                    ).start()
                    launched += 1
                continue
            done += 1
            if kind == "ok":
                if failures:
                    with self._lock:
                        self._stats["scatter_retries"] += len(failures)
                self._bump("scatter_fragments", member)
                return payload
            if kind == "raise":
                raise payload
            if kind == "backpressure":
                saturated += 1
            failures.append(member)
        if saturated and saturated >= len(failures):
            raise BackpressureError(
                f"all {saturated} live owner(s) of shard {shard.name!r} "
                "are saturated; retry with backoff or grow the fleet"
            )
        raise ShardUnavailableError(
            f"all {len(owners)} live owner(s) of shard {shard.name!r} "
            f"(rows [{shard.lo}, {shard.hi})) failed "
            f"({', '.join(failures)}): every copy is unreachable; "
            "re-replication converges when a member recovers",
            shards=(shard.name,),
        )

    def _fragment_attempt(self, member, shard, rows_frontier, deadline):
        """One owner, one wire call; never raises — the hedged walk in
        :meth:`_fragment_call` consumes ``(kind, member, payload)``
        verdicts from its attempt threads.  The taxonomy is the query
        walk's: drops/transients/fenced walk on, backpressure is
        counted, deterministic failures surface (``raise``) — except
        ``InputError``, which for ``shard_step`` can only mean the
        shard is not loaded on a freshly promoted stand-in yet
        (reconcile lag; the router validated the frontier against the
        plan before fanning out), so it walks to the surviving copy."""
        remaining = None if deadline is None else deadline - time.monotonic()
        if remaining is not None and remaining <= 0:
            return ("fail", member, TransientError("deadline spent"))
        try:
            faults.trip(f"route{self._route_index(member)}")
        except faults.SimulatedNetDrop as drop:
            self._bump("net_drops")
            return ("fail", member, drop)
        address = self.addresses.get(member)
        if address is None:
            return ("fail", member, KeyError(member))
        timeout = min(self.timeout, self.shard_fragment_timeout_s)
        if remaining is not None:
            timeout = min(timeout, remaining)
        try:
            with span(
                "route.fragment", member=member, shard=shard.name
            ), MsbfsClient(
                address,
                timeout=timeout,
                retry=_NO_RETRY,
                epoch=self._epoch(),
            ) as client:
                out = client.shard_step(
                    shard.name, (shard.lo, shard.hi), rows_frontier
                )
        except (faults.SimulatedNetDrop, faults.SimulatedHalfOpen) as nd:
            self._bump("net_drops")
            return ("fail", member, nd)
        except ServerError as err:
            if err.type_name == "BackpressureError":
                return ("backpressure", member, err)
            if err.type_name == "FencedError":
                self._bump("fenced")
                return ("fail", member, err)
            if err.type_name in ("TransientError", "InputError"):
                return ("fail", member, err)
            return ("raise", member, err)
        except (protocol.ProtocolError, OSError, socket.timeout) as exc:
            return ("fail", member, exc)
        return ("ok", member, out.get("frontier_out") or [])

    # ---- mutation path ----------------------------------------------------
    def mutate(
        self,
        inserts: Sequence[Sequence[int]] = (),
        deletes: Sequence[Sequence[int]] = (),
        graph: str = "default",
        token: Optional[str] = None,
        deadline_s: Optional[float] = None,
    ) -> dict:
        """Replicated exactly-once mutate: apply one edge-delta batch to
        EVERY ring owner of ``graph``, in preference order, under one
        idempotency ``token`` (minted when None).  Unlike the query
        walk, failover is wrong here — a mutate must land on ALL owners
        or the replicas' version chains diverge — so an unreachable
        owner fails the call typed (TransientError) with the token in
        the message: retrying the SAME token converges, because owners
        that already applied re-ack from their dedup window while the
        missed ones apply for the first time.  Partial application is
        therefore a transient state, never a divergence."""
        if token is None:
            token = secrets.token_hex(16)
        owners = self.owners_for(graph)
        if not owners:
            raise TransientError(
                f"no live owner for graph {graph!r} "
                "(fleet booting or all owners down)"
            )
        start = time.monotonic()
        per_owner: Dict[str, dict] = {}
        with span("route.mutate", graph=graph, owners=len(owners)):
            for member in owners:
                remaining = None
                if deadline_s is not None:
                    remaining = deadline_s - (time.monotonic() - start)
                    if remaining <= 0:
                        raise TransientError(
                            f"mutate deadline spent after "
                            f"{len(per_owner)}/{len(owners)} owner(s) of "
                            f"graph {graph!r}; retry with token {token!r} "
                            "to converge"
                        )
                address = self.addresses.get(member)
                if address is None:
                    raise TransientError(
                        f"owner {member} of graph {graph!r} left the "
                        f"fleet mid-mutate; retry with token {token!r}"
                    )
                try:
                    faults.trip(f"route{self._route_index(member)}")
                    with MsbfsClient(
                        address,
                        timeout=(
                            self.timeout if remaining is None
                            else min(self.timeout, remaining)
                        ),
                        retry=_NO_RETRY,
                        epoch=self._epoch(),
                    ) as client:
                        per_owner[member] = client.mutate(
                            inserts, deletes, graph=graph, token=token
                        )
                except (faults.SimulatedNetDrop,
                        faults.SimulatedHalfOpen) as drop:
                    # Trip-time drops AND frame-level chaos from the
                    # protocol seam (partition cut mid-send, half-open
                    # swallow) land here alike: the leg is lost, the
                    # token makes the retry safe.
                    self._bump("net_drops")
                    raise TransientError(
                        f"mutate to owner {member} of graph {graph!r} "
                        f"dropped ({drop}); applied to "
                        f"{sorted(per_owner)} so far — retry with token "
                        f"{token!r} to converge"
                    ) from drop
                except ServerError as err:
                    if err.type_name == "FencedError":
                        self._bump("fenced")
                    if err.type_name in ("TransientError", "FencedError",
                                         "BackpressureError"):
                        raise TransientError(
                            f"mutate to owner {member} of graph "
                            f"{graph!r} failed ({err}); applied to "
                            f"{sorted(per_owner)} so far — retry with "
                            f"token {token!r} to converge"
                        ) from err
                    raise  # InputError etc: the mutation itself is bad
                except (protocol.ProtocolError, OSError,
                        socket.timeout) as exc:
                    raise TransientError(
                        f"mutate to owner {member} of graph {graph!r} "
                        f"lost its transport ({exc}); applied to "
                        f"{sorted(per_owner)} so far — retry with token "
                        f"{token!r} to converge"
                    ) from exc
        self._bump("mutations_routed")
        primary = per_owner[owners[0]]
        return {
            "ok": True,
            "op": "mutate",
            "graph": primary.get("graph"),
            "token": token,
            "owners": owners,
            "version": primary.get("version"),
            "digest": primary.get("digest"),
            "applied": primary.get("applied"),
            "deduplicated": bool(primary.get("deduplicated")),
            "per_owner": {
                m: {
                    "version": r.get("version"),
                    "digest": r.get("digest"),
                    "deduplicated": bool(r.get("deduplicated")),
                }
                for m, r in per_owner.items()
            },
        }

    # ---- cross-replica voting ---------------------------------------------
    def _vote_suppressed(self) -> bool:
        """True while the brownout ladder (rung >= 1) says to skip the
        vote's shadow traffic.  A broken hook reads as not-suppressed:
        integrity redundancy only yields to an affirmative signal."""
        if self.brownout_fn is None:
            return False
        try:
            return bool(self.brownout_fn())
        except Exception:  # noqa: BLE001 — a signal, never a failure
            return False

    def _vote_due(self) -> bool:
        """Deterministic accumulator sampling (no RNG — two runs of the
        same query stream vote the same queries, which keeps chaos
        tests replayable), same scheme as the supervisor's audit
        sampler."""
        if self.vote_rate <= 0.0:
            return False
        with self._lock:
            self._vote_acc += self.vote_rate
            if self._vote_acc >= 1.0:
                self._vote_acc -= 1.0
                return True
        return False

    def _shadow_query(
        self,
        member: str,
        queries,
        graph: str,
        remaining: Optional[float],
        weighted: bool = False,
    ) -> Optional[dict]:
        """One best-effort vote leg to ``member``; None when the leg is
        unavailable (down, saturated, dropped, deadline spent).  An
        unavailable leg is NOT evidence of corruption — the vote simply
        doesn't happen, exactly like a dead owner in the main walk."""
        if remaining is not None and remaining <= 0:
            return None
        address = self.addresses.get(member)
        if address is None:
            return None
        try:
            faults.trip(f"route{self._route_index(member)}")
            with MsbfsClient(
                address,
                timeout=(
                    self.timeout if remaining is None
                    else min(self.timeout, remaining)
                ),
                retry=_NO_RETRY,
                epoch=self._epoch(),
            ) as client:
                return client.query(queries, graph=graph,
                                    deadline_s=remaining,
                                    weighted=weighted)
        except (
            faults.SimulatedNetDrop,
            faults.SimulatedHalfOpen,
            ServerError,
            protocol.ProtocolError,
            OSError,
            socket.timeout,
            ValueError,
        ):
            return None

    def _quarantine(self, member: str) -> None:
        if self.quarantine_fn is None:
            return
        try:
            self.quarantine_fn(member)
        except Exception:  # noqa: BLE001 — voting must not kill the query
            return
        self._bump("quarantined")

    def _vote(
        self,
        primary: str,
        owners: List[str],
        queries,
        graph: str,
        deadline: Optional[float],
        out: dict,
        weighted: bool = False,
    ) -> dict:
        """Shadow-route the answered batch to the next live owner and
        compare answer digests; on disagreement recompute on a third
        owner, quarantine the outvoted replica, and return the majority
        answer (docstring at module top).  ``deadline`` is an ABSOLUTE
        ``time.monotonic()`` instant: each vote leg re-derives its
        residual budget just before it starts, so a slow shadow leg
        shrinks (never resets) what the arbiter leg may spend and the
        whole vote stays inside the caller's deadline."""

        def remaining() -> Optional[float]:
            return None if deadline is None else deadline - time.monotonic()

        later = owners[owners.index(primary) + 1:]
        if not later:
            return out  # nobody to vote with (replication 1 / lone survivor)
        shadow_member = later[0]
        with span(
            "route.vote", graph=graph, primary=primary, shadow=shadow_member
        ) as sp:
            shadow = self._shadow_query(
                shadow_member, queries, graph, remaining(),
                weighted=weighted,
            )
            if shadow is None:
                return out
            self._bump("votes")
            out["voted"] = True
            d_primary = _answer_digest(out)
            if _answer_digest(shadow) == d_primary:
                sp.set(agreed=True)
                return out
            sp.set(agreed=False)
        self._bump("vote_mismatches")
        record_flight(
            "vote_mismatch", graph=graph, primary=primary,
            shadow=shadow_member,
        )
        instant(
            "route.vote_mismatch", graph=graph, primary=primary,
            shadow=shadow_member,
        )
        out["vote_mismatch"] = True
        arbiter_member, arbiter = None, None
        for m in later[1:]:
            arbiter = self._shadow_query(m, queries, graph, remaining(),
                                         weighted=weighted)
            if arbiter is not None:
                arbiter_member = m
                break
        if arbiter is None:
            # Two opinions, no tiebreak: keep the ring-preferred
            # primary's answer, but take the disagreeing shadow out of
            # rotation — one of the two IS corrupt, and a quarantined
            # healthy replica merely restarts while a corrupt answer
            # left standing keeps lying.
            self._bump("vote_unresolved")
            self._quarantine(shadow_member)
            return out
        d_arbiter = _answer_digest(arbiter)
        if d_arbiter == d_primary:
            self._quarantine(shadow_member)
            return out
        shadow = dict(shadow)
        shadow["replica"] = shadow_member
        shadow["failovers"] = out.get("failovers", 0)
        shadow["voted"] = True
        shadow["vote_mismatch"] = True
        if d_arbiter == _answer_digest(shadow):
            # Majority against the primary: ITS answer was the corrupt
            # one — quarantine it and serve the agreeing pair's answer.
            self._quarantine(primary)
            return shadow
        # Three-way disagreement: at least two corrupt answers.  Trust
        # nothing we cannot certify here — quarantine both vote legs and
        # serve the arbiter's answer (the only one not yet outvoted).
        self._bump("vote_unresolved")
        self._quarantine(primary)
        self._quarantine(shadow_member)
        arbiter = dict(arbiter)
        arbiter["replica"] = arbiter_member
        arbiter["failovers"] = out.get("failovers", 0)
        arbiter["voted"] = True
        arbiter["vote_mismatch"] = True
        return arbiter

    def stats(self) -> dict:
        with self._lock:
            out = dict(self._stats)
            out["per_replica"] = dict(self._stats["per_replica"])
        return out


# Routed attempts never retry in place — the ring walk is the retry.
_NO_RETRY = RetryPolicy(max_retries=0)


class FleetFrontend:
    """The fleet's single client-facing socket: speaks the existing
    frame protocol, so the stock ``msbfs query`` client talks to a
    fleet exactly as it talks to one daemon.  Verbs: ``ping``,
    ``health`` (fleet topology + per-replica states), ``load``
    (ring-placed registration via the supervisor), ``query`` (routed),
    ``mutate`` (token-fenced, applied to every ring owner —
    :meth:`FleetRouter.mutate`), ``stats`` (router + fleet counters),
    ``trace`` (per-query trace events, fanned out to the replicas and
    merged), ``metrics`` (Prometheus text exposition of the fleet
    roll-up), ``shutdown``.

    Thread names use the ``msbfs-fleet-`` prefix (distinct from the
    single-daemon ledger in tests/conftest.py, which must keep failing
    on leaked *replica* threads, not the front end's).
    """

    def __init__(self, listen: str, router: FleetRouter, supervisor=None):
        self.listen = listen
        self.router = router
        self.supervisor = supervisor
        self._sock: Optional[socket.socket] = None
        self._accept_thread: Optional[threading.Thread] = None
        self._stopping = threading.Event()

    def start(self) -> None:
        family, target = protocol.parse_address(self.listen)
        self._sock = socket.socket(family, socket.SOCK_STREAM)
        if family == socket.AF_INET:
            self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        if family == socket.AF_UNIX and isinstance(target, str):
            if os.path.exists(target):
                os.unlink(target)  # front end owns its path (no journal)
        self._sock.bind(target)
        # Deep backlog, same reasoning as MsbfsServer.start(): stampede
        # dials must park in the queue while the acceptor is GIL-starved
        # rather than time out at the client.
        self._sock.listen(512)
        self._sock.settimeout(0.2)
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="msbfs-fleet-accept", daemon=True
        )
        self._accept_thread.start()

    def stop(self) -> None:
        self._stopping.set()
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=10.0)
            self._accept_thread = None
        family, target = protocol.parse_address(self.listen)
        if family == socket.AF_UNIX and isinstance(target, str):
            try:
                os.unlink(target)
            except OSError:
                pass

    def __enter__(self) -> "FleetFrontend":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    def _accept_loop(self) -> None:
        while not self._stopping.is_set():
            try:
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            conn.settimeout(None)
            threading.Thread(
                target=self._serve_connection,
                args=(conn,),
                name="msbfs-fleet-conn",
                daemon=True,
            ).start()

    def _serve_connection(self, conn: socket.socket) -> None:
        with conn:
            while not self._stopping.is_set():
                try:
                    request = protocol.recv_frame(conn)
                except (protocol.ProtocolError, OSError):
                    return
                if request is None:
                    return
                response = self.handle(request)
                try:
                    protocol.send_frame(conn, response)
                except OSError:
                    return
                if request.get("op") == "shutdown":
                    self.stop()
                    return

    def handle(self, request: dict) -> dict:
        # Adopt the caller's trace context (if any) for the whole verb:
        # the router's forwarding legs use MsbfsClient.query, which
        # re-injects the thread's current trace into the replica-bound
        # frame — that is how one trace_id survives the extra hop.
        ctx = TraceContext.from_wire(request.get("trace"))
        if ctx is None:
            return self._handle(request)
        with use_trace(ctx):
            return self._handle(request)

    def _check_epoch(self, frame_epoch) -> None:
        """Fence an incoming frame's membership view against the live
        ring (docs/SERVING.md "Cross-machine transport & fencing") —
        the front end refuses stale views exactly like a replica, so a
        partition-healed peer holding an old topology cannot route
        through us under it.  Frames without an epoch pass."""
        try:
            frame_epoch = int(frame_epoch)
        except (TypeError, ValueError):
            raise InputError(
                f"frame 'epoch' must be an integer, got {frame_epoch!r}"
            ) from None
        local = int(getattr(self.router.ring, "epoch", 0) or 0)
        if frame_epoch == local:
            return
        self.router._bump("fenced")
        direction = "stale behind" if frame_epoch < local else "ahead of"
        raise FencedError(
            f"frame epoch {frame_epoch} is {direction} the fleet's "
            f"membership epoch {local}; refresh the view and resend",
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
            if op == "stats":
                return {"ok": True, "op": "stats", "stats": self._op_stats()}
            if op == "trace":
                return self._op_trace(request)
            if op == "metrics":
                return {
                    "ok": True,
                    "op": "metrics",
                    "text": observe.fleet_metrics_text(self),
                }
            if op == "query":
                out = self.router.query(
                    request.get("queries") or [],
                    graph=request.get("graph", "default"),
                    deadline_s=request.get("deadline_s"),
                    hedge_after_s=request.get("hedge_after_s"),
                    priority=request.get("priority"),
                    client_id=request.get("client_id"),
                    weighted=bool(request.get("weighted", False)),
                    degraded=bool(request.get("degraded", False)),
                )
                out["ok"] = True
                return out
            if op == "mutate":
                return self.router.mutate(
                    request.get("inserts") or [],
                    request.get("deletes") or [],
                    graph=request.get("graph", "default"),
                    token=request.get("token"),
                    deadline_s=request.get("deadline_s"),
                )
            if op == "load":
                if self.supervisor is None:
                    raise InputError(
                        "this front end has no supervisor; register "
                        "graphs on the replicas directly"
                    )
                name = request.get("graph", "default")
                owners = self.supervisor.register(
                    name, request.get("path", "")
                )
                return {
                    "ok": True,
                    "op": "load",
                    "graph": {
                        "name": name,
                        "owners": owners,
                        "hash": self.supervisor.digests[name],
                    },
                }
            if op == "shutdown":
                return {"ok": True, "op": "shutdown"}
            raise InputError(f"unknown op {op!r}")
        except ServerError as err:
            # A replica's typed verdict passes through unchanged.
            return {
                "ok": False,
                "error": {
                    "type": err.type_name,
                    "message": str(err),
                    "exit_code": err.exit_code,
                },
            }
        except MsbfsError as err:
            return protocol.error_body(err)
        except Exception as err:  # noqa: BLE001 — front end must answer
            return protocol.error_body(MsbfsError(str(err)))

    def _op_health(self) -> dict:
        from .server import _pkg_version  # lazy: avoid module cycle

        fleet = (
            self.supervisor.status() if self.supervisor is not None else {}
        )
        ready = bool(fleet.get("ready")) if fleet else True
        graphs = fleet.get("graphs", {})
        routable = all(g["live_owners"] for g in graphs.values())
        return {
            "ok": True,
            "op": "health",
            "pid": os.getpid(),
            "version": _pkg_version(),
            "ready": ready and routable,
            "fleet": fleet,
        }

    def _op_trace(self, request: dict) -> dict:
        """One trace, fleet-wide: the front end's own span events (route
        legs, votes) merged with each ready replica's events for the
        same trace_id — the replica fan-out is best-effort, exactly like
        the stats roll-up (a silent replica leaves a hole, not an
        error)."""
        from ..utils import telemetry

        known = telemetry.known_traces()
        trace_id = request.get("trace_id")
        if trace_id is None and known:
            trace_id = known[-1]
        if not trace_id:
            return {
                "ok": True, "op": "trace", "trace_id": None,
                "events": [], "traces": known,
            }
        local = telemetry.trace_events(trace_id)
        remote_batches = []
        if self.supervisor is not None:
            with getattr(self.supervisor, "_lock", threading.Lock()):
                targets = [
                    r.address
                    for r in self.supervisor.replicas
                    if r.state == "ready"
                ]
            for address in targets:
                try:
                    with MsbfsClient(
                        address, timeout=10.0, retry=_NO_RETRY
                    ) as c:
                        resp = c.trace(trace_id)
                except (ServerError, protocol.ProtocolError, OSError,
                        socket.timeout, ValueError):
                    continue
                remote_batches.append(resp.get("events") or [])
        events = observe.merge_trace_events(local, remote_batches)
        return {
            "ok": True, "op": "trace", "trace_id": trace_id,
            "events": events, "traces": known,
        }

    def _op_stats(self) -> dict:
        out = {"router": self.router.stats()}
        if self.supervisor is not None:
            out["fleet"] = self.supervisor.status()
            per, totals = self._rollup()
            out["replicas"] = per
            out["totals"] = totals
            # Shard topology, surfaced top-level so an operator's first
            # `stats` answers "how is this graph cut, where do the
            # pieces live, is anything under-replicated" without
            # spelunking the fleet blob.
            shards = out["fleet"].get("shards") or {}
            if shards:
                out["shards"] = shards
                totals["under_replicated_shards"] = sum(
                    g.get("under_replicated", 0) for g in shards.values()
                )
        return out

    # Per-replica stats fields summed into the fleet-wide roll-up; the
    # queue gauge keys live under each replica's "queue" section.
    _ROLLUP_KEYS = (
        "requests_total",
        "requests_failed",
        "requests_shed",
        "requests_quarantined",
        "audited",
        "audit_failures",
        "journal_bytes",
        "shard_steps",
    )
    _ROLLUP_QUEUE_KEYS = (
        "depth",
        "rejected",
        "rejected_batch",
        "rejected_client",
        "shed_overload",
    )

    def _rollup(self):
        """Fleet-wide observability in one verb: fetch each ready
        replica's ``stats`` and sum the load/shed/integrity counters.
        Best-effort per replica — a replica that does not answer is
        listed with an ``error`` and skipped from the totals (the
        operator sees the hole, the verb still answers)."""
        per: Dict[str, dict] = {}
        totals = {k: 0 for k in self._ROLLUP_KEYS}
        totals.update({f"queue_{k}": 0 for k in self._ROLLUP_QUEUE_KEYS})
        totals["shed_brownout"] = 0
        totals["replicas_reporting"] = 0
        # Fleet-wide latency distribution: per-bucket histograms share
        # fixed log2 bounds exactly so they can be SUMMED across
        # replicas (utils/telemetry.py) — percentiles of percentiles
        # would be wrong; merged counts are not.  A replica predating
        # the hist field contributes nothing (from_snapshot -> None).
        hist_total = Histogram()
        with getattr(self.supervisor, "_lock", threading.Lock()):
            targets = [
                (r.name, r.address)
                for r in self.supervisor.replicas
                if r.state == "ready"
            ]
        for name, address in targets:
            try:
                with MsbfsClient(
                    address, timeout=10.0, retry=_NO_RETRY
                ) as c:
                    s = c.stats()
            except (ServerError, protocol.ProtocolError, OSError,
                    socket.timeout, ValueError) as exc:
                per[name] = {"error": str(exc)}
                continue
            queue = s.get("queue") or {}
            posture = s.get("posture") or {}
            row = {k: int(s.get(k, 0) or 0) for k in self._ROLLUP_KEYS}
            row.update(
                {
                    f"queue_{k}": int(queue.get(k, 0) or 0)
                    for k in self._ROLLUP_QUEUE_KEYS
                }
            )
            row["queue_oldest_age_s"] = float(
                queue.get("oldest_age_s", 0.0) or 0.0
            )
            row["shed_brownout"] = int(
                posture.get("shed_brownout", 0) or 0
            )
            for b in (s.get("buckets") or {}).values():
                h = Histogram.from_snapshot((b or {}).get("hist"))
                if h is not None:
                    try:
                        hist_total.merge(h)
                    except ValueError:
                        pass  # foreign bounds: skip, never poison totals
            per[name] = row
            totals["replicas_reporting"] += 1
            for k, v in row.items():
                if k in totals and k != "replicas_reporting":
                    totals[k] += v
        totals["latency_hist"] = hist_total.snapshot()
        totals["latency_p99_ms"] = hist_total.percentile(0.99)
        return per, totals


def fleet_main(argv: Optional[List[str]] = None, device=None) -> int:
    """The ``fleet`` subcommand's entry point: boot N replicas + the
    front-end router on one command.  The replicas run on ``--device``,
    else ``device``, else ``cuda``."""
    import argparse

    ap = argparse.ArgumentParser(
        prog="msbfs-tpu fleet",  # the JAX CLI's name: usage lines match
        description="Replicated msbfs serving fleet: N replica daemons, "
        "rendezvous placement, failover router (docs/SERVING.md)",
    )
    ap.add_argument(
        "--listen",
        default=knobs.raw(
            "MSBFS_FLEET_LISTEN",
            "unix:" + os.path.join(tempfile.gettempdir(), "msbfs-fleet.sock"),
        ),
        help="front-end address (default MSBFS_FLEET_LISTEN or "
        "unix:$TMPDIR/msbfs-fleet.sock)",
    )
    ap.add_argument("--size", type=int, default=3,
                    help="replica count (default 3)")
    ap.add_argument("--replication", type=int, default=2,
                    help="owners per graph (default 2)")
    ap.add_argument(
        "--base-dir",
        default=None,
        help="directory for replica sockets/journals/logs "
        "(default MSBFS_FLEET_DIR or $TMPDIR/msbfs-fleet)",
    )
    ap.add_argument(
        "-g", "--graph", action="append", default=[],
        metavar="[NAME=]PATH",
        help="register a graph at startup (repeatable)",
    )
    ap.add_argument("--heartbeat-ms", type=float, default=500.0,
                    help="replica heartbeat period (default 500)")
    ap.add_argument("--wait-ready-s", type=float, default=240.0,
                    help="block until all replicas are ready (0 skips)")
    ap.add_argument(
        "--transport", choices=("unix", "tcp"), default="unix",
        help="replica listener transport; tcp advertises host:port "
        "addresses for cross-host fleets (default unix)",
    )
    ap.add_argument(
        "--hosts", default="", metavar="LABEL[,LABEL...]",
        help="comma-separated host labels round-robined over replicas; "
        "the ring then spreads each graph's owners across labels",
    )
    ap.add_argument(
        "--shard-max-bytes", type=int, default=None, metavar="BYTES",
        help="shard graphs whose artifact exceeds BYTES across the "
        "fleet (default MSBFS_SHARD_MAX_BYTES; 0 = serve whole)",
    )
    ap.add_argument(
        "--shard-replicas", type=int, default=None, metavar="N",
        help="copies per shard (default MSBFS_SHARD_REPLICAS, 2)",
    )
    ap.add_argument(
        "--autoscale-max", type=int, default=0, metavar="N",
        help="arm the autoscaler: grow from --size up to N replicas "
        "under load, shrink back when quiet (0 = fixed size)",
    )
    ap.add_argument(
        "--brownout", action="store_true",
        help="arm the brownout ladder (vote -> audit -> cache-only "
        "quality step-down under sustained saturation)",
    )
    ap.add_argument(
        "--device", default=None,
        help="the replicas' torch device (default cuda; cpu runs the "
        "kernels' plain versions, for tests)",
    )
    args = ap.parse_args(argv)

    from .autoscale import AutoscaleConfig, AutoscalePolicy
    from .brownout import BrownoutLadder
    from .fleet import FleetSupervisor

    plan = faults.FaultPlan.from_env()
    faults.activate(plan)
    base_dir = args.base_dir or knobs.raw(
        "MSBFS_FLEET_DIR", os.path.join(tempfile.gettempdir(), "msbfs-fleet")
    )
    autoscale = None
    if args.autoscale_max:
        autoscale = AutoscalePolicy(
            AutoscaleConfig(
                min_replicas=args.size,
                max_replicas=max(args.size, args.autoscale_max),
            )
        )
    brownout = None
    if args.brownout:
        brownout = BrownoutLadder(
            journal_path=os.path.join(base_dir, "brownout.jsonl")
        )
    host_pool = [h.strip() for h in args.hosts.split(",") if h.strip()]
    try:
        supervisor = FleetSupervisor(
            size=args.size,
            base_dir=base_dir,
            replication=args.replication,
            heartbeat_s=args.heartbeat_ms / 1000.0,
            transport=args.transport,
            host_pool=host_pool or None,
            autoscale=autoscale,
            brownout=brownout,
            shard_max_bytes=args.shard_max_bytes,
            shard_replicas=args.shard_replicas,
            device=str(args.device or device or "cuda"),
        )
        supervisor.start(
            wait_ready_s=args.wait_ready_s or None
        )
    except (MsbfsError, OSError, ValueError) as err:
        print(f"msbfs fleet: {err}", file=sys.stderr)
        return getattr(err, "exit_code", 1)
    router = FleetRouter.for_fleet(supervisor)
    # The autoscaler's "admission collapse" signal is the router's shed
    # counter: fleet-level backpressure is what capacity must answer.
    supervisor.shed_fn = lambda: router.stats().get("shed", 0)
    frontend = FleetFrontend(args.listen, router, supervisor=supervisor)
    try:
        for spec in args.graph:
            name, sep, path = spec.partition("=")
            if not sep:
                name, path = "default", spec
            supervisor.register(name, path)
        frontend.start()
    except (MsbfsError, OSError, ValueError) as err:
        print(f"msbfs fleet: {err}", file=sys.stderr)
        supervisor.stop()
        return getattr(err, "exit_code", 1)
    import signal as _signal

    def _on_signal(signum, frame):  # noqa: ARG001 — signal signature
        frontend.stop()

    _signal.signal(_signal.SIGTERM, _on_signal)
    _signal.signal(_signal.SIGINT, _on_signal)
    names = ", ".join(sorted(supervisor.graphs)) or "none (use load)"
    log_line(
        f"msbfs fleet: {args.size} replicas (replication "
        f"{supervisor.ring.replication}) under {base_dir}; front end on "
        f"{args.listen}; graphs: {names}",
        event="fleet_start",
        size=args.size,
        listen=args.listen,
        graphs=sorted(supervisor.graphs),
    )
    try:
        while not frontend._stopping.is_set():
            time.sleep(0.2)
    except KeyboardInterrupt:
        pass
    finally:
        frontend.stop()
        supervisor.stop(drain=True)
    log_line("msbfs fleet: stopped", event="fleet_stop")
    return 0


__all__ = [
    "FleetFrontend",
    "FleetRouter",
    "fleet_main",
]

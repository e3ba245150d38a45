"""Fleet supervisor: N replica daemons, heartbeats, backoff restarts.

The port's copy of the JAX package's serve/fleet.py.  What differs:
each replica is the port's own daemon, spawned as ``python -m
parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch
serve ... --device <device>`` from the repo root (the JAX package spawns
its root ``main.py``), and the supervisor takes the replicas' ``device``
(``cuda`` unless the caller asks for the CPU, as the tests do): a
replica that finds no card exits non-zero and shows as down, then
failed; it never serves on the CPU.  On one card every replica holds
its own CUDA context on it.

One ``serve`` process is a single point of failure; the fleet makes the
loss of a whole replica a routine, recoverable event.  This module is
the process-level analogue of the batch runtime's
:class:`~..runtime.supervisor.ChunkSupervisor`: it spawns N replica
server processes (each a stock ``serve`` daemon with its own unix socket
and its own state journal), watches them through
the ``health`` verb with heartbeat timeouts, and restarts the dead ones
on the same jittered-backoff :class:`RetryPolicy` schedule the engine
retries ride — one backoff story repo-wide.

Placement rides :class:`~.ring.PlacementRing`: a registered graph is
loaded on its ``replication`` ring owners only, so each replica journals
(and journal-replays) just the graphs it owns.  When a replica dies, the
supervisor *reconciles*: every graph whose live owner set lost a member
is registered on the next ring member (HRW guarantees that is the only
movement), and when the replica comes back its own journal replay plus
an idempotent re-load converge it — registration is load-once, so
reconciliation is safe to repeat forever.

The membership is **elastic** (docs/SERVING.md "Autoscaling &
overload"): :meth:`add_replica` spawns a new slot and splices it into
the ring (minimal movement — it steals only the keys it now wins), and
:meth:`remove_replica` retires one *safely*: the victim leaves the ring
first, reconcile re-registers its graphs on the promoted owners, and
only then does it get SIGTERM — the daemon's drain path finishes every
accepted query before exit, so a scale-down loses zero acked work.
When an :class:`~.autoscale.AutoscalePolicy` is armed, the monitor loop
feeds it the queue signals each health probe already returns and
applies its deltas; a :class:`~.brownout.BrownoutLadder` rides the same
tick and pushes its rung to every replica via the ``posture`` verb.

Replicas may advertise a ``host`` label and listen on TCP
(``transport="tcp"``) so a fleet can span machines; the ring then
spreads each graph's owner set across distinct hosts.

Epoch fencing (docs/SERVING.md "Cross-machine transport & fencing"):
the supervisor owns a monotonic **membership epoch**, persisted and
fsync'd at ``base_dir/epoch`` and bumped on every topology change —
start, join, retire, quarantine, host kill.  The live value is mirrored
onto :attr:`PlacementRing.epoch` (routers stamp it on every frame) and
every replica is spawned with ``--epoch-file`` pointing at the same
file, so a frame carrying a stale view is refused with a typed
``FencedError`` (exit code 10) instead of being silently served by a
replica the sender no longer believes in.  Persistence makes the fence
survive supervisor resurrection: a new supervisor over an old
``base_dir`` resumes the counter, it never rewinds.

Chaos seams (docs/RESILIENCE.md): each monitor tick of replica ``i``
trips fault site ``replica<i>`` (``replica_kill`` -> real SIGKILL), and
each distinct host label trips its own site, where an armed
``host_down`` spec raises
:class:`~..utils.faults.SimulatedHostDown` — every replica advertising
that label is SIGKILLed in one tick, exercising cross-host failover.
``MSBFS_FAULTS`` is deliberately STRIPPED from replica environments:
the fleet plan belongs to the supervisor process, and a replica-level
plan is injected explicitly via ``replica_faults``.
"""

from __future__ import annotations

import os
import signal
import socket
import subprocess
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Set

from ..runtime.supervisor import (
    CorruptionError,
    RetryPolicy,
    StorageError,
    TransientError,
)
from ..utils import faults, knobs
from .autoscale import AutoscalePolicy, ReplicaSignal
from .brownout import BrownoutLadder
from .client import MsbfsClient, ServerError
from .journal import StateJournal
from .registry import content_hash
from .ring import PlacementRing
from .shards import ShardPlan, is_shard_name, plan_shards

_REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
# The package a replica runs (``python -m <package> serve``).
_PACKAGE = __name__.rsplit(".", 2)[0]


def _env_float(name: str, default: float) -> float:
    return knobs.get_float(name, default)


def _alloc_port() -> int:
    """Grab an ephemeral TCP port for a replica slot.  The port is
    bound, read and released — a (tiny) race with other allocators is
    acceptable for tests/benches; production fleets pass explicit
    addresses per host."""
    s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    try:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]
    finally:
        s.close()


@dataclass
class ReplicaHandle:
    """One replica slot: a stable name + address whose process comes and
    goes.  The name (``r<i>``) is the ring member, so placement survives
    restarts; the journal path is per-slot, so a restarted process
    replays its own history.  ``host`` is the failure-domain label the
    ring spreads owners across (None = its own domain)."""

    index: int
    name: str
    address: str
    journal_path: str
    log_path: str
    host: Optional[str] = None
    weight: float = 1.0
    proc: Optional[subprocess.Popen] = None
    state: str = "starting"  # starting | ready | down | failed | draining | removed
    draining: bool = False
    pid: Optional[int] = None
    restarts: int = 0
    injected_kills: int = 0
    last_exit: Optional[int] = None
    last_ok: float = 0.0  # monotonic time of last successful health probe
    spawned_at: float = 0.0
    restart_due: Optional[float] = None
    backoff: Optional[object] = None  # iterator over restart delays
    registered: Set[str] = field(default_factory=set)
    quarantines: int = 0
    # Last health probe's queue gauge (autoscaler signal).
    queue_depth: int = 0
    queue_capacity: int = 1
    queue_age_s: float = 0.0

    def describe(self) -> dict:
        return {
            "name": self.name,
            "address": self.address,
            "host": self.host,
            "weight": self.weight,
            "state": self.state,
            "pid": self.pid,
            "restarts": self.restarts,
            "injected_kills": self.injected_kills,
            "quarantines": self.quarantines,
            "last_exit": self.last_exit,
            "queue_depth": self.queue_depth,
            "queue_age_s": round(self.queue_age_s, 6),
            "graphs": sorted(self.registered),
        }


class FleetSupervisor:
    """Spawn, watch, heal — and now grow and shrink — a fleet of replica
    serving daemons.

    ``base_dir`` holds each replica's socket, journal and log.  The
    supervisor is intentionally stateless beyond the member list — kill
    the supervisor and a new one re-adopts nothing (replicas die with
    their spawning process group in tests via ``stop()``); durable graph
    state lives in the per-replica journals, as for a single daemon.
    """

    def __init__(
        self,
        size: int,
        base_dir: str,
        replication: int = 2,
        heartbeat_s: float = 0.5,
        heartbeat_timeout_s: Optional[float] = None,
        boot_timeout_s: float = 240.0,
        restart_policy: Optional[RetryPolicy] = None,
        env: Optional[Dict[str, str]] = None,
        replica_faults: Optional[Dict[int, str]] = None,
        replica_env: Optional[Dict[int, Dict[str, str]]] = None,
        server_args: Optional[List[str]] = None,
        transport: str = "unix",
        hosts: Optional[Dict[int, str]] = None,
        host_pool: Optional[List[str]] = None,
        weights: Optional[Dict[int, float]] = None,
        autoscale: Optional[AutoscalePolicy] = None,
        brownout: Optional[BrownoutLadder] = None,
        shed_fn: Optional[Callable[[], int]] = None,
        drain_timeout_s: float = 60.0,
        shard_max_bytes: Optional[int] = None,
        shard_replicas: Optional[int] = None,
        device: str = "cuda",
    ):
        if size < 1:
            raise ValueError(f"fleet size must be >= 1, got {size}")
        if transport not in ("unix", "tcp"):
            raise ValueError(
                f"transport must be 'unix' or 'tcp', got {transport!r}"
            )
        self.base_dir = os.path.abspath(base_dir)
        os.makedirs(self.base_dir, exist_ok=True)
        self.transport = transport
        self.heartbeat_s = float(heartbeat_s)
        self.heartbeat_timeout_s = (
            float(heartbeat_timeout_s)
            if heartbeat_timeout_s is not None
            else max(4 * self.heartbeat_s, 5.0)
        )
        self.boot_timeout_s = float(boot_timeout_s)
        self.drain_timeout_s = float(drain_timeout_s)
        # The batch supervisor's backoff for process restarts: bounded, jittered,
        # seeded — a crash-looping replica backs off to max_delay and a
        # replica that exhausts the schedule is marked failed (the fleet
        # degrades to survivors rather than thrashing forever).
        self.restart_policy = restart_policy or RetryPolicy(
            max_retries=6,
            base_delay=_env_float("MSBFS_FLEET_BACKOFF", 0.2),
            max_delay=5.0,
            seed=int(_env_float("MSBFS_FAULT_SEED", 0)),
        )
        self._env = dict(os.environ if env is None else env)
        # The fleet fault plan drives the SUPERVISOR's seams; replicas
        # get a clean slate unless a per-replica plan is injected.
        self._env.pop("MSBFS_FAULTS", None)
        self._replica_faults = dict(replica_faults or {})
        # Per-replica env overrides (e.g. MSBFS_AUDIT on one replica for
        # the chaos matrix' audit leg); applied on every (re)spawn.
        self._replica_env = {
            int(i): dict(v) for i, v in (replica_env or {}).items()
        }
        self._server_args = list(server_args or [])
        # Every replica's --device: the card unless the caller asks for
        # the CPU (tests).  A replica without the card exits non-zero.
        self.device = str(device)
        self._hosts_cfg = {int(i): str(h) for i, h in (hosts or {}).items()}
        self._host_pool = list(host_pool or [])
        self._weights_cfg = {
            int(i): float(w) for i, w in (weights or {}).items()
        }
        self.autoscale = autoscale
        self.brownout = brownout
        self.shed_fn = shed_fn
        self._shed_last = 0
        self._controllers_armed = False
        self._next_index = 0
        self.replicas: List[ReplicaHandle] = [
            self._make_handle(i) for i in range(size)
        ]
        self._next_index = size
        self.addresses: Dict[str, str] = {
            r.name: r.address for r in self.replicas
        }
        self.ring = PlacementRing(
            [r.name for r in self.replicas],
            replication=replication,
            weights={r.name: r.weight for r in self.replicas},
            hosts={r.name: r.host for r in self.replicas if r.host},
        )
        self.graphs: Dict[str, str] = {}  # name -> path
        self.digests: Dict[str, str] = {}  # name -> content digest
        self.refused_graphs: Dict[str, str] = {}  # name -> refusal reason
        # ---- cross-replica sharding (serve/shards.py) -------------------
        # Oversized graphs split into "<name>#shard<i>" entries that live
        # in the SAME graphs/digests tables — reconcile, digest gates and
        # journal replay apply to a shard exactly as to a whole graph.
        # Placement uses a second ring over the same members so a shard's
        # copy count (MSBFS_SHARD_REPLICAS) is independent of the whole-
        # graph replication factor.
        self.shard_max_bytes = (
            int(shard_max_bytes)
            if shard_max_bytes is not None
            else knobs.get_int("MSBFS_SHARD_MAX_BYTES", 0)
        )
        self.shard_replicas = (
            int(shard_replicas)
            if shard_replicas is not None
            else knobs.get_int("MSBFS_SHARD_REPLICAS", 2)
        )
        if self.shard_replicas < 1:
            raise ValueError(
                f"shard replicas must be >= 1, got {self.shard_replicas}"
            )
        self.shard_ring = PlacementRing(
            [r.name for r in self.replicas],
            replication=self.shard_replicas,
            weights={r.name: r.weight for r in self.replicas},
            hosts={r.name: r.host for r in self.replicas if r.host},
        )
        self.shard_plans: Dict[str, ShardPlan] = {}  # parent -> plan
        self.shard_reheals = 0  # shards re-replicated after owner loss
        # parent -> {shard name -> live-owner tuple}: last placement each
        # reconcile converged to; a diff against it IS the reheal event.
        self._shard_view: Dict[str, Dict[str, tuple]] = {}
        # Fleet manifest journal: shard topology must survive supervisor
        # resurrection (the per-replica journals only know shard NAMES,
        # not which parent they reassemble into).
        self.manifest = StateJournal(
            os.path.join(self.base_dir, "fleet.journal")
        )
        for parent, rec in sorted(self.manifest.replay().shards.items()):
            plan = ShardPlan.from_manifest(parent, rec)
            self.shard_plans[parent] = plan
            for s in plan.shards:
                self.graphs[s.name] = s.path
                self.digests[s.name] = s.digest
        # Membership epoch: durable at base_dir/epoch so a resurrected
        # supervisor resumes (never rewinds) the fence counter.
        self.epoch_path = os.path.join(self.base_dir, "epoch")
        self.epoch = self._load_epoch()
        self.ring.epoch = self.epoch
        self.shard_ring.epoch = self.epoch
        self._lock = threading.RLock()
        self._stop = threading.Event()
        self._monitor: Optional[threading.Thread] = None
        self._log_files: List[object] = []
        self.started = False

    # ---- membership epoch -------------------------------------------------
    def _load_epoch(self) -> int:
        """Resume the persisted fence counter (0 on first boot).  An
        unreadable or corrupt file restarts at 0 — strictly worse than
        resuming, but a fence that refuses to boot is worse still."""
        try:
            with open(self.epoch_path, "r", encoding="utf-8") as f:
                return int(f.read().strip() or 0)
        except (OSError, ValueError):
            return 0

    def _bump_epoch(self, reason: str) -> int:
        """Advance the membership epoch for one topology change and make
        it durable BEFORE it becomes visible: write + fsync + rename,
        then mirror onto the ring (what routers stamp on frames).  A
        crash between rename and mirror re-reads the higher value on
        resurrection — the fence is monotonic either way."""
        with self._lock:
            self.epoch += 1
            tmp = self.epoch_path + ".tmp"
            try:
                with open(tmp, "w", encoding="utf-8") as f:
                    f.write(f"{self.epoch}\n")
                    f.flush()
                    os.fsync(f.fileno())
                os.replace(tmp, self.epoch_path)
            except OSError as exc:
                print(
                    f"msbfs fleet: epoch persist to {self.epoch_path} "
                    f"failed at {reason}: {exc} (fence continues in "
                    "memory; resurrection may rewind)",
                    file=sys.stderr,
                )
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
            self.ring.epoch = self.epoch
            self.shard_ring.epoch = self.epoch
            return self.epoch

    def _host_for(self, index: int) -> Optional[str]:
        if index in self._hosts_cfg:
            return self._hosts_cfg[index]
        if self._host_pool:
            return self._host_pool[index % len(self._host_pool)]
        return None

    def _make_handle(
        self,
        index: int,
        weight: Optional[float] = None,
        host: Optional[str] = None,
    ) -> ReplicaHandle:
        if self.transport == "tcp":
            address = f"127.0.0.1:{_alloc_port()}"
        else:
            address = f"unix:{os.path.join(self.base_dir, f'r{index}.sock')}"
        return ReplicaHandle(
            index=index,
            name=f"r{index}",
            address=address,
            journal_path=os.path.join(self.base_dir, f"r{index}.journal"),
            log_path=os.path.join(self.base_dir, f"r{index}.log"),
            host=host if host is not None else self._host_for(index),
            weight=(
                weight
                if weight is not None
                else self._weights_cfg.get(index, 1.0)
            ),
        )

    # ---- lifecycle --------------------------------------------------------
    def start(self, wait_ready_s: Optional[float] = None) -> None:
        with self._lock:
            if self.started:
                from ..runtime.supervisor import InputError

                raise InputError("fleet already started")
            self.started = True
            # The boot topology is itself a membership change: stamp it
            # so frames minted against a pre-start view are fenceable.
            self._bump_epoch("start")
            for r in self.replicas:
                self._spawn(r)
        self._monitor = threading.Thread(
            target=self._monitor_loop, name="msbfs-fleet-monitor", daemon=True
        )
        self._monitor.start()
        if wait_ready_s is not None:
            self.wait_ready(wait_ready_s)

    def stop(self, drain: bool = False) -> None:
        """Tear the fleet down: stop the monitor, then SIGTERM (drain) or
        SIGKILL each replica and reap it.  Idempotent."""
        self._stop.set()
        if self._monitor is not None:
            self._monitor.join(timeout=30.0)
            self._monitor = None
        with self._lock:
            procs = [(r, r.proc) for r in self.replicas]
        for r, proc in procs:
            if proc is None or proc.poll() is not None:
                continue
            try:
                proc.send_signal(signal.SIGTERM if drain else signal.SIGKILL)
            except OSError:
                pass
        for r, proc in procs:
            if proc is None:
                continue
            try:
                proc.wait(timeout=60.0 if drain else 30.0)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=30.0)
            r.last_exit = proc.returncode
            if r.state != "removed":
                r.state = "down"
            r.pid = None
        for f in self._log_files:
            try:
                f.close()
            except OSError:
                pass
        self._log_files = []

    def __enter__(self) -> "FleetSupervisor":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    def active_replicas(self) -> List[ReplicaHandle]:
        """Slots that count toward fleet size: not removed, not on the
        way out."""
        with self._lock:
            return [
                r
                for r in self.replicas
                if r.state != "removed" and not r.draining
            ]

    def wait_ready(self, timeout_s: float, quorum: Optional[int] = None) -> None:
        """Block until ``quorum`` replicas (default: all active) report
        ready."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            want = (
                len(self.active_replicas()) if quorum is None else int(quorum)
            )
            if len(self.ready_names()) >= want:
                return
            time.sleep(min(0.1, self.heartbeat_s))
        want = len(self.active_replicas()) if quorum is None else int(quorum)
        raise TransientError(
            f"fleet: {len(self.ready_names())}/{want} replicas ready "
            f"after {timeout_s:g}s (states: "
            f"{[r.state for r in self.replicas]})"
        )

    # ---- spawning ---------------------------------------------------------
    def _spawn(self, r: ReplicaHandle) -> None:
        if r.address.startswith("unix:"):
            sock_path = r.address[len("unix:"):]
            if os.path.exists(sock_path):
                try:
                    os.unlink(sock_path)
                except OSError:
                    pass
        env = dict(self._env)
        env.update(self._replica_env.get(r.index, {}))
        plan = self._replica_faults.get(r.index)
        if plan:
            env["MSBFS_FAULTS"] = plan
        cmd = self.replica_command(r)
        log = open(r.log_path, "ab")
        self._log_files.append(log)
        r.proc = subprocess.Popen(
            cmd, cwd=_REPO_ROOT, env=env, stdout=log, stderr=log
        )
        r.pid = r.proc.pid
        r.state = "starting"
        r.spawned_at = time.monotonic()
        r.last_ok = 0.0
        r.restart_due = None
        r.registered = set()

    def replica_command(self, r: ReplicaHandle) -> List[str]:
        """The argv a replica slot is spawned with: the port's ``serve``
        as a module of this package, run from the repo root."""
        return [
            sys.executable,
            "-m",
            _PACKAGE,
            "serve",
            "--listen",
            r.address,
            "--journal",
            r.journal_path,
            "--epoch-file",
            self.epoch_path,
            "--device",
            self.device,
        ] + self._server_args

    def _schedule_restart(self, r: ReplicaHandle) -> None:
        if r.backoff is None:
            r.backoff = iter(self.restart_policy.delays())
        delay = next(r.backoff, None)
        if delay is None:
            r.state = "failed"  # budget exhausted: degrade to survivors
            r.restart_due = None
            return
        r.state = "down"
        r.restart_due = time.monotonic() + delay

    # ---- elastic membership -----------------------------------------------
    def add_replica(
        self, weight: float = 1.0, host: Optional[str] = None
    ) -> ReplicaHandle:
        """Scale up by one slot: fresh index (slot names are never
        reused, so a removed replica's journal can't be replayed by an
        unrelated successor), spliced into the ring with minimal
        movement, spawned immediately when the fleet is running.
        Reconcile then loads onto it exactly the graphs it now owns."""
        with self._lock:
            i = self._next_index
            self._next_index += 1
            r = self._make_handle(
                i,
                weight=weight,
                host=host if host is not None else self._host_for(i),
            )
            self.replicas.append(r)
            self.addresses[r.name] = r.address
            self.ring.add_member(r.name, weight=r.weight, host=r.host)
            self.shard_ring.add_member(r.name, weight=r.weight, host=r.host)
            self._bump_epoch(f"join {r.name}")
            if self.started and not self._stop.is_set():
                self._spawn(r)
        return r

    def remove_replica(
        self,
        name: str,
        sync: bool = True,
        drain_timeout_s: Optional[float] = None,
    ) -> bool:
        """Scale down by one slot, safely.  Ordering is the contract:

        1. the victim leaves the ring — new queries route to the
           promoted owners, nothing new lands on it;
        2. reconcile re-registers its graphs on those owners NOW, while
           the victim still serves (no availability dip);
        3. SIGTERM — the daemon's drain path finishes every accepted query
           (in flight AND queued) and exits 0; only a drain-timeout
           stalls to SIGKILL.

        ``sync=False`` runs step 3 on a background thread (the monitor
        loop uses this so a scale-down never blocks heartbeats).
        Returns False when ``name`` is unknown or already leaving."""
        timeout = (
            self.drain_timeout_s
            if drain_timeout_s is None
            else float(drain_timeout_s)
        )
        with self._lock:
            r = next((x for x in self.replicas if x.name == name), None)
            if r is None or r.draining or r.state == "removed":
                return False
            live = [
                x
                for x in self.replicas
                if x.state != "removed" and not x.draining
            ]
            if len(live) <= 1:
                raise ValueError("cannot remove the last live replica")
            r.draining = True
            r.state = "draining"
            if r.name in self.ring.members:
                self.ring.remove_member(r.name)
            if r.name in self.shard_ring.members:
                self.shard_ring.remove_member(r.name)
            self._bump_epoch(f"retire {name}")
        # Promoted owners pick the victim's graphs up while it still
        # answers — the walk order is ring order, so by the time the
        # victim stops accepting, its keys already have live homes.
        self._reconcile()
        if sync:
            self._drain_victim(r, timeout)
        else:
            threading.Thread(
                target=self._drain_victim,
                args=(r, timeout),
                name="msbfs-fleet-drain",
                daemon=True,
            ).start()
        return True

    def _drain_victim(self, r: ReplicaHandle, timeout: float) -> None:
        proc = r.proc
        if proc is not None and proc.poll() is None:
            try:
                proc.send_signal(signal.SIGTERM)
            except OSError:
                pass
            try:
                proc.wait(timeout=timeout)
            except subprocess.TimeoutExpired:
                try:
                    proc.kill()
                    proc.wait(timeout=30.0)
                except OSError:
                    pass
        if proc is not None:
            r.last_exit = proc.returncode
        with self._lock:
            r.pid = None
            r.state = "removed"
            self.addresses.pop(r.name, None)

    # ---- monitoring -------------------------------------------------------
    def _monitor_loop(self) -> None:
        while not self._stop.wait(self.heartbeat_s):
            try:
                self._tick_hosts()
                with self._lock:
                    snapshot = list(self.replicas)
                changed = False
                for r in snapshot:
                    changed |= self._tick(r)
                if changed:
                    self._reconcile()
                self._control_tick()
            except Exception:  # noqa: BLE001 — the monitor must survive
                pass

    def _tick_hosts(self) -> None:
        """Trip each distinct host label as a fault site.  An armed
        ``host_down:<host>`` plan raises SimulatedHostDown here; the
        supervisor answers with a real SIGKILL of every replica on that
        host — a whole failure domain gone in one heartbeat."""
        with self._lock:
            labels: List[str] = []
            for r in self.replicas:
                if r.host and r.state != "removed" and r.host not in labels:
                    labels.append(r.host)
        for label in labels:
            try:
                faults.trip(label)
            except faults.SimulatedHostDown as down:
                self._kill_host(down.host)

    def _kill_host(self, host: str) -> None:
        with self._lock:
            victims = [r for r in self.replicas if r.host == host]
        for v in victims:
            if v.proc is not None and v.proc.poll() is None:
                v.injected_kills += 1
                try:
                    v.proc.kill()
                    v.proc.wait(timeout=30.0)
                except OSError:
                    pass
        # A whole failure domain went dark: one epoch bump for the event
        # (not one per victim) — routers re-learn the view once.
        self._bump_epoch(f"host_down {host}")

    def _tick(self, r: ReplicaHandle) -> bool:
        """One heartbeat of one replica; True when its readiness flipped
        (the reconcile trigger).  This is the fleet chaos seam."""
        if r.state in ("failed", "removed") or r.draining:
            return False
        try:
            faults.trip(f"replica{r.index}")
        except faults.SimulatedReplicaKill as kill:
            victim = self.replicas[kill.replica % len(self.replicas)]
            if victim.proc is not None and victim.proc.poll() is None:
                victim.injected_kills += 1
                try:
                    victim.proc.kill()
                    victim.proc.wait(timeout=30.0)
                except OSError:
                    pass
        now = time.monotonic()
        was_ready = r.state == "ready"
        if r.proc is None or r.proc.poll() is not None:
            if r.state not in ("down", "failed") or r.restart_due is None:
                if r.proc is not None:
                    r.last_exit = r.proc.returncode
                if r.state != "failed":
                    self._schedule_restart(r)
            if (
                r.state == "down"
                and r.restart_due is not None
                and now >= r.restart_due
            ):
                r.restarts += 1
                self._spawn(r)
            return was_ready
        # Process is alive: probe readiness.
        healthy = self._probe(r) is not None
        if healthy:
            r.last_ok = now
            if r.state != "ready":
                r.state = "ready"
                r.backoff = None  # a recovered replica regains full budget
                # A replica (re)joining mid-brownout must adopt the
                # current posture — transitions it missed don't re-fire.
                if self.brownout is not None and self.brownout.level > 0:
                    self._push_posture_one(r)
            return not was_ready
        if was_ready and now - r.last_ok > self.heartbeat_timeout_s:
            # Alive but unresponsive past the timeout: treat as dead —
            # kill hard so the journal-replay restart path takes over.
            try:
                r.proc.kill()
                r.proc.wait(timeout=30.0)
            except OSError:
                pass
            r.last_exit = r.proc.returncode
            self._schedule_restart(r)
            return True
        if r.state == "starting" and now - r.spawned_at > self.boot_timeout_s:
            try:
                r.proc.kill()
                r.proc.wait(timeout=30.0)
            except OSError:
                pass
            r.last_exit = r.proc.returncode
            self._schedule_restart(r)
        return False

    def _probe(self, r: ReplicaHandle) -> Optional[dict]:
        """One health round trip; no retries (the heartbeat IS the retry
        loop).  Ready means journal replay finished and the daemon is
        accepting work.  Returns the health payload (the autoscaler's
        queue signals ride it) or None when not ready."""
        try:
            with MsbfsClient(
                r.address,
                timeout=max(2.0, self.heartbeat_timeout_s),
                retry=RetryPolicy(max_retries=0),
            ) as c:
                h = c.health()
        except (ServerError, OSError, ValueError):
            return None
        if not h.get("ready") or h.get("draining"):
            return None
        q = h.get("queue") or {}
        r.queue_depth = int(q.get("depth", h.get("queue_depth", 0)) or 0)
        r.queue_capacity = max(1, int(q.get("capacity", 1) or 1))
        r.queue_age_s = float(q.get("oldest_age_s", 0.0) or 0.0)
        return h

    # ---- overload control loop --------------------------------------------
    def _control_tick(self) -> None:
        """Feed the autoscaler and the brownout ladder one heartbeat of
        fleet signal and apply what they decide.  Both are optional and
        both are pure controllers — this is the only place decisions
        turn into membership changes or posture pushes."""
        if self.autoscale is None and self.brownout is None:
            return
        shed_delta = 0
        if self.shed_fn is not None:
            try:
                shed_now = int(self.shed_fn())
            except Exception:  # noqa: BLE001 — signal, not control
                shed_now = self._shed_last
            shed_delta = max(0, shed_now - self._shed_last)
            self._shed_last = shed_now
        with self._lock:
            active = [
                r
                for r in self.replicas
                if r.state != "removed" and not r.draining
            ]
            signals = [
                ReplicaSignal(
                    utilization=r.queue_depth / max(1, r.queue_capacity),
                    oldest_age_s=r.queue_age_s,
                )
                for r in active
                if r.state == "ready"
            ]
            size = len(active)
        # An unready fleet is not a dead fleet: until the first replica
        # has ever reported ready, an empty signal list means "still
        # booting", and the policy's empty-is-hot rule (meant for a
        # fleet that LOST everything) would scale up against thin air.
        if signals:
            self._controllers_armed = True
        elif not self._controllers_armed:
            return
        if self.brownout is not None:
            high = (
                self.autoscale.config.high_watermark
                if self.autoscale is not None
                else 0.75
            )
            util = (
                sum(s.utilization for s in signals) / len(signals)
                if signals
                else 0.0
            )
            saturated = bool(signals) and (util >= high or shed_delta > 0)
            if self.brownout.tick(saturated) is not None:
                self._push_posture()
        if self.autoscale is None or self._stop.is_set():
            return
        delta = self.autoscale.tick(
            size=size, replicas=signals, shed_since_last=shed_delta
        )
        if delta > 0:
            for _ in range(delta):
                try:
                    self.add_replica()
                except Exception:  # noqa: BLE001
                    self.autoscale.cancel()
                    break
        elif delta < 0:
            # Retire the newest ready replicas first: they own the
            # fewest long-lived keys and their journals are smallest.
            victims = [r for r in reversed(active) if r.state == "ready"]
            victims = victims[: -delta]
            if not victims:
                self.autoscale.cancel()
            for v in victims:
                try:
                    self.remove_replica(v.name, sync=False)
                except ValueError:
                    self.autoscale.cancel()

    def _push_posture(self) -> None:
        with self._lock:
            targets = [r for r in self.replicas if r.state == "ready"]
        for r in targets:
            self._push_posture_one(r)

    def _push_posture_one(self, r: ReplicaHandle) -> None:
        """Best-effort posture push; a miss is healed on the replica's
        next ready flip or the ladder's next transition."""
        if self.brownout is None:
            return
        audit = 0.0 if self.brownout.audit_suppressed() else "restore"
        try:
            with MsbfsClient(
                r.address, timeout=10.0, retry=RetryPolicy(max_retries=0)
            ) as c:
                c.posture(
                    audit_sample=audit,
                    cache_only=self.brownout.cache_only(),
                )
        except (ServerError, OSError, ValueError):
            pass

    # ---- placement --------------------------------------------------------
    def register(self, name: str, path: str) -> List[str]:
        """Register ``path`` under ``name`` on the graph's ring owners.
        Returns the owner names.  Safe to call again (load-once).

        When ``shard_max_bytes`` is armed and the artifact exceeds it,
        the graph is planned into row-range shards instead (serve/
        shards.py): each shard registers under its derived name on the
        shard ring, the manifest journals the topology BEFORE placement
        (a supervisor crash mid-register resurrects the plan, and the
        shard artifacts it points at are already on disk), and the
        return value is the union of shard owners.  A manifest append
        that hits a full disk propagates the typed ``StorageError`` —
        the registration promise was durability, not a hint; nothing is
        placed, and re-registering after freeing disk re-plans
        deterministically onto the same artifact digests."""
        digest = content_hash(path)
        plan = None
        if self.shard_max_bytes > 0 and not is_shard_name(name):
            plan = plan_shards(
                name,
                path,
                out_dir=os.path.join(
                    self.base_dir, "shards", name.replace(os.sep, "_")
                ),
                max_bytes=self.shard_max_bytes,
                replicas=self.shard_replicas,
                digest=digest,
            )
        if plan is None:
            with self._lock:
                self.graphs[name] = path
                self.digests[name] = digest
            self._reconcile()
            return self.ring.owners(digest)
        self.manifest.append(plan.to_record())  # StorageError propagates
        with self._lock:
            self.shard_plans[name] = plan
            # A re-registration with a new split drops stale shard rows.
            for gname in [
                g
                for g in self.graphs
                if is_shard_name(g)
                and g.split("#", 1)[0] == name
                and g not in {s.name for s in plan.shards}
            ]:
                self.graphs.pop(gname, None)
                self.digests.pop(gname, None)
            for s in plan.shards:
                self.graphs[s.name] = s.path
                self.digests[s.name] = s.digest
        self._reconcile()
        owners: Set[str] = set()
        for s in plan.shards:
            owners.update(self.shard_ring.owners(s.digest))
        return sorted(owners)

    def _ring_for(self, name: str) -> PlacementRing:
        """Shard entries place on the shard ring (their own replication
        factor); whole graphs on the stock ring."""
        return self.shard_ring if is_shard_name(name) else self.ring

    def ready_names(self) -> Set[str]:
        return {r.name for r in self.replicas if r.state == "ready"}

    def _reconcile(self) -> None:
        """Converge placement: every graph loaded on its live owner set.
        Load-once makes this idempotent; a dead owner's key lands on the
        next ring member (stand-in), and a recovered owner picks its
        graphs back up on the next pass."""
        with self._lock:
            todo = list(self.graphs.items())
            digests = dict(self.digests)
            # Readiness snapshot under the same lock as the graph table:
            # a replica flipping state mid-snapshot must not let one
            # graph see a ring the next graph doesn't (the two would
            # converge to different stand-ins for the same outage).
            ready = {r.name: r for r in self.replicas if r.state == "ready"}
        for name, path in todo:
            owners = self._ring_for(name).owners(
                digests[name], alive=ready.keys()
            )
            pending = [
                ready[o] for o in owners if name not in ready[o].registered
            ]
            if not pending:
                continue
            # Re-registration integrity gate: re-hash the on-disk file
            # against the digest recorded at register() time.  A file
            # that changed underneath the fleet must not be silently
            # re-registered under the old name on a stand-in — record a
            # typed refusal in status() and keep the placement hole (a
            # background thread cannot usefully raise).
            try:
                digest_now = content_hash(path)
            except OSError as exc:
                digest_now, reason = None, f"unreadable: {exc}"
            if digest_now != digests[name]:
                if digest_now is not None:
                    reason = (
                        f"{CorruptionError.__name__}: on-disk content "
                        f"hash {digest_now} != registered "
                        f"{digests[name]} — refusing re-registration of "
                        "silently different content"
                    )
                with self._lock:
                    self.refused_graphs[name] = reason
                continue
            with self._lock:
                self.refused_graphs.pop(name, None)  # file recovered
            for r in pending:
                try:
                    with MsbfsClient(r.address, timeout=300.0) as c:
                        c.load(path, graph=name)
                    r.registered.add(name)
                except (ServerError, OSError, ValueError):
                    pass  # next reconcile pass retries
        self._note_shard_moves(ready.keys())

    def _note_shard_moves(self, alive) -> None:
        """Detect shard re-replication: the reconcile loop above already
        DID the copy (a shard is just a graph; a dead owner's key walks
        to the ring stand-in and gets the digest-verified load), so all
        that is left is to make the move durable and fenceable — append
        the manifest again (journal-recorded) and bump the membership
        epoch so frames minted against the old placement are refused.
        The trigger is a placement DIFF against the last converged view,
        not a death event: a reheal and a recovery are both topology
        changes, and counting diffs makes the chaos chain's
        ``shard_reheals`` assertion deterministic."""
        alive = set(alive)
        with self._lock:
            plans = dict(self.shard_plans)
        for parent, plan in plans.items():
            view = {
                s.name: tuple(self.shard_ring.owners(s.digest, alive=alive))
                for s in plan.shards
            }
            with self._lock:
                prev = self._shard_view.get(parent)
                self._shard_view[parent] = view
            if prev is None or view == prev:
                continue
            moved = sorted(sn for sn in view if view[sn] != prev.get(sn))
            with self._lock:
                self.shard_reheals += len(moved)
            try:
                self.manifest.append(plan.to_record())
            except StorageError as exc:
                # The copies themselves landed; only the manifest
                # re-append is lost.  Resurrection re-plans from the
                # parent artifact, so degrade loudly, don't crash the
                # monitor thread (docs/RESILIENCE.md "Disk exhaustion").
                print(
                    f"msbfs fleet: shard reheal for {parent!r} not "
                    f"journaled: {exc}",
                    file=sys.stderr,
                )
            self._bump_epoch(
                f"shard-reheal {parent}: {','.join(moved)}"
            )

    # ---- corruption response ----------------------------------------------
    def quarantine(self, name_or_index) -> bool:
        """Take a replica that served a corrupt answer out of rotation:
        SIGKILL its process so the stock heartbeat machinery does the
        rest — restart on the jittered backoff schedule, journal replay,
        reconcile moves its keys to a stand-in meanwhile.  Deliberately
        NOT a new lifecycle state: a quarantined replica is just a dead
        one, and dead is the one condition the fleet already heals from
        end to end.  Returns True when a live process was killed."""
        with self._lock:
            for r in self.replicas:
                if r.name == name_or_index or r.index == name_or_index:
                    victim = r
                    break
            else:
                return False
            victim.quarantines += 1
            proc = victim.proc
        if proc is None or proc.poll() is not None:
            return False
        try:
            proc.kill()
            proc.wait(timeout=30.0)
        except OSError:
            return False
        # A quarantine is a forced view change: in-flight frames minted
        # against the pre-quarantine view must be refusable.
        self._bump_epoch(f"quarantine {victim.name}")
        return True

    # ---- observability ----------------------------------------------------
    def status(self) -> dict:
        with self._lock:
            digests = dict(self.digests)
            refused = dict(self.refused_graphs)
            replicas = list(self.replicas)
            plans = dict(self.shard_plans)
            reheals = self.shard_reheals
        ready = self.ready_names()
        shards = {}
        for parent, plan in plans.items():
            rows = []
            under = 0
            for s in plan.shards:
                live = self.shard_ring.owners(s.digest, alive=ready)
                if len(live) < min(plan.replicas, len(ready) or 1):
                    under += 1
                rows.append(
                    {
                        "name": s.name,
                        "digest": s.digest,
                        "rows": [s.lo, s.hi],
                        "owners": self.shard_ring.owners(s.digest),
                        "live_owners": live,
                    }
                )
            shards[parent] = {
                "digest": plan.digest,
                "n": plan.n,
                "replicas": plan.replicas,
                "under_replicated": under,
                "shards": rows,
            }
        out = {
            "size": len([r for r in replicas if r.state != "removed"]),
            "slots": self._next_index,
            "epoch": self.epoch,
            "transport": self.transport,
            "replication": self.ring.replication,
            "shard_replicas": self.shard_replicas,
            "shard_reheals": reheals,
            "refused_graphs": refused,
            "ready": sorted(ready),
            "replicas": [r.describe() for r in replicas],
            "graphs": {
                name: {
                    "digest": digest,
                    "owners": self._ring_for(name).owners(digest),
                    "live_owners": self._ring_for(name).owners(
                        digest, alive=ready
                    ),
                }
                for name, digest in digests.items()
            },
            "shards": shards,
        }
        if self.autoscale is not None:
            out["autoscale"] = self.autoscale.describe()
        if self.brownout is not None:
            out["brownout"] = self.brownout.describe()
        return out

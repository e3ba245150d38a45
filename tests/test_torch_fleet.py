"""The port's replicated fleet (serve/fleet.py, serve/router.py) against the
JAX package's, on the CPU.

Two trios, module-scoped: three JAX daemons and three port daemons
(``device="cpu"``) over the same graph (``gnm_edges(120, 360, seed=7)``).
Each router scenario runs once over each package's trio with that
package's router, and the answers, routing and counters must be equal:
the primary's route, a dead primary, ``net_drop``, ``replica_slow``,
typed refusals, shed, the cross-replica vote (agreeing, ``bitflip:dist``
on the primary and on the shadow, unresolved, sampled) and a sharded
query equal to the whole graph's.  Then: JAX's client against the port's
front end, the fleet metrics with the JAX package's names and labels, the
supervisor's shard planning and resurrection, and real replica processes
of the port (``--device cpu``): a two-replica fleet under ``replica_kill``
and a replica that finds no card.  JAX's heavier chaos chains have
slow-marked counterparts at the end.
"""

import os
import sys
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu.runtime import (
    supervisor as jsupervisor,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu.serve import (
    client as jclient,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu.serve import (
    fleet as jfleet,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu.serve import (
    observe as jobserve,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu.serve import (
    ring as jring,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu.serve import (
    router as jrouter,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu.serve import (
    server as jserver,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu.serve import (
    shards as jshards,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu.utils import (
    faults as jfaults,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.models import (
    generators,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.runtime import (
    supervisor,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.serve import (
    client,
    fleet,
    observe,
    ring,
    router,
    server,
    shards,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.serve.journal import (
    StateJournal,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.serve.registry import (
    content_hash,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.utils import (
    faults,
    io,
    telemetry,
)

PKG = "parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch"
QS = [[1, 2], [3, 4]]

PORT = SimpleNamespace(name="port", ring=ring, router=router, client=client, faults=faults,
                       sup=supervisor, server=server, shards=shards, fleet=fleet,
                       observe=observe, kw={"device": "cpu"})
JAX = SimpleNamespace(name="jax", ring=jring, router=jrouter, client=jclient, faults=jfaults,
                      sup=jsupervisor, server=jserver, shards=jshards, fleet=jfleet,
                      observe=jobserve, kw={})


def answer(out: dict):
    return (out["f_values"], out["min_f"], out["min_k"])


@pytest.fixture(autouse=True)
def _no_fault_plan_left():
    """No test leaves a fault plan of either package installed."""
    yield
    faults.activate(None)
    jfaults.activate(None)


def _start(pkg, listen, graphs, **kw):
    srv = pkg.server.MsbfsServer(listen=listen, graphs=graphs, window_s=0.0,
                                 request_timeout_s=60.0, **pkg.kw, **kw)
    srv.start()
    return srv


@pytest.fixture(scope="module")
def trios(tmp_path_factory):
    """{"port": trio, "jax": trio}: three live daemons of each package
    holding the graph, and the digest the ring places on.  Scenarios that
    kill or saturate replicas start their own."""
    d = tmp_path_factory.mktemp("torch_fleet")
    n, edges = generators.gnm_edges(120, 360, seed=7)
    gpath = str(d / "g.bin")
    io.save_graph_bin(gpath, n, edges)
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("MSBFS_FAULTS", raising=False)
        try:
            for pkg in (JAX, PORT):
                servers, addresses = {}, {}
                for i in range(3):
                    name = f"r{i}"
                    addresses[name] = f"unix:{d}/{pkg.name}{i}.sock"
                    servers[name] = _start(pkg, addresses[name], {"default": gpath})
                out[pkg.name] = dict(pkg=pkg, servers=servers, addresses=addresses,
                                     graph_path=gpath, digest=content_hash(gpath), n=n,
                                     dir=d)
                # One query of the scenarios' shape on each daemon first: a
                # daemon's first query of a shape compiles it, which on a
                # loaded host can outlast a scenario's deadline.  Its groups
                # are no scenario's, so no scenario reads it from a cache.
                for address in addresses.values():
                    with pkg.client.MsbfsClient(address, timeout=300) as c:
                        c.query([[5, 6], [7, 8]])
            yield out
        finally:
            for trio in out.values():
                for srv in trio["servers"].values():
                    srv.stop()


def _router(trio, members=None, replication=2, **kw):
    pkg = trio["pkg"]
    members = list(members or trio["addresses"])
    addresses = {m: trio["addresses"].get(m, f"unix:{trio['dir']}/void.sock")
                 for m in members}
    return pkg.router.FleetRouter(pkg.ring.PlacementRing(members, replication=replication),
                                  addresses, {"default": trio["digest"]}, **kw)


def _direct(trio, member, qs):
    with trio["pkg"].client.MsbfsClient(trio["addresses"][member], timeout=60) as c:
        return answer(c.query(qs))


def _failure(fn):
    """The typed outcome of a call that must fail: (class, ServerError type)."""
    with pytest.raises(Exception) as err:
        fn()
    return type(err.value).__name__, getattr(err.value, "type_name", None)


# ---------------------------------------------------------------------------
# Router scenarios: each returns what must be equal across the packages.
# ---------------------------------------------------------------------------


def sc_primary(trio):
    r = _router(trio)
    owners = r.owners_for("default")
    out = r.query(QS)
    assert answer(out) == _direct(trio, owners[1], QS)
    return owners, answer(out), out["replica"], out["failovers"], r.stats()


def sc_for_fleet_late_registration(trio):
    pkg = trio["pkg"]
    stub = SimpleNamespace(
        ring=pkg.ring.PlacementRing(list(trio["addresses"]), replication=2),
        replicas=[SimpleNamespace(name=m, address=a) for m, a in trio["addresses"].items()],
        digests={}, ready_names=lambda: set(trio["addresses"]))
    r = pkg.router.FleetRouter.for_fleet(stub, timeout=60.0)
    refused = _failure(lambda: r.owners_for("default"))
    stub.digests["default"] = trio["digest"]
    out = r.query(QS)
    return refused, answer(out), out["failovers"]


def sc_dead_primary(trio):
    pkg = trio["pkg"]
    live = list(trio["addresses"])
    dead = next(f"void{i}" for i in range(1000)
                if all(pkg.ring._score(trio["digest"], f"void{i}") >
                       pkg.ring._score(trio["digest"], m) for m in live))
    r = _router(trio, members=[dead] + live)
    owners = r.owners_for("default")
    t0 = time.monotonic()
    out = r.query(QS, deadline_s=10.0)
    assert time.monotonic() - t0 < 10.0
    return owners, answer(out), out["replica"], out["failovers"], r.stats()


def sc_net_drop(trio):
    r = _router(trio)
    owners = r.owners_for("default")
    f = trio["pkg"].faults
    f.activate(f.FaultPlan.parse(f"net_drop:route{r.ring.members.index(owners[0])}:1"))
    try:
        out = r.query(QS)
    finally:
        f.activate(None)
    again = r.query(QS)["replica"]
    return owners, answer(out), out["replica"], out["failovers"], again, r.stats()


def sc_replica_slow(trio):
    r = _router(trio)
    owners = r.owners_for("default")
    f = trio["pkg"].faults
    plan = f.FaultPlan.parse(f"replica_slow:route{r.ring.members.index(owners[0])}:1",
                             slow_seconds=0.2)
    f.activate(plan)
    try:
        t0 = time.monotonic()
        out = r.query(QS)
        stalled = time.monotonic() - t0
    finally:
        f.activate(None)
    assert stalled >= 0.2
    return answer(out), out["replica"], [s.fired for s in plan.specs], r.stats()


def sc_unknown_graph(trio):
    r = _router(trio)
    return _failure(lambda: r.query(QS, graph="nope")), r.stats()


def sc_replica_input_error(trio):
    pkg = trio["pkg"]
    r = pkg.router.FleetRouter(pkg.ring.PlacementRing(list(trio["addresses"]), replication=2),
                               dict(trio["addresses"]), {"ghost": "0" * 64})
    return _failure(lambda: r.query(QS, graph="ghost")), r.stats()


def sc_no_live_owner(trio):
    r = _router(trio, alive_fn=lambda: set())
    return _failure(lambda: r.query(QS)), r.stats()


def _arm_dist_flip(trio, member):
    sup = trio["servers"][member].registry.get("default").supervisor
    sup.plan = trio["pkg"].faults.FaultPlan.parse("bitflip:dist:1")
    return sup


def _vote(trio, replication, flip, qs, rate=1.0, queries=1):
    calls = []
    r = _router(trio, replication=replication, vote_rate=rate,
                quarantine_fn=lambda m: calls.append(m) or True)
    owners = r.owners_for("default")
    sup = _arm_dist_flip(trio, owners[flip]) if flip is not None else None
    try:
        outs = [r.query(qs) for _ in range(queries)]
    finally:
        if sup is not None:
            sup.plan = None
    oracle = _direct(trio, owners[-1], qs)
    return [(answer(o) == oracle, o["replica"], o.get("voted"), o.get("vote_mismatch"))
            for o in outs], owners, calls, r.stats()


def sc_vote_agree(trio):
    out = _vote(trio, 3, None, QS)
    assert out[0] == [(True, out[1][0], True, None)] and out[2] == []
    return out


def sc_vote_outvotes_corrupt_primary(trio):
    out = _vote(trio, 3, 0, [[11, 12], [13, 14]])
    assert out[0] == [(True, out[1][1], True, True)] and out[2] == [out[1][0]]
    return out


def sc_vote_quarantines_corrupt_shadow(trio):
    out = _vote(trio, 3, 1, [[15, 16], [17, 18]])
    assert out[0] == [(True, out[1][0], True, True)] and out[2] == [out[1][1]]
    return out


def sc_vote_unresolved_without_arbiter(trio):
    out = _vote(trio, 2, 1, [[19, 20], [21, 22]])
    assert out[2] == [out[1][1]] and out[3]["vote_unresolved"] == 1
    return out


def sc_vote_sampling_accumulates(trio):
    out = _vote(trio, 3, None, QS, rate=0.5, queries=4)
    assert out[3]["routed"] == 4 and out[3]["votes"] == 2
    return out


def sc_shed_when_all_owners_saturated(trio):
    pkg = trio["pkg"]
    servers, addresses, stuck = {}, {}, []
    for name in ("s0", "s1"):
        addresses[name] = f"unix:{trio['dir']}/{pkg.name}-{name}.sock"
        servers[name] = _start(pkg, addresses[name], {"default": trio["graph_path"]},
                               queue_capacity=1)
        servers[name].batcher.hold()
    try:
        def occupy(addr):
            try:
                with pkg.client.MsbfsClient(addr) as c:
                    c.query(QS)
            except pkg.client.ServerError:
                pass  # released at teardown; the outcome is not the point

        for addr in addresses.values():
            t = threading.Thread(target=occupy, args=(addr,))
            t.start()
            stuck.append(t)
        deadline = time.time() + 10
        while any(s.batcher.depth() < 1 for s in servers.values()) and time.time() < deadline:
            time.sleep(0.01)
        assert all(s.batcher.depth() == 1 for s in servers.values())
        r = pkg.router.FleetRouter(pkg.ring.PlacementRing(list(addresses), replication=2),
                                   addresses, {"default": trio["digest"]})
        return _failure(lambda: r.query(QS)), r.stats()
    finally:
        for srv in servers.values():
            srv.batcher.release()
        for t in stuck:
            t.join(timeout=30)
        for srv in servers.values():
            srv.stop()


def sc_sharded_query_equals_whole(trio):
    """The graph planned into three row-range shards with two copies each,
    every shard loaded on its shard-ring owners among the trio: the
    router's scatter gives the whole graph's answer."""
    pkg = trio["pkg"]
    cap = os.path.getsize(trio["graph_path"]) // 3
    plan = pkg.shards.plan_shards("big", trio["graph_path"],
                                  str(trio["dir"] / f"{pkg.name}-shards"), cap, replicas=2)
    sring = pkg.ring.PlacementRing(list(trio["addresses"]), replication=2)
    for s in plan.shards:
        for owner in sring.owners(s.digest):
            with pkg.client.MsbfsClient(trio["addresses"][owner], timeout=60) as c:
                c.load(s.path, graph=s.name)
    r = pkg.router.FleetRouter(pkg.ring.PlacementRing(list(trio["addresses"]), replication=2),
                               dict(trio["addresses"]), {"big": plan.digest}, timeout=60.0,
                               shard_plans={"big": plan}, shard_ring=sring)
    qsets = [QS, [[5, 6], [7, 8]], [[9, 10, 11]]]
    outs = [r.query(q, graph="big") for q in qsets]
    assert [answer(o) for o in outs] == [_direct(trio, "r0", q) for q in qsets]
    refused = _failure(lambda: r.query([[1], []], graph="big"))
    return ([(answer(o), o["rounds"], o["fragments"], o["shards"], o["degraded"])
             for o in outs], refused, r.stats())


SCENARIOS = {name[3:]: fn for name, fn in globals().items() if name.startswith("sc_")}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_router_scenarios_match_jax(trios, scenario):
    """The port's router over the port's trio against JAX's router over
    JAX's trio: the same answers, routing, typed failures and counters."""
    theirs = SCENARIOS[scenario](trios["jax"])
    mine = SCENARIOS[scenario](trios["port"])
    assert mine == theirs


# ---------------------------------------------------------------------------
# The front end, the metrics, the vote knob, the supervisor's planning
# ---------------------------------------------------------------------------


def test_jax_client_against_port_frontend(trios, tmp_path):
    """JAX's client speaks to the port's front end as to JAX's: the same
    answers, the same health keys and the same typed refusal of ``load``
    without a supervisor; the socket is reclaimed on stop."""
    got = {}
    for key in ("jax", "port"):
        trio = trios[key]
        r = _router(trio)
        listen = f"unix:{tmp_path}/{key}-front.sock"
        front = trio["pkg"].router.FleetFrontend(listen, r)
        front.start()
        try:
            with jclient.MsbfsClient(listen) as c:
                assert c.ping() is True
                health = c.health()
                out = c.query(QS)
                stats = c.stats()
                with pytest.raises(jclient.ServerError) as err:
                    c.load(trio["graph_path"])
            got[key] = (sorted(health), health["ready"], answer(out), out["replica"],
                        stats["router"], err.value.type_name)
        finally:
            front.stop()
        assert not os.path.exists(listen[len("unix:"):])
    assert got["port"] == got["jax"]
    assert got["port"][1] is True and got["port"][5] == "InputError"


def _samples(text):
    """name{labels} of every sample line, and the values of the router's
    counters."""
    keys, counters = set(), {}
    for line in text.splitlines():
        if line and not line.startswith("#"):
            key, value = line.rsplit(" ", 1)
            if not key.startswith("msbfs_engine_collective_bytes"):
                keys.add(key)
            if key.startswith("msbfs_fleet_") and key.endswith("_total"):
                counters[key] = value
    return keys, counters


def test_fleet_metrics_text_names_and_labels_match_jax(trios, monkeypatch):
    """On the same state (two replicas behind a front end with a stand-in
    supervisor, one query routed) the port's exposition has the JAX
    package's metric names, types and labels (but the collective-bytes
    gauge the port does not export) and the same router counters."""
    monkeypatch.setenv("MSBFS_RETRIES", "0")
    got = {}
    for key in ("jax", "port"):
        trio = trios[key]
        addresses = {m: trio["addresses"][m] for m in ("r0", "r1")}
        stub = SimpleNamespace(
            _lock=threading.Lock(),
            replicas=[SimpleNamespace(name=m, address=a, state="ready")
                      for m, a in addresses.items()],
            status=lambda: {"ready": True, "graphs": {}})
        pkg = trio["pkg"]
        r = pkg.router.FleetRouter(pkg.ring.PlacementRing(list(addresses), replication=2),
                                   addresses, {"default": trio["digest"]})
        front = pkg.router.FleetFrontend("unix:unused", r, supervisor=stub)
        assert front.handle({"op": "query", "graph": "default", "queries": [[9]]})["ok"]
        resp = front.handle({"op": "metrics"})
        assert resp["ok"], resp
        fams = telemetry.parse_prometheus(resp["text"])
        fams.pop("msbfs_engine_collective_bytes", None)
        got[key] = (fams, _samples(resp["text"]))
    assert got["port"][0] == got["jax"][0]
    assert got["port"][1] == got["jax"][1]
    assert got["port"][1][1]["msbfs_fleet_routed_total"] == "1"


def test_port_sharded_answer_reports_its_largest_fragments(trios, monkeypatch):
    """The port's sharded answer carries the most vertex ids one fragment
    frame carried each way (``largest_fragment_ids``), as the fragments
    the router sent and got back show."""
    trio = trios["port"]
    cap = os.path.getsize(trio["graph_path"]) // 3
    plan = shards.plan_shards("ids", trio["graph_path"], str(trio["dir"] / "port-ids-shards"),
                              cap, replicas=2)
    sring = ring.PlacementRing(list(trio["addresses"]), replication=2)
    for s in plan.shards:
        for owner in sring.owners(s.digest):
            with client.MsbfsClient(trio["addresses"][owner], timeout=60) as c:
                c.load(s.path, graph=s.name)
    r = router.FleetRouter(ring.PlacementRing(list(trio["addresses"]), replication=2),
                           dict(trio["addresses"]), {"ids": plan.digest}, timeout=60.0,
                           shard_plans={"ids": plan}, shard_ring=sring)
    seen = {"sent": [], "received": []}
    call = r._fragment_call

    def recorded(shard, rows, deadline):
        out = call(shard, rows, deadline)
        seen["sent"].append(sum(map(len, rows)))
        seen["received"].append(sum(map(len, out)))
        return out

    monkeypatch.setattr(r, "_fragment_call", recorded)
    out = r.query(QS, graph="ids")
    assert answer(out) == _direct(trio, "r0", QS)
    assert len(seen["sent"]) == out["fragments"] > 0
    assert out["largest_fragment_ids"] == {way: max(n) for way, n in seen.items()}


def test_port_daemon_metrics_report_its_card_memory(trios):
    """Each of the port's daemons exports what its caching allocator holds
    on the card, as gauges of its own metrics: 0 on the CPU."""
    for address in trios["port"]["addresses"].values():
        with client.MsbfsClient(address, timeout=60) as c:
            text = c.metrics()
        families = telemetry.parse_prometheus(text)
        values = dict(line.rsplit(" ", 1) for line in text.splitlines()
                      if line.startswith("msbfs_device_memory_"))
        for name in ("msbfs_device_memory_allocated_bytes",
                     "msbfs_device_memory_reserved_bytes"):
            assert families[name] == "gauge"
            assert float(values[name]) == 0.0


def test_merge_trace_events_and_vote_knob_match_jax(monkeypatch):
    rng = np.random.default_rng(5)
    local = [{"name": f"l{i}", "ts": int(t)} for i, t in enumerate(rng.integers(0, 99, 6))]
    remote = [[{"name": f"r{j}{i}", "ts": int(t)} for i, t in
               enumerate(rng.integers(0, 99, 4))] for j in range(3)] + ["junk", [7]]
    assert observe.merge_trace_events(local, remote) == \
        jobserve.merge_trace_events(local, remote)
    for raw in ("", "off", "0", "full", "on", "1", "0.25", "7", "-3", "bogus"):
        monkeypatch.setenv("MSBFS_VOTE", raw)
        assert router.vote_rate_from_env() == jrouter.vote_rate_from_env(), raw


def test_supervisor_plans_journals_and_resurrects_as_jax(tmp_path):
    """No replica process: register a graph above the shard cap on a
    four-slot supervisor of each package; the same shard topology, status
    and placement, and a new supervisor over the same directory resumes
    the plan from the manifest journal."""
    n, edges = generators.gnm_edges(200, 700, seed=3)
    gpath = str(tmp_path / "g.bin")
    io.save_graph_bin(gpath, n, edges)
    cap = os.path.getsize(gpath) // 3

    def norm(obj):
        if isinstance(obj, dict):
            return {k: norm(v) for k, v in obj.items() if k not in ("address", "pid")}
        if isinstance(obj, list):
            return [norm(v) for v in obj]
        return obj

    got = {}
    for pkg in (JAX, PORT):
        base = str(tmp_path / pkg.name)
        sup = pkg.fleet.FleetSupervisor(size=4, base_dir=base, replication=2,
                                        shard_max_bytes=cap, shard_replicas=2)
        owners = sup.register("big", gpath)
        sup2 = pkg.fleet.FleetSupervisor(size=4, base_dir=base, replication=2,
                                         shard_max_bytes=cap)
        plan2 = sup2.shard_plans["big"]
        got[pkg.name] = (owners, norm(sup.status()),
                         [(s.name, s.lo, s.hi, s.digest) for s in plan2.shards])
    assert got["port"] == got["jax"]
    assert len(got["port"][2]) >= 2


def test_replica_command_is_the_ports_serve(tmp_path):
    sup = fleet.FleetSupervisor(size=2, base_dir=str(tmp_path), device="cpu",
                                server_args=["--queue", "8"])
    for r in sup.replicas:
        cmd = sup.replica_command(r)
        assert cmd[:4] == [sys.executable, "-m", PKG, "serve"]
        assert cmd[cmd.index("--device") + 1] == "cpu"
        assert cmd[cmd.index("--listen") + 1] == r.address
        assert cmd[-2:] == ["--queue", "8"]
        assert not any(arg.endswith("main.py") for arg in cmd)
    assert fleet.FleetSupervisor(size=1, base_dir=str(tmp_path / "d")).device == "cuda"


# ---------------------------------------------------------------------------
# Real replica processes of the port, on the CPU
# ---------------------------------------------------------------------------


def _await(predicate, deadline_s, what):
    end = time.monotonic() + deadline_s
    while time.monotonic() < end:
        if predicate():
            return
        time.sleep(0.1)
    raise AssertionError(f"timed out waiting for {what}")


def _env():
    env = dict(os.environ)
    env.pop("MSBFS_FAULTS", None)
    return env


def _fleet(tmp_path, size, replication=2, **kw):
    return fleet.FleetSupervisor(
        size=size, base_dir=str(tmp_path / "fleet"), replication=replication,
        heartbeat_s=0.25, env=_env(), device="cpu",
        restart_policy=supervisor.RetryPolicy(max_retries=6, base_delay=0.2, max_delay=1.0,
                                              seed=0), **kw)


def test_fleet_processes_survive_replica_kill(tmp_path):
    """Two replica processes of the port (``--device cpu``): the spawned
    command is the port's ``serve``; ``replica_kill`` on the graph's
    primary while queries run; every acknowledged answer unchanged, the
    victim restarted and its journal replayed, the fleet metrics count
    the ready replicas; every wait bounded, the children killed."""
    n, edges = generators.gnm_edges(120, 360, seed=7)
    gpath = str(tmp_path / "g.bin")
    io.save_graph_bin(gpath, n, edges)
    sup = _fleet(tmp_path, 2)
    try:
        sup.start(wait_ready_s=120.0)
        for r in sup.replicas:
            with open(f"/proc/{r.pid}/cmdline", "rb") as f:
                argv = f.read().decode().split("\0")
            assert argv[1:4] == ["-m", PKG, "serve"] and "--device" in argv, argv
            assert not any(a.endswith("main.py") for a in argv)
        owners = sup.register("default", gpath)
        r = router.FleetRouter.for_fleet(sup, timeout=60.0)
        _await(lambda: set(owners) <= sup.ready_names(), 60.0, "owners ready")
        oracle = answer(r.query(QS, deadline_s=60.0))
        victim = sup.replicas[int(owners[0][1:])]
        faults.activate(faults.FaultPlan.parse(f"replica_kill:replica{victim.index}:1"))
        end = time.monotonic() + 60.0
        acked = 0
        while (victim.injected_kills < 1 or victim.restarts < 1
               or victim.state != "ready") and time.monotonic() < end:
            out = r.query(QS, deadline_s=10.0)
            assert answer(out) == oracle, "acked query lost or corrupted"
            acked += 1
        faults.activate(None)
        assert victim.injected_kills == 1 and victim.restarts >= 1
        assert victim.state == "ready" and acked > 0
        assert "default" in StateJournal(victim.journal_path).replay().graphs
        with client.MsbfsClient(victim.address, timeout=30.0) as c:
            assert "default" in c.health()["graphs"]
        assert answer(r.query(QS, deadline_s=30.0)) == oracle
        front = router.FleetFrontend("unix:unused", r, supervisor=sup)
        text = front.handle({"op": "metrics"})["text"]
        assert "msbfs_fleet_replicas_ready 2" in text
        assert r.stats()["shed"] == 0
    finally:
        faults.activate(None)
        sup.stop()
    assert all(x.pid is None and x.proc.poll() is not None for x in sup.replicas)


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a host without a card")
def test_replica_without_card_fails_and_never_serves(tmp_path):
    """A replica asked for the card where there is none exits non-zero;
    the supervisor shows it down, then failed, and never ready."""
    sup = fleet.FleetSupervisor(size=1, base_dir=str(tmp_path / "fleet"), heartbeat_s=0.1,
                                env=_env(), restart_policy=supervisor.RetryPolicy(
                                    max_retries=1, base_delay=0.1, max_delay=0.1, seed=0))
    try:
        sup.start()
        _await(lambda: sup.replicas[0].state == "failed", 60.0, "the replica to fail")
        assert sup.ready_names() == set()
        assert sup.replicas[0].last_exit not in (None, 0)
        assert sup.status()["replicas"][0]["state"] == "failed"
    finally:
        sup.stop()
    with open(sup.replicas[0].log_path, encoding="utf-8") as f:
        assert "no CUDA device" in f.read()


# ---------------------------------------------------------------------------
# JAX's heavier chaos chains, slow-marked as theirs are
# ---------------------------------------------------------------------------


def _oracle(tmp_path, gpath, qsets):
    srv = server.MsbfsServer(listen=f"unix:{tmp_path}/oracle.sock", graphs={"default": gpath},
                             window_s=0.0, request_timeout_s=60.0, device="cpu")
    srv.start()
    with client.MsbfsClient(f"unix:{tmp_path}/oracle.sock") as c:
        out = [answer(c.query(q)) for q in qsets]
    srv.stop()
    return out


def _graph_file(tmp_path):
    n, edges = generators.gnm_edges(120, 360, seed=7)
    gpath = str(tmp_path / "g.bin")
    io.save_graph_bin(gpath, n, edges)
    return gpath


@pytest.mark.slow
def test_fleet_chaos_kill_failover_restart(tmp_path):
    """``replica_kill`` mid-load on a three-replica fleet of the port:
    zero acked queries lost, failover inside the deadline while the victim
    is down, restart with journal replay, placement reconciled."""
    gpath = _graph_file(tmp_path)
    qsets = [QS, [[5, 6], [7, 8]], [[9, 10], [11, 12]]]
    oracle = _oracle(tmp_path, gpath, qsets)
    sup = _fleet(tmp_path, 3)
    try:
        sup.start(wait_ready_s=240.0)
        owners = sup.register("default", gpath)
        r = router.FleetRouter.for_fleet(sup, timeout=60.0)
        static = router.FleetRouter(sup.ring, {x.name: x.address for x in sup.replicas},
                                    sup.digests)
        _await(lambda: set(owners) <= set(sup.status()["graphs"]["default"]["live_owners"]),
               240.0, "owners live")
        for i, q in enumerate(qsets):
            assert answer(r.query(q, deadline_s=120.0)) == oracle[i]
        victim = sup.replicas[int(owners[0][1:])]
        faults.activate(faults.FaultPlan.parse(f"replica_kill:replica{victim.index}:1"))
        acked = 0
        end = time.monotonic() + 60.0
        while victim.injected_kills < 1 and time.monotonic() < end:
            out = r.query(qsets[acked % 3], deadline_s=10.0)
            assert answer(out) == oracle[acked % 3]
            acked += 1
        assert victim.injected_kills == 1 and acked > 0
        t0 = time.monotonic()
        out = static.query(qsets[0], deadline_s=5.0)
        assert time.monotonic() - t0 < 5.0 and answer(out) == oracle[0]
        _await(lambda: victim.restarts >= 1 and victim.state == "ready", 240.0, "restart")
        assert "default" in StateJournal(victim.journal_path).replay().graphs
        _await(lambda: set(owners) <= set(sup.status()["graphs"]["default"]["live_owners"]),
               240.0, "owners live again")
        for i, q in enumerate(qsets):
            assert answer(r.query(q, deadline_s=30.0)) == oracle[i]
        assert r.stats()["shed"] == 0
    finally:
        faults.activate(None)
        sup.stop()


@pytest.mark.slow
def test_fleet_chaos_bitflip_vote_quarantine_recompute(tmp_path):
    """``bitflip:dist`` inside the primary replica process: the vote
    outvotes it, the replica is quarantined and restarted from its
    journal, every acked answer equals the single daemon's."""
    gpath = _graph_file(tmp_path)
    oracle = _oracle(tmp_path, gpath, [QS])[0]
    victim_name = ring.PlacementRing(["r0", "r1", "r2"], replication=3).owners(
        content_hash(gpath))[0]
    vi = int(victim_name[1:])
    sup = _fleet(tmp_path, 3, replication=3, replica_faults={vi: "bitflip:dist:1"})
    try:
        sup.start(wait_ready_s=240.0)
        owners = sup.register("default", gpath)
        assert owners[0] == victim_name
        r = router.FleetRouter.for_fleet(sup, timeout=60.0, vote_rate=1.0)
        _await(lambda: set(owners) <= sup.ready_names(), 240.0, "owners ready")
        out = r.query(QS, deadline_s=180.0)
        assert answer(out) == oracle and out["vote_mismatch"] is True
        assert out["replica"] != victim_name
        assert sup.replicas[vi].quarantines >= 1
        _await(lambda: sup.replicas[vi].restarts >= 1 and sup.replicas[vi].state == "ready",
               240.0, "victim restart")
        assert "default" in StateJournal(sup.replicas[vi].journal_path).replay().graphs
        for _ in range(5):
            assert answer(r.query(QS, deadline_s=60.0)) == oracle
        assert r.stats()["shed"] == 0
    finally:
        faults.activate(None)
        sup.stop()


@pytest.mark.slow
def test_fleet_chaos_audit_catches_before_vote(tmp_path):
    """The same flip under ``MSBFS_AUDIT=full`` on the victim: its own
    audit catches and retries it, the vote agrees, nobody is quarantined."""
    gpath = _graph_file(tmp_path)
    oracle = _oracle(tmp_path, gpath, [QS])[0]
    victim_name = ring.PlacementRing(["r0", "r1", "r2"], replication=3).owners(
        content_hash(gpath))[0]
    vi = int(victim_name[1:])
    sup = _fleet(tmp_path, 3, replication=3, replica_faults={vi: "bitflip:dist:1"},
                 replica_env={vi: {"MSBFS_AUDIT": "full"}})
    try:
        sup.start(wait_ready_s=240.0)
        owners = sup.register("default", gpath)
        r = router.FleetRouter.for_fleet(sup, timeout=60.0, vote_rate=1.0)
        _await(lambda: set(owners) <= sup.ready_names(), 240.0, "owners ready")
        out = r.query(QS, deadline_s=180.0)
        assert answer(out) == oracle
        assert out["voted"] is True and "vote_mismatch" not in out
        assert r.stats()["quarantined"] == 0 and sup.replicas[vi].quarantines == 0
        with client.MsbfsClient(sup.replicas[vi].address, timeout=60.0) as c:
            vstats = c.stats()
        assert vstats["audit_failures"] >= 1 and vstats["audited"] >= 2
    finally:
        faults.activate(None)
        sup.stop()

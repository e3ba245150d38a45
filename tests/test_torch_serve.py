"""The port's serving daemon (serve/) against the JAX package's, on the
CPU: one JAX daemon and one port daemon, module-scoped, over the same
small graph files.  Frames are byte-equal with crc on and off; a JAX
client queries the port daemon and a port client the JAX daemon with the
same F, winner and error bodies; four concurrent requests coalesce into
one dispatch; a reload invalidates the result cache; a full queue and an
injected fault fail typed; quarantine isolates a poisoned row; a journal
written by one package replays in the other; ``mutate``/``versions`` give
the same digest chain and the same repaired answers; and a re-warm run
concurrently with queries on one entry keeps JAX's answers.
"""

import socket
import threading
import time

import numpy as np
import pytest

from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu.serve import (
    client as jclient,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu.serve import (
    protocol as jprotocol,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu.serve import (
    server as jserver,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu.utils import (
    faults as jfaults,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.models import (
    generators,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.ops import (
    certify,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.serve import (
    client as pclient,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.serve import (
    protocol as pprotocol,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.serve import (
    server as pserver,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.utils import (
    faults,
    io,
    telemetry,
)

# Response fields that depend on the process, the clock or the daemon's
# history (which earlier request warmed or cached what), not on the answer.
VOLATILE = ("latency_ms", "compiled", "cached", "batched_with", "pid",
            "loaded_at", "uptime_s", "hedged", "trace_id")


def _strip(obj):
    if isinstance(obj, dict):
        return {k: _strip(v) for k, v in obj.items() if k not in VOLATILE}
    if isinstance(obj, list):
        return [_strip(v) for v in obj]
    return obj


def _queries(n, k, s, seed):
    rng = np.random.default_rng(seed)
    return [[int(v) for v in rng.integers(0, n, size=s)] for _ in range(k)]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_serve")
    out = {"dir": d}
    n, edges = generators.gnm_edges(120, 360, seed=5)
    out["default"] = (n, edges, str(d / "g1.bin"))
    io.save_graph_bin(out["default"][2], n, edges)
    n2, edges2 = generators.gnm_edges(120, 360, seed=6)
    out["other"] = (n2, edges2, str(d / "g2.bin"))
    io.save_graph_bin(out["other"][2], n2, edges2)
    w = generators.edge_costs(edges.shape[0], "uniform", 9, seed=5)
    out["w"] = (n, edges, str(d / "w.bin"))
    io.save_graph_bin(out["w"][2], n, edges, w)
    return out


@pytest.fixture(scope="module")
def daemons(files):
    """(JAX daemon, its address, port daemon, its address): queue of 4,
    no coalescing window (tests hold the batcher), no retries, planes
    always retained as repair seeds."""
    d = files["dir"]
    graphs = {"default": files["default"][2], "w": files["w"][2]}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MSBFS_RETRIES", "0")
        mp.setenv("MSBFS_SERVE_PLANES", "1")
        mp.delenv("MSBFS_FAULTS", raising=False)
        kw = dict(graphs=graphs, queue_capacity=4, window_s=0.0, request_timeout_s=60.0)
        jsrv = jserver.MsbfsServer(listen=f"unix:{d}/j.sock", **kw)
        psrv = pserver.MsbfsServer(listen=f"unix:{d}/p.sock", device="cpu", **kw)
        jsrv.start()
        psrv.start()
        try:
            yield jsrv, f"unix:{d}/j.sock", psrv, f"unix:{d}/p.sock"
        finally:
            faults.activate(None)
            jfaults.activate(None)
            psrv.stop()
            jsrv.stop()


@pytest.fixture(autouse=True)
def _no_fault_plan_left():
    """No test leaves a fault plan of either package installed."""
    yield
    faults.activate(None)
    jfaults.activate(None)


# ---------------------------------------------------------------------------
# Frames
# ---------------------------------------------------------------------------

BODIES = [
    {"op": "ping"},
    {"op": "query", "graph": "default", "queries": [[1, 2], [3]], "deadline_s": 2.5},
    {"ok": False, "error": {"type": "InputError", "message": "ünïcode ✓", "exit_code": 1}},
    {"op": "mutate", "inserts": [[0, 1]], "deletes": [], "token": "t" * 32, "epoch": 3},
]


@pytest.mark.parametrize("crc", ["on", "off", "knob_legacy", "knob_default"])
@pytest.mark.parametrize("body", range(len(BODIES)))
def test_frames_byte_equal(crc, body, monkeypatch):
    obj = BODIES[body]
    if crc.startswith("knob"):
        if crc == "knob_legacy":
            monkeypatch.setenv("MSBFS_WIRE_CRC", "legacy")
        else:
            monkeypatch.delenv("MSBFS_WIRE_CRC", raising=False)
        mine, theirs = pprotocol.encode_frame(obj), jprotocol.encode_frame(obj)
    else:
        mine = pprotocol.encode_frame(obj, crc=crc == "on")
        theirs = jprotocol.encode_frame(obj, crc=crc == "on")
    assert mine == theirs
    # Each package reads the other's frame back.
    for send, recv in ((pprotocol, jprotocol), (jprotocol, pprotocol)):
        a, b = socket.socketpair()
        with a, b:
            a.settimeout(5)
            b.settimeout(5)
            a.sendall(mine)
            assert recv.recv_frame(b) == obj


def test_corrupt_frame_caught_by_either_package():
    """A wire-tainted frame (one body bit flipped after the crc) fails the
    receiver's check typed in both packages."""
    for send, recv in ((pprotocol, jprotocol), (jprotocol, pprotocol)):
        fmod = faults if send is pprotocol else jfaults
        a, b = socket.socketpair()
        with a, b:
            a.settimeout(5)
            b.settimeout(5)
            fmod.arm_wire_corruption()
            send.send_frame(a, {"op": "query", "queries": [[1, 2, 3]]})
            with pytest.raises(recv.FrameCorruptError, match="crc32 mismatch"):
                recv.recv_frame(b)


@pytest.mark.parametrize("k,w,failed", [(10, 3, ()), (7, 4, (1,)), (16, 4, (0, 3)), (1, 2, (1,))])
def test_scheduler_helpers_match_jax(k, w, failed):
    """The scheduler's NumPy helpers and the batcher's packing step give
    the JAX package's layouts."""
    import torch

    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu.parallel import (
        scheduler as jsched,
    )
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.parallel import (
        scheduler,
    )

    assert scheduler.cyclic_assignment(k, w) == jsched.cyclic_assignment(k, w)
    assert scheduler.reassign(k, w, failed) == jsched.reassign(k, w, failed)
    q = np.arange(k * 3, dtype=np.int32).reshape(k, 3)
    for mine, theirs in zip(scheduler.cyclic_grid(q, w, 2), jsched.cyclic_grid(q, w, 2)):
        assert np.array_equal(mine, theirs)
    grid, kk, k_pad, chunk = scheduler.shard_queries(q, w, None, torch.device("cpu"))
    assert np.array_equal(grid.numpy(), jsched.cyclic_grid(q, w, chunk)[0])
    assert (kk, k_pad) == (k, w * grid.shape[1])
    blocks = [q[: min(k, 2), :2], q[:1]]
    rows = sum(b.shape[0] for b in blocks)
    for mine, theirs in zip(scheduler.pack_padded_requests(blocks, rows + 1, 4),
                            jsched.pack_padded_requests(blocks, rows + 1, 4)):
        assert np.array_equal(mine, theirs)
    for bad in ((blocks, rows - 1, 4), (blocks, rows, 1)):
        with pytest.raises(ValueError) as mine:
            scheduler.pack_padded_requests(*bad)
        with pytest.raises(ValueError) as theirs:
            jsched.pack_padded_requests(*bad)
        assert str(mine.value) == str(theirs.value)


# ---------------------------------------------------------------------------
# Cross-package clients and daemons
# ---------------------------------------------------------------------------

REQUESTS = {
    "unit": {"op": "query", "graph": "default", "queries": [[3, 7], [11], [40, 41, 42]]},
    "weighted": {"op": "query", "graph": "w", "queries": [[5], [17, 90]], "weighted": True},
    "wide": {"op": "query", "graph": "default", "queries": _queries(120, 9, 5, 1)},
    "unreached": {"op": "query", "graph": "default", "queries": [[500], [2]]},
    "versions": {"op": "versions", "graph": "default"},
    "shard_step": {"op": "shard_step", "graph": "default", "rows": [0, 60],
                   "frontier": [[1, 2, 3], [], [59]]},
    "unknown_op": {"op": "nope"},
    "no_queries": {"op": "query", "graph": "default"},
    "empty_group": {"op": "query", "graph": "default", "queries": [[]]},
    "ghost_graph": {"op": "query", "graph": "ghost", "queries": [[1]]},
    "bad_priority": {"op": "query", "graph": "default", "queries": [[1]], "priority": "vip"},
    "weightless": {"op": "query", "graph": "default", "queries": [[1]], "weighted": True},
    "load_no_path": {"op": "load"},
    "bad_mutate": {"op": "mutate", "graph": "default", "inserts": [[1]]},
    "bad_shard_rows": {"op": "shard_step", "graph": "default", "rows": [0, 999],
                       "frontier": [[1]]},
}


def _raw(addr, request, protocol):
    """One request frame over ``protocol``'s send/recv, the raw response."""
    family, target = protocol.parse_address(addr)
    with socket.socket(family, socket.SOCK_STREAM) as sock:
        sock.settimeout(60)
        sock.connect(target)
        protocol.send_frame(sock, request)
        return protocol.recv_frame(sock)


@pytest.mark.parametrize("case", sorted(REQUESTS))
def test_clients_cross_daemons(daemons, case):
    """The same request through the JAX client to the port daemon, the port
    client to the JAX daemon, and JAX to JAX: the same body."""
    _, jaddr, _, paddr = daemons
    req = REQUESTS[case]
    reference = _raw(jaddr, dict(req), jprotocol)
    jax_to_port = _raw(paddr, dict(req), jprotocol)
    port_to_jax = _raw(jaddr, dict(req), pprotocol)
    assert _strip(jax_to_port) == _strip(reference) == _strip(port_to_jax)
    if req["op"] == "query" and reference["ok"]:
        # The clients themselves, crossed.
        with jclient.MsbfsClient(paddr, timeout=60) as jc, \
                pclient.MsbfsClient(jaddr, timeout=60) as pc:
            kw = dict(graph=req["graph"], weighted=req.get("weighted", False))
            a = jc.query(req["queries"], **kw)
            b = pc.query(req["queries"], **kw)
        assert _strip(a) == _strip(b) == _strip(reference)
        assert a["min_k"] == int(np.argmin(np.where(
            np.array(a["f_values"]) >= 0, a["f_values"], np.iinfo(np.int64).max)))


def test_health_stats_metrics_and_trace(daemons):
    """The read-only verbs: the same health keys, a parseable metrics
    exposition, and a traced query's spans in the port daemon's store."""
    _, jaddr, psrv, paddr = daemons
    with jclient.MsbfsClient(jaddr, timeout=60) as jc, \
            pclient.MsbfsClient(paddr, timeout=60) as pc:
        jh, ph = jc.health(), pc.health()
        assert sorted(jh) == sorted(ph)
        assert ph["ready"] and ph["graphs"] == jh["graphs"] == ["default", "w"]
        assert sorted(jc.stats()) == sorted(pc.stats())
        families = telemetry.parse_prometheus(pc.metrics())
        assert families["msbfs_requests_total"] == "counter"
        ctx = telemetry.new_trace()
        with telemetry.use_trace(ctx):
            pc.query([[9, 10]], graph="default")
        out = pc.trace(ctx.trace_id)
    names = {e["name"] for e in out["events"]}
    assert {"client.query", "serve.query"} <= names
    assert out["trace_id"] == ctx.trace_id


@pytest.mark.parametrize("sub", ["query", "health", "versions", "stats"])
def test_cli_subcommands_against_both_daemons(daemons, files, tmp_path, capsys, sub):
    """``query``/``health`` through each package's ``cli.main``, the port's
    against the port daemon and JAX's against the JAX daemon: the same exit
    code, and the same stdout where it carries the answer."""
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu import cli as jcli
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch import cli

    _, jaddr, _, paddr = daemons
    qpath = str(tmp_path / "q.bin")
    io.save_query_bin(qpath, [np.array(g) for g in _queries(120, 5, 3, 31)])
    extra = {"query": ["-q", qpath], "health": [], "versions": ["--versions"],
             "stats": ["--stats"]}[sub]
    verb = "health" if sub == "health" else "query"
    rc_p = cli.main(["prog", verb, "--connect", paddr] + extra, device="cpu")
    port = capsys.readouterr()
    rc_j = jcli.main(["prog", verb, "--connect", jaddr] + extra)
    jax_out = capsys.readouterr()
    assert rc_p == rc_j == 0
    if sub in ("query", "versions"):
        assert port.out == jax_out.out and port.out
    elif sub == "stats":
        assert port.out.splitlines()[1:3] == jax_out.out.splitlines()[1:3]
    else:
        # "pid P; ready; G graph(s), B warm bucket(s); queue depth D"
        p_parts, j_parts = port.err.split("; "), jax_out.err.split("; ")
        assert p_parts[1] == j_parts[1] == "ready"
        assert p_parts[2].split(",")[0] == j_parts[2].split(",")[0]


# ---------------------------------------------------------------------------
# Batching, caches, backpressure, faults, quarantine
# ---------------------------------------------------------------------------


def _held(srv, addr, client_mod, batches, **kw):
    """Submit ``batches`` concurrently while ``srv``'s batcher is held;
    release once all are queued.  Returns one (response | error) each."""
    srv.batcher.hold()
    out = [None] * len(batches)

    def go(i):
        try:
            with client_mod.MsbfsClient(addr, timeout=60) as c:
                out[i] = c.query(batches[i], **kw)
        except client_mod.ServerError as err:
            out[i] = (err.type_name, err.exit_code, str(err))

    threads = [threading.Thread(target=go, args=(i,)) for i in range(len(batches))]
    try:
        # One at a time into the queue, so its order (and so a bisection's
        # halves) is the list's order on both daemons.
        for i, t in enumerate(threads):
            t.start()
            deadline = time.time() + 30
            while srv.batcher.depth() <= i and time.time() < deadline:
                time.sleep(0.005)
            assert srv.batcher.depth() == i + 1
    finally:
        srv.batcher.release()
    for t in threads:
        t.join(60)
        assert not t.is_alive()
    return out


def test_four_concurrent_requests_one_dispatch(daemons):
    jsrv, jaddr, psrv, paddr = daemons
    batches = [[q] for q in _queries(120, 4, 2, 7)]
    answers = {}
    for srv, addr, mod in ((jsrv, jaddr, jclient), (psrv, paddr, pclient)):
        before = srv.stats()["queue"]
        answers[mod] = _held(srv, addr, mod, batches)
        after = srv.stats()["queue"]
        assert after["batches"] - before["batches"] == 1
        assert after["coalesced"] - before["coalesced"] == 3
        for r in answers[mod]:
            assert r["batched_with"] == 3 and r["bucket"] == [4, 2]
    assert [_strip(r) for r in answers[pclient]] == [_strip(r) for r in answers[jclient]]


def test_result_cache_invalidated_on_reload(daemons, files, tmp_path):
    """Query, repeat (a cache hit), overwrite the file, reload: the next
    answer is computed afresh on the new content, as on the JAX daemon."""
    _, jaddr, _, paddr = daemons
    (n, edges, _), (n2, edges2, _) = files["default"], files["other"]
    q = _queries(min(n, n2), 2, 2, 4)
    seen = []
    for tag, addr, mod in (("j", jaddr, jclient), ("p", paddr, pclient)):
        path = str(tmp_path / f"mut_{tag}.bin")
        io.save_graph_bin(path, n, edges)
        with mod.MsbfsClient(addr, timeout=60) as c:
            c.load(path, graph="mut")
            r1 = c.query(q, graph="mut")
            assert c.query(q, graph="mut")["cached"]
            io.save_graph_bin(path, n2, edges2)
            info = c.reload(graph="mut")
            r2 = c.query(q, graph="mut")
        assert info["graph"]["version"] == 2 and info["invalidated_results"] >= 1
        assert not r2["cached"] and r2["version"] == 2 and r1["version"] == 1
        seen.append((_strip(r1), _strip(r2), info["invalidated_results"]))
    assert seen[0] == seen[1]


def test_backpressure_and_injected_fault_fail_typed(daemons):
    """A full queue rejects typed (exit 7); an injected transient dispatch
    fault fails its request typed (exit 5) and the daemon answers the next
    one: the same error bodies from both daemons."""
    jsrv, jaddr, psrv, paddr = daemons
    got = []
    for srv, addr, mod, fmod in ((jsrv, jaddr, jclient, jfaults),
                                 (psrv, paddr, pclient, faults)):
        srv.batcher.hold()
        try:
            held = [threading.Thread(target=lambda: _raw(addr, {
                "op": "query", "graph": "default", "queries": [[1, 2]]}, jprotocol))
                for _ in range(4)]
            for t in held:
                t.start()
            deadline = time.time() + 30
            while srv.batcher.depth() < 4 and time.time() < deadline:
                time.sleep(0.01)
            full = _raw(addr, {"op": "query", "graph": "default",
                               "queries": [[5, 6]]}, jprotocol)
        finally:
            srv.batcher.release()
        for t in held:
            t.join(60)
        fmod.activate(fmod.FaultPlan.parse("transient:dispatch:1"))
        try:
            fault = _raw(addr, {"op": "query", "graph": "default",
                                "queries": [[8], [9]]}, jprotocol)
        finally:
            fmod.activate(None)
        after = _raw(addr, {"op": "query", "graph": "default",
                            "queries": [[8], [9]]}, jprotocol)
        assert after["ok"]
        got.append((full, fault, _strip(after)))
    assert got[0] == got[1]
    full, fault, _ = got[1]
    assert full["error"]["type"] == "BackpressureError" and full["error"]["exit_code"] == 7
    assert fault["error"]["type"] == "TransientError" and fault["error"]["exit_code"] == 5


def test_quarantine_isolates_poisoned_row(daemons):
    """A batch holding a poisoned vertex is bisected: only its request
    fails (PoisonQueryError, exit 8), its batchmates get clean answers."""
    jsrv, jaddr, psrv, paddr = daemons
    batches = [[[10, 11]], [[20, 21]], [[30, 77]], [[40, 41]]]
    got = []
    for srv, addr, mod, fmod in ((jsrv, jaddr, jclient, jfaults),
                                 (psrv, paddr, pclient, faults)):
        fmod.activate(fmod.FaultPlan.parse("poison:vertex77:1"))
        try:
            out = _held(srv, addr, mod, batches)
        finally:
            fmod.activate(None)
        got.append([r if isinstance(r, tuple) else _strip(r) for r in out])
    assert got[0] == got[1]
    assert got[1][2][:2] == ("PoisonQueryError", 8)
    assert all(isinstance(r, dict) and r["ok"] for i, r in enumerate(got[1]) if i != 2)


# ---------------------------------------------------------------------------
# The journal across packages
# ---------------------------------------------------------------------------

PACKAGES = {"jax": (jserver, jclient, {}), "port": (pserver, pclient, {"device": "cpu"})}


def _wait_ready(client):
    deadline = time.time() + 60
    while not client.health()["ready"]:
        assert time.time() < deadline
        time.sleep(0.05)


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_journal_written_by_one_package_replays_in_the_other(files, tmp_path, writer, reader):
    """Load, a warm bucket and a tokened mutate, journaled by one package's
    daemon; the other's daemon replays them: ready, the same version chain,
    the same answer, and the token's retry deduplicated."""
    path = files["default"][2]
    journal = str(tmp_path / "state.jsonl")
    q = [[1, 2], [50]]
    answers = []
    for i, pkg in enumerate((writer, reader)):
        smod, cmod, kw = PACKAGES[pkg]
        sock = f"unix:{tmp_path}/{pkg}{i}.sock"
        srv = smod.MsbfsServer(listen=sock, graphs={} if i else {"default": path},
                               journal_path=journal, window_s=0.0, **kw)
        srv.start()
        try:
            with cmod.MsbfsClient(sock, timeout=60) as c:
                _wait_ready(c)
                if i == 0:
                    c.query(q)
                    m = c.mutate(inserts=[[0, 119], [3, 4]], deletes=[], token="tok-1")
                    assert not m["deduplicated"]
                else:
                    m = c.mutate(inserts=[[0, 119], [3, 4]], deletes=[], token="tok-1")
                    assert m["deduplicated"]
                    assert srv.stats()["compiles"], "the journaled warm re-ran"
                r = _strip(c.query(q))
                # Whether the writer repaired off a retained plane or
                # dispatched is its own history; the answer is the same.
                r.pop("repaired", None)
                r.pop("dynamic", None)
                answers.append((_strip(c.versions()), r))
        finally:
            srv.stop()
    assert answers[0] == answers[1]
    assert answers[1][0]["delta_version"] == 1


# ---------------------------------------------------------------------------
# mutate / versions and the repaired answer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("weighted", [False, True], ids=["unit", "weighted"])
def test_mutate_versions_and_repair_match_jax(daemons, tmp_path, weighted):
    """A road grid on both daemons: query (the plane is retained), three
    seeded mutations, query after each — repaired on the host, the same
    digest chain, and F equal to the JAX daemon's and to a cold reference
    sweep of the mutated graph."""
    _, jaddr, _, paddr = daemons
    n, edges = generators.road_edges(12, 12, seed=9)
    w = generators.edge_costs(edges.shape[0], "uniform", 7, seed=9) if weighted else None
    path = str(tmp_path / "road.bin")
    io.save_graph_bin(path, n, edges, w)
    name = f"road-{'w' if weighted else 'u'}"
    q = [[0, 77], [130], [5, 6, 140]]
    deltas = generators.delta_batches(n, edges, batches=3, batch_size=6,
                                      locality=0.8, seed=11)
    runs = []
    for addr, mod in ((jaddr, jclient), (paddr, pclient)):
        rows = []
        with mod.MsbfsClient(addr, timeout=60) as c:
            c.load(path, graph=name)
            c.query(q, graph=name, weighted=weighted)
            for ins, dels in deltas:
                m = c.mutate(inserts=ins.tolist(), deletes=dels.tolist(), graph=name)
                r = c.query(q, graph=name, weighted=weighted)
                rows.append((m["version"], m["digest"], _strip(r)))
            chain = c.versions(graph=name)
        runs.append((rows, _strip(chain)))
    assert runs[0] == runs[1]
    rows, chain = runs[1]
    assert [v for v, _, _ in rows] == [1, 2, 3]
    assert [r["digest"] for r in chain["chain"][1:]] == [d for _, d, _ in rows]
    assert all(r["repaired"] for _, _, r in rows)
    # Cold recompute of the final version.
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.dynamic import (
        DeltaLog,
    )

    graph = io.load_graph_bin(path)
    log = DeltaLog.from_graph(graph, chain["chain"][0]["digest"])
    for ins, dels in deltas:
        log.append(ins, dels)
    final, _ = log.apply()
    padded = np.full((len(q), 4), -1, dtype=np.int32)
    for i, g in enumerate(q):
        padded[i, : len(g)] = g
    if weighted:
        dist = certify.reference_weighted_distances(
            final.row_offsets, final.col_indices, final.edge_weights, padded)
    else:
        dist = certify.reference_distances(final.row_offsets, final.col_indices, padded)
    assert rows[-1][2]["f_values"] == [int(x) for x in certify.f_from_distances(dist)]


# ---------------------------------------------------------------------------
# One engine call at a time per entry
# ---------------------------------------------------------------------------


def test_rewarm_concurrent_with_queries_keeps_answers(daemons, files, tmp_path):
    """A thread re-warms the entry's buckets (the journal replay's warm
    path, ``_warm_bucket``) over and over while queries run on the same
    entry: every answer equals the JAX daemon's."""
    _, jaddr, _, _ = daemons
    sock = f"unix:{tmp_path}/rewarm.sock"
    srv = pserver.MsbfsServer(listen=sock, graphs={"default": files["default"][2]},
                              window_s=0.0, device="cpu")
    srv.start()
    stop = threading.Event()
    entry = srv.registry.get("default")

    def rewarm():
        while not stop.is_set():
            srv.executables.drop_where(lambda k: True)
            for k in (1, 2, 4, 8):
                srv._warm_bucket(entry, k, 2)

    batches = [_queries(120, k, 2, 20 + k) for k in (1, 2, 3, 4, 6, 8)]
    warm = threading.Thread(target=rewarm, daemon=True)
    try:
        warm.start()
        with pclient.MsbfsClient(sock, timeout=60) as pc, \
                jclient.MsbfsClient(jaddr, timeout=60) as jc:
            for qs in batches:
                assert _strip(pc.query(qs)) == _strip(jc.query(qs))
    finally:
        stop.set()
        warm.join(60)
        srv.stop()
    assert not warm.is_alive()

"""The fleet's pure host policies in the port (serve/ring.py,
serve/shards.py, serve/autoscale.py, serve/brownout.py) against the JAX
package's, on the CPU: the same owners and preference lists for the same
members, weights, hosts and digests (and the same minimal movement when a
member leaves), byte-equal shard artifacts and equal manifests from the
same file, the same scatter and OR-merge, the same typed refusals and
disk-full outcome, and the same autoscaler and brownout decisions and
journal lines on the same signal sequences.  Inputs are made from seeds
with numpy."""

import os

import numpy as np
import pytest

from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu.parallel import (
    partition2d as jpartition2d,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu.runtime import (
    supervisor as jsupervisor,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu.serve import (
    autoscale as jautoscale,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu.serve import (
    brownout as jbrownout,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu.serve import (
    ring as jring,
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
    autoscale,
    brownout,
    ring,
    shards,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.utils import (
    faults,
    io,
)


@pytest.fixture(autouse=True)
def _no_fault_plan_left():
    """No test leaves a fault plan of either package installed."""
    yield
    faults.activate(None)
    jfaults.activate(None)


def _digests(seed, count=24):
    rng = np.random.default_rng(seed)
    return [bytes(rng.integers(0, 256, size=6, dtype=np.uint8)).hex() for _ in range(count)]


# ---------------------------------------------------------------------------
# Placement ring
# ---------------------------------------------------------------------------

RINGS = {
    "three": dict(members=3, replication=2),
    "five_r3": dict(members=5, replication=3),
    "clamped": dict(members=2, replication=4),
    "weighted": dict(members=4, replication=2, weights={"r1": 2.0, "r3": 0.5}),
    "hosts": dict(members=5, replication=2, hosts=["hostA", "hostB"]),
    "hosts_short": dict(members=4, replication=3, hosts=["hostA", "hostB"]),
    "weighted_hosts": dict(members=6, replication=3, weights={"r0": 3.0},
                           hosts=["a", "b", "c"]),
}


def _ring_pair(spec):
    members = [f"r{i}" for i in range(spec["members"])]
    hosts = {m: spec["hosts"][i % len(spec["hosts"])] for i, m in enumerate(members)} \
        if "hosts" in spec else None
    kw = dict(replication=spec["replication"], weights=spec.get("weights"), hosts=hosts)
    return ring.PlacementRing(members, **kw), jring.PlacementRing(members, **kw)


@pytest.mark.parametrize("seed", [1, 2])
@pytest.mark.parametrize("case", sorted(RINGS))
def test_ring_owners_and_preference_match_jax(case, seed):
    mine, theirs = _ring_pair(RINGS[case])
    assert mine.replication == theirs.replication
    rng = np.random.default_rng(seed)
    for d in _digests(seed):
        assert mine.preference(d) == theirs.preference(d)
        assert mine.owners(d) == theirs.owners(d)
        alive = [m for m in mine.members if rng.random() < 0.7]
        assert mine.owners(d, alive=alive) == theirs.owners(d, alive=alive)
        for m in mine.members:
            assert ring._score(d, m) == jring._score(d, m)
            assert ring._weighted_key(d, m, 1.5) == jring._weighted_key(d, m, 1.5)
    assert mine.describe(_digests(seed, 4)) == theirs.describe(_digests(seed, 4))


@pytest.mark.parametrize("case", ["three", "five_r3", "weighted", "hosts"])
def test_ring_minimal_movement_on_loss_and_join_matches_jax(case):
    """A member leaves: only the keys it owned move, each to the same new
    owner in both packages; a newcomer steals only keys it now wins."""
    mine, theirs = _ring_pair(RINGS[case])
    digests = _digests(11, 48)
    before = {d: mine.owners(d) for d in digests}
    for r in (mine, theirs):
        r.remove_member("r1")
    assert mine.epoch == theirs.epoch == 1
    for d in digests:
        after = mine.owners(d)
        assert after == theirs.owners(d)
        if "r1" not in before[d]:
            assert after == before[d]
        else:
            assert set(before[d]) - {"r1"} <= set(after)
    for r in (mine, theirs):
        r.add_member("r9", weight=1.0)
    for d in digests:
        assert mine.owners(d) == theirs.owners(d)


def test_ring_refusals_match_jax():
    for args, kw in (
        ([], {}),
        (["a", "a"], {}),
        (["a"], {"replication": 0}),
        (["a", "b"], {"weights": {"a": -1.0}}),
    ):
        with pytest.raises(ValueError) as mine:
            ring.PlacementRing(args, **kw)
        with pytest.raises(ValueError) as theirs:
            jring.PlacementRing(args, **kw)
        assert str(mine.value) == str(theirs.value)


# ---------------------------------------------------------------------------
# Shard planner
# ---------------------------------------------------------------------------

GRAPHS = {
    "gnm": lambda: generators.gnm_edges(200, 700, seed=3),
    "rmat": lambda: generators.rmat_edges(9, edge_factor=8, seed=4),
    "tiny": lambda: generators.gnm_edges(3, 3, seed=5),
}


def _graph(tmp_path, case):
    n, edges = GRAPHS[case]()
    path = str(tmp_path / f"{case}.bin")
    io.save_graph_bin(path, n, edges)
    return path


def _manifest(plan):
    rec = plan.to_record()
    for row in rec["shards"]:
        row["path"] = os.path.basename(row["path"])
    return rec


@pytest.mark.parametrize("replicas", [1, 2])
@pytest.mark.parametrize("parts", [2, 3, 5])
@pytest.mark.parametrize("case", ["gnm", "rmat"])
def test_plan_shards_artifacts_byte_equal_to_jax(tmp_path, case, parts, replicas):
    path = _graph(tmp_path, case)
    cap = os.path.getsize(path) // parts
    mine = shards.plan_shards("g", path, str(tmp_path / "mine"), cap, replicas=replicas)
    theirs = jshards.plan_shards("g", path, str(tmp_path / "jax"), cap, replicas=replicas)
    assert mine is not None and theirs is not None
    assert _manifest(mine) == _manifest(theirs)
    assert [s.records for s in mine.shards] == [s.records for s in theirs.shards]
    for a, b in zip(mine.shards, theirs.shards):
        with open(a.path, "rb") as fa, open(b.path, "rb") as fb:
            assert fa.read() == fb.read(), a.name
    # The manifest round trip rebuilds the same plan in either package.
    back = shards.ShardPlan.from_manifest("g", mine.to_record())
    jback = jshards.ShardPlan.from_manifest("g", mine.to_record())
    assert back.describe() == jback.describe()
    for row in range(0, back.n, max(1, back.n // 7)):
        assert back.shard_for_row(row).name == jback.shard_for_row(row).name


@pytest.mark.parametrize("case", ["gnm", "tiny"])
def test_plan_shards_whole_and_refusals_match_jax(tmp_path, case):
    """Disabled or under the cap: serve whole (None); a three-vertex
    graph's degenerate split: the same plan; a reserved name, bad
    replicas, weights: the same typed refusal."""
    path = _graph(tmp_path, case)
    size = os.path.getsize(path)
    for mod in (shards, jshards):
        assert mod.plan_shards("g", path, str(tmp_path / "o"), 0) is None
        assert mod.plan_shards("g", path, str(tmp_path / "o"), size) is None
    if case == "tiny":
        # Three vertices at a one-byte cap: the split degenerates alike.
        mine = shards.plan_shards("g", path, str(tmp_path / "m"), 1)
        theirs = jshards.plan_shards("g", path, str(tmp_path / "j"), 1)
        assert _manifest(mine) == _manifest(theirs)
        return
    wpath = str(tmp_path / "w.bin")
    n, edges = GRAPHS[case]()
    io.save_graph_bin(wpath, n, edges, generators.edge_costs(edges.shape[0], "uniform", 9,
                                                            seed=1))
    for graph, p, kw in (("g#shard0", path, {}), ("g", path, {"replicas": 0}),
                         ("g", wpath, {})):
        with pytest.raises(supervisor.InputError) as mine:
            shards.plan_shards(graph, p, str(tmp_path / "m"), 64, **kw)
        with pytest.raises(jsupervisor.InputError) as theirs:
            jshards.plan_shards(graph, p, str(tmp_path / "j"), 64, **kw)
        assert str(mine.value) == str(theirs.value)


def test_disk_full_shard_write_matches_jax(tmp_path):
    """``disk_full:shard:2``: the second artifact write fails with the
    typed StorageError in both packages, the same message but the path."""
    path = _graph(tmp_path, "gnm")
    cap = os.path.getsize(path) // 3
    outcomes = []
    for mod, fmod, sup, d in ((shards, faults, supervisor, "m"),
                              (jshards, jfaults, jsupervisor, "j")):
        with fmod.injected(fmod.FaultPlan.parse("disk_full:shard:2")) as plan:
            with pytest.raises(sup.StorageError) as err:
                mod.plan_shards("g", path, str(tmp_path / d), cap)
            outcomes.append((str(err.value).replace(str(tmp_path / d), "<out>"),
                             sorted(os.listdir(tmp_path / d)),
                             [s.fired for s in plan.specs]))
    assert outcomes[0] == outcomes[1]
    assert outcomes[0][1] == ["shard0000.bin"] and outcomes[0][2] == [True]


@pytest.mark.parametrize("parts", [1, 2, 4, 9])
def test_scatter_or_merge_and_row_splits_match_jax(tmp_path, parts):
    path = _graph(tmp_path, "rmat")
    g = io.load_graph_bin(path, native=False)
    assert shards.edge_balanced_row_splits(g.row_offsets, parts) == \
        jpartition2d.edge_balanced_row_splits(g.row_offsets, parts)
    plan = shards.plan_shards("g", path, str(tmp_path / "o"),
                              os.path.getsize(path) // max(parts, 2))
    rng = np.random.default_rng(parts)
    frontier = [np.unique(rng.integers(0, g.n, size=int(rng.integers(0, 40))))
                for _ in range(5)]
    jplan = jshards.ShardPlan.from_manifest("g", plan.to_record())
    mine = shards.scatter_frontier(plan, frontier)
    assert mine == jshards.scatter_frontier(jplan, frontier)
    fragments = [
        [sorted(rng.integers(0, g.n, size=int(rng.integers(0, 30))).tolist())
         for _ in range(int(rng.integers(3, 6)))]
        for _ in range(parts)
    ]
    a = shards.or_merge_fragments(g.n, fragments, 5)
    b = jshards.or_merge_fragments(g.n, fragments, 5)
    assert len(a) == len(b) == 5
    assert all(np.array_equal(x, y) and x.dtype == y.dtype for x, y in zip(a, b))
    assert shards.shard_name("g", 3) == jshards.shard_name("g", 3)
    assert shards.parent_of("g#shard3") == jshards.parent_of("g#shard3") == "g"


# ---------------------------------------------------------------------------
# Autoscaler and brownout ladder
# ---------------------------------------------------------------------------


def _signals(seed, ticks=160):
    """A seeded load trace: calm, a stampede, a plateau, a drain."""
    rng = np.random.default_rng(seed)
    trace = []
    for t in range(ticks):
        phase = (t * 4) // ticks
        base = (0.05, 0.95, 0.5, 0.02)[phase]
        count = int(rng.integers(0, 5))
        util = [float(np.clip(base + rng.normal(0, 0.15), 0, 1.5)) for _ in range(count)]
        age = [float(rng.exponential(0.4 if phase == 1 else 0.05)) for _ in range(count)]
        shed = int(rng.random() < (0.3 if phase == 1 else 0.01))
        trace.append((util, age, shed))
    return trace


CONFIGS = {
    "default": {},
    "eager": dict(min_replicas=2, max_replicas=6, up_after=1, down_after=3,
                  cooldown_ticks=2, max_step=2, churn_budget=3, churn_window=20),
}


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_autoscale_decisions_match_jax(config, seed):
    mine = autoscale.AutoscalePolicy(autoscale.AutoscaleConfig(**CONFIGS[config]))
    theirs = jautoscale.AutoscalePolicy(jautoscale.AutoscaleConfig(**CONFIGS[config]))
    size = {"m": 2, "j": 2}
    for t, (util, age, shed) in enumerate(_signals(seed)):
        out = []
        for key, pol, mod in (("m", mine, autoscale), ("j", theirs, jautoscale)):
            sig = [mod.ReplicaSignal(utilization=u, oldest_age_s=a) for u, a in zip(util, age)]
            delta = pol.tick(size=size[key], replicas=sig, shed_since_last=shed)
            if delta and t % 7 == 3:
                pol.cancel()  # a spawn that failed: the budget is refunded
            else:
                size[key] += delta
            out.append((delta, pol.last_reason, pol.describe()))
        assert out[0] == out[1], t
    assert mine.scale_ups > 0


def test_autoscale_config_refusals_match_jax():
    for kw in (dict(min_replicas=0), dict(min_replicas=3, max_replicas=2),
               dict(low_watermark=0.9), dict(up_after=0), dict(churn_budget=0)):
        with pytest.raises(ValueError) as mine:
            autoscale.AutoscaleConfig(**kw).validate()
        with pytest.raises(ValueError) as theirs:
            jautoscale.AutoscaleConfig(**kw).validate()
        assert str(mine.value) == str(theirs.value)


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("ladder", [{}, dict(down_after=1, up_after=2, min_dwell=0, log_cap=3)])
def test_brownout_rungs_and_journal_match_jax(tmp_path, ladder, seed):
    mine = brownout.BrownoutLadder(journal_path=str(tmp_path / "m.jsonl"), **ladder)
    theirs = jbrownout.BrownoutLadder(journal_path=str(tmp_path / "j.jsonl"), **ladder)
    for t, (util, _, shed) in enumerate(_signals(seed)):
        saturated = bool(util) and (sum(util) / len(util) >= 0.75 or shed > 0)
        a, b = mine.tick(saturated), theirs.tick(saturated)
        assert a == b, t
        assert (mine.vote_suppressed(), mine.audit_suppressed(), mine.cache_only()) == \
            (theirs.vote_suppressed(), theirs.audit_suppressed(), theirs.cache_only())
        assert mine.describe() == theirs.describe()
    assert mine.steps_down > 0
    with open(tmp_path / "m.jsonl", "rb") as fm, open(tmp_path / "j.jsonl", "rb") as fj:
        assert fm.read() == fj.read()
    for level in range(len(brownout.RUNGS)):
        assert brownout.effects_for(level) == jbrownout.effects_for(level)
    for kw in (dict(down_after=0), dict(up_after=0), dict(min_dwell=-1)):
        with pytest.raises(ValueError) as m_err:
            brownout.BrownoutLadder(**kw)
        with pytest.raises(ValueError) as j_err:
            jbrownout.BrownoutLadder(**kw)
        assert str(m_err.value) == str(j_err.value)

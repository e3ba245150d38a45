"""The port's fault plan (utils/faults.py) against the JAX package's: the
same specs and the same error messages from the same ``MSBFS_FAULTS``
strings, fire-once on the n-th trip, independent sites, the poison match,
``corrupt`` flipping the same bit of the same array, and the ELL route's
plane seam corrupting the same distances."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu import (
    CSRGraph as JCSRGraph,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu.models.ell import (
    EllGraph as JEllGraph,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu.ops import (
    pallas_bfs as jpallas,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu.ops.engine import (
    Engine as JEngine,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu.utils import (
    faults as jfaults,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.models import (
    generators,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.models.csr import (
    CSRGraph,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.models.ell import (
    EllGraph,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.ops.engine import (
    Engine,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.utils import (
    faults,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.utils import (
    io as tio,
)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

GOOD = [
    "io:load_graph:1, oom:dispatch:2 ,hang:dispatch:3,chip:rank1:1",
    "transient:dispatch:2",
    "corrupt:load_query:1",
    "poison:vertex7:2,crash:dispatch:3",
    "bitflip:plane0:1,bitflip:dist:2,bitflip:wplane:1",
    # Serving-only kinds parse (and fire nowhere in the batch CLI).
    "replica_kill:replica0:3,replica_slow:route1:1,net_drop:route2:1",
    "wire_corrupt:route0:2,host_down:hostA:1,net_delay:route1:250",
    "net_partition:route0.route1|route2:1,net_dup:route0:1",
    "net_reorder:route1:1,half_open:route0:1,disk_full:journal:1,disk_full:shard:2",
    "",
    " , ",
]

BAD = [
    "io:load_graph",  # missing count
    "nope:dispatch:1",  # unknown kind
    "io:load_graph:zero",  # non-integer count
    "io:load_graph:0",  # counts are 1-based
    "chip:dispatch:1",  # chip faults need rank<r>
    "poison:dispatch:1",
    "replica_kill:route0:1",
    "net_drop:replica1:1",
    "net_partition:route0:1",
    "net_partition:route0.bogus|route1:1",
    "net_partition:route0.route1|route1:1",
    "bitflip:plane:1",
    "disk_full:disk:1",
    "host_down:host@A:1",
    "bogus",
    "io:a:b:c",
]


def _spec_tuple(s):
    return (s.kind, s.site, s.at, s.rank, s.vertex, s.replica, s.host, s.groups,
            s.delay_ms, s.trip_site)


@pytest.mark.parametrize("text", GOOD)
def test_parse_matches_jax(text):
    mine = faults.FaultPlan.parse(text)
    theirs = jfaults.FaultPlan.parse(text)
    assert [_spec_tuple(s) for s in mine.specs] == [_spec_tuple(s) for s in theirs.specs]


@pytest.mark.parametrize("text", BAD)
def test_malformed_messages_match_jax(text):
    with pytest.raises(ValueError) as mine:
        faults.FaultPlan.parse(text)
    with pytest.raises(ValueError) as theirs:
        jfaults.FaultPlan.parse(text)
    assert str(mine.value) == str(theirs.value)


def test_from_env_matches_jax(monkeypatch):
    assert faults.FaultPlan.from_env() is None
    monkeypatch.setenv("MSBFS_FAULTS", "hang:dispatch:2")
    monkeypatch.setenv("MSBFS_FAULT_HANG", "0.25")
    mine, theirs = faults.FaultPlan.from_env(), jfaults.FaultPlan.from_env()
    assert mine.hang_seconds == theirs.hang_seconds == 0.25
    assert [_spec_tuple(s) for s in mine.specs] == [_spec_tuple(s) for s in theirs.specs]


def _outcome(plan, site, context=None):
    try:
        plan.trip(site, context)
    except Exception as exc:  # noqa: BLE001 — the outcome is the comparison
        return type(exc).__name__, str(exc)
    return None


@pytest.mark.parametrize(
    "text,trips",
    [
        ("transient:dispatch:2", ["dispatch"] * 4),
        ("io:load_graph:1", ["dispatch", "load_query", "load_graph", "load_graph"]),
        ("oom:dispatch:1,oom:dispatch:2,corrupt:load_query:2",
         ["dispatch", "load_query", "dispatch", "load_query", "dispatch"]),
        ("chip:rank3:2", ["dispatch"] * 3),
        ("hang:dispatch:1", ["dispatch", "dispatch"]),
    ],
)
def test_fire_once_on_nth_trip_and_replay(text, trips):
    """Each spec fires once, on the n-th trip of its own site, with JAX's
    exception type and message; ``reset`` replays the same trace."""
    mine = faults.FaultPlan.parse(text, hang_seconds=0.01)
    theirs = jfaults.FaultPlan.parse(text, hang_seconds=0.01)
    for _ in range(2):
        got = [_outcome(mine, site) for site in trips]
        assert got == [_outcome(theirs, site) for site in trips]
        assert any(got)
        assert [s.fired for s in mine.specs] == [s.fired for s in theirs.specs]
        assert mine.counters == theirs.counters
        mine.reset()
        theirs.reset()


def test_poison_follows_the_vertex():
    """poison fires on every dispatch whose 2-D integer batch holds the
    vertex, from the n-th such dispatch on; other payloads never match."""
    batches = [np.array([[1, 2]], np.int32), np.array([[7, -1]], np.int32),
               (4, 2), np.array([[7]], np.int64), np.array([[3, 7]], np.int32),
               np.array([7], np.int32)]
    mine = faults.FaultPlan.parse("poison:vertex7:2")
    theirs = jfaults.FaultPlan.parse("poison:vertex7:2")
    got = [_outcome(mine, "dispatch", b) for b in batches]
    assert got == [_outcome(theirs, "dispatch", b) for b in batches]
    assert [g is not None for g in got] == [False, False, False, True, True, False]


def test_crash_exits_137(tmp_path):
    """crash is a process death with no cleanup: exit 137, nothing after."""
    code = (
        "from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch"
        ".utils import faults\n"
        "p = faults.FaultPlan.parse('crash:dispatch:2')\n"
        "p.trip('dispatch')\nprint('one', flush=True)\np.trip('dispatch')\nprint('two')\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=60,
        cwd=str(tmp_path), env={**os.environ, "PYTHONPATH": REPO_ROOT},
    )
    assert proc.returncode == 137 and proc.stdout == "one\n", proc.stderr


@pytest.mark.parametrize(
    "arr",
    [
        np.arange(24, dtype=np.int64),
        np.arange(60, dtype=np.int32).reshape(3, 20),
        np.zeros((5, 7), dtype=np.int32),
        np.zeros(0, dtype=np.int64),
    ],
)
@pytest.mark.parametrize("site", ["dist", "plane0", "plane3"])
def test_corrupt_flips_the_same_bit(arr, site):
    """``corrupt`` fires on the n-th execution of its site and flips the
    bit JAX flips (crc32 of the site over the array's bytes), for a NumPy
    array and for the same values as a tensor."""
    text = f"bitflip:{site}:2"
    mine, theirs = faults.FaultPlan.parse(text), jfaults.FaultPlan.parse(text)
    assert mine.bitflip_armed() and theirs.bitflip_armed()
    assert mine.corrupt(site, arr) is arr
    assert theirs.corrupt(site, arr) is arr
    got = mine.corrupt(site, torch.from_numpy(arr.copy()))
    want = np.asarray(theirs.corrupt(site, arr))
    assert got.dtype == want.dtype and np.array_equal(got, want)
    if arr.size:
        assert (got != arr).sum() == 1
    assert not mine.bitflip_armed() and not theirs.bitflip_armed()
    assert mine.corrupt(site, arr) is arr


@pytest.mark.parametrize("site", ["plane0", "plane1", "plane2"])
def test_plane_seam_flips_the_ell_distances_as_jax(site):
    """bitflip:plane<i> flips, after the ELL route's chunk i, the bit of
    the distances that JAX flips in its carry: the same corrupted F, one
    query off the clean run."""
    n, edges = generators.rmat_edges(8, edge_factor=8, seed=3)
    queries = tio.pad_queries(generators.random_queries(n, 12, max_group=4, seed=4))
    eg = EllGraph.from_host(CSRGraph.from_edges(n, edges), "cpu")
    je = JEllGraph.from_host(JCSRGraph.from_edges(n, edges))
    clean = Engine(eg, level_chunk=2).f_values(queries).numpy()
    text = f"bitflip:{site}:1"
    with faults.injected(faults.FaultPlan.parse(text)):
        mine = Engine(eg, level_chunk=2).f_values(queries).numpy()
    with jfaults.injected(jfaults.FaultPlan.parse(text)):
        theirs = JEngine(je, level_chunk=2, expand=jpallas.ell_expand).f_values(queries)
    np.testing.assert_array_equal(mine, np.asarray(theirs))
    assert (mine != clean).sum() == 1


def test_module_seams():
    """activate / active_plan / trip / corruption_armed / corrupt /
    injected: no-ops without a plan, scoped by ``injected``."""
    faults.trip("load_query")  # no plan: nothing happens
    assert not faults.corruption_armed()
    x = np.arange(4)
    assert faults.corrupt("dist", x) is x
    plan = faults.FaultPlan.parse("corrupt:load_query:1,bitflip:dist:1")
    with faults.injected(plan) as active:
        assert active is plan and faults.active_plan() is plan
        assert faults.corruption_armed()
        with pytest.raises(ValueError, match="injected corrupt input at load_query"):
            faults.trip("load_query")
        assert not np.array_equal(faults.corrupt("dist", x), x)
        assert not faults.corruption_armed()
    assert faults.active_plan() is None
    try:
        faults.activate(plan)  # a fresh activation re-arms the plan
        assert plan.counters == {} and len(plan.pending()) == 2
    finally:
        faults.activate(None)


def test_serving_kinds_fire_nowhere_here():
    """A serving-only kind's site is never tripped by the batch CLI; if a
    caller trips it, the port says those seams are not ported."""
    plan = faults.FaultPlan.parse("net_drop:route1:1,disk_full:journal:1")
    plan.trip("dispatch")
    plan.trip("load_graph")
    with pytest.raises(NotImplementedError, match="not yet ported"):
        plan.trip("route1")

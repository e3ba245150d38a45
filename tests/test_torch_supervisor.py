"""The port's ChunkSupervisor (runtime/supervisor.py) against the JAX
package's: the capacity ladder of the default route walked by injected
out-of-memory faults (the same events and F), transient retries, the
watchdog and exhausted budgets (the same typed errors), the dist result
seam, the audit hooks, and the port's own rule that the failed engine is
released before a rung's factory runs and a factory's error is typed."""

import gc
import weakref

import numpy as np
import pytest
import torch

from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu import (
    CSRGraph as JCSRGraph,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu import cli as jcli
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu.models.bell import (
    BellGraph as JBellGraph,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu.ops.bitbell import (
    BitBellEngine as JBitBellEngine,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu.runtime import (
    supervisor as jsup,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu.utils import (
    faults as jfaults,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch import cli
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.models import (
    generators,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.models.bell import (
    BellGraph,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.models.csr import (
    CSRGraph,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.ops.bitbell import (
    BitBellEngine,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.runtime import (
    supervisor as sup,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.utils import (
    faults,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.utils import (
    io as tio,
)

FAST = dict(max_retries=2, base_delay=0.001, max_delay=0.01)


@pytest.fixture(scope="module")
def workload():
    n, edges = generators.rmat_edges(8, edge_factor=8, seed=5)
    queries = tio.pad_queries(generators.random_queries(n, 40, max_group=5, seed=6))
    return CSRGraph.from_edges(n, edges), JCSRGraph.from_edges(n, edges), queries


def _pair(workload, level_chunk, plan_text, watchdog=None, policy=FAST, hang_seconds=0.5,
          warm=None):
    """Port and JAX supervisors over the default route's engine and
    ladder, as each CLI builds them, under the same plan.  ``warm``: a
    query batch each engine answers once before it is supervised, so its
    first call's setup (JAX's jit compile) is not timed by the watchdog
    and the plan's dispatch counter is not consumed."""
    g, jg, _ = workload
    engines = (
        BitBellEngine(BellGraph.from_host(g, "cpu"), level_chunk=level_chunk),
        JBitBellEngine(JBellGraph.from_host(jg), level_chunk=level_chunk),
    )
    if warm is not None:
        for engine in engines:
            engine.best(warm)
    mine = sup.ChunkSupervisor(
        engines[0],
        policy=sup.RetryPolicy(**policy), watchdog=watchdog,
        ladder=cli.bitbell_ladder(g, level_chunk, "cpu"),
        plan=faults.FaultPlan.parse(plan_text, hang_seconds=hang_seconds),
    )
    theirs = jsup.ChunkSupervisor(
        engines[1],
        policy=jsup.RetryPolicy(**policy), watchdog=watchdog,
        ladder=jcli._bitbell_ladder(jg, level_chunk),
        plan=jfaults.FaultPlan.parse(plan_text, hang_seconds=hang_seconds),
    )
    return mine, theirs


@pytest.mark.parametrize(
    "level_chunk,plan,rungs",
    [
        (128, "oom:dispatch:1", ["streamed"]),
        (128, "oom:dispatch:1,oom:dispatch:2", ["streamed", "host-streamed"]),
        (None, "oom:dispatch:1,oom:dispatch:2,oom:dispatch:3",
         ["level-chunked", "streamed", "host-streamed"]),
    ],
)
def test_ladder_events_and_f_match_jax(workload, level_chunk, plan, rungs):
    """Each injected out-of-memory error steps one rung down the ladder;
    the event list (actions, labels, errors), the rung reached and F
    equal JAX's, and F equals the undisturbed engine's."""
    queries = workload[2]
    mine, theirs = _pair(workload, level_chunk, plan)
    f_mine = mine.f_values(queries).numpy()
    f_theirs = np.asarray(theirs.f_values(queries))
    assert mine.events == theirs.events
    assert [e["to"] for e in mine.events] == rungs
    assert all(e["action"] == "degrade" for e in mine.events)
    assert type(mine.engine).__name__ == type(theirs.engine).__name__
    np.testing.assert_array_equal(f_mine, f_theirs)
    clean = BitBellEngine(BellGraph.from_host(workload[0], "cpu"), level_chunk=128)
    np.testing.assert_array_equal(f_mine, clean.f_values(queries).numpy())
    # The rung took over for good: the next call runs on it.
    assert mine.best(queries) == theirs.best(queries)
    assert [r[0] for r in mine.ladder] == [r[0] for r in theirs.ladder]


def _raised(fn):
    try:
        fn()
    except Exception as exc:  # noqa: BLE001 — the outcome is the comparison
        return type(exc).__name__, str(exc), getattr(exc, "exit_code", None)
    return None


@pytest.mark.parametrize(
    "plan,watchdog,policy,code",
    [
        ("transient:dispatch:1", None, FAST, None),
        ("transient:dispatch:1,transient:dispatch:2,transient:dispatch:3", None, FAST, 5),
        ("hang:dispatch:1", 1.0, dict(FAST, max_retries=0), 5),
        ("hang:dispatch:1", 1.0, FAST, None),
        ("oom:dispatch:1,oom:dispatch:2,oom:dispatch:3", None, FAST, 3),
        ("chip:rank0:1", None, FAST, 4),
        ("poison:vertex3:1", None, FAST, 6),
    ],
)
def test_retry_watchdog_and_budgets_match_jax(workload, plan, watchdog, policy, code):
    """Transient retries, the watchdog (a hang of 3 s against 1 s, the
    retry's whole call well inside the next 1 s: both engines are warmed
    outside their supervisors first) and exhausted budgets: the same
    outcome, typed error and exit code, and the same recovery events, in
    both packages."""
    queries = workload[2].copy()
    queries[0, 0] = 3  # the poisoned vertex is in the batch
    mine, theirs = _pair(workload, 128, plan, watchdog=watchdog, policy=policy,
                         hang_seconds=3.0, warm=queries)
    got = _raised(lambda: mine.best(queries))
    want = _raised(lambda: theirs.best(queries))
    assert got == want
    assert (got[2] if got else None) == code
    assert mine.events == theirs.events


def test_dist_seam_flips_the_result_as_jax(workload):
    """bitflip:dist corrupts f_values' result after the engine made it,
    the same bit as JAX's supervisor flips, once."""
    queries = workload[2]
    mine, theirs = _pair(workload, 128, "bitflip:dist:1")
    got, want = mine.f_values(queries), np.asarray(theirs.f_values(queries))
    assert isinstance(got, torch.Tensor)
    np.testing.assert_array_equal(got.numpy(), want)
    clean = mine.f_values(queries).numpy()
    assert (got.numpy() != clean).sum() == 1


def test_classify_cuda_oom():
    err = sup.classify(torch.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 2.00 GiB. GPU 0 has a total "
        "capacity of 79.11 GiB of which 1.06 GiB is free."
    ))
    assert isinstance(err, sup.CapacityError) and err.exit_code == 3
    assert isinstance(sup.classify(MemoryError()), sup.CapacityError)
    assert isinstance(sup.classify(RuntimeError("UNAVAILABLE: x")), sup.TransientError)
    assert isinstance(sup.classify(ValueError("truncated")), sup.InputError)


class _Failing(sup.QueryEngineBase):
    """An engine whose every call runs out of device memory."""

    def __init__(self):
        self.planes = torch.zeros(64)

    def f_values(self, queries):
        raise torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 64.00 MiB")


class _Fixed(sup.QueryEngineBase):
    def f_values(self, queries):
        return torch.arange(np.asarray(queries).shape[0], dtype=torch.int64)


def test_failed_engine_released_before_the_factory():
    """The next rung's factory runs after the failed engine (and the
    failed call's frames) are gone: its memory is free for the rung."""
    failing = _Failing()
    ref = weakref.ref(failing)
    seen = []

    def factory():
        gc.collect()
        seen.append(ref() is None)
        return _Fixed()

    s = sup.ChunkSupervisor(failing, ladder=[("next", factory)])
    del failing
    f = s.f_values(np.zeros((3, 1), np.int32))
    assert seen == [True]
    assert f.tolist() == [0, 1, 2]
    assert [e["action"] for e in s.events] == ["degrade"]
    assert "CUDA out of memory" in s.events[0]["error"]


@pytest.mark.parametrize(
    "error,typed",
    [
        (torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 8.00 GiB"),
         sup.CapacityError),
        (RuntimeError("UNAVAILABLE: lost the card"), sup.TransientError),
        (ValueError("layout too large"), sup.InputError),
        (KeyError("x"), sup.InputError),
        (AssertionError("bug"), sup.MsbfsError),
    ],
)
def test_factory_error_is_typed(error, typed):
    """An error raised while a rung is built leaves the supervisor typed
    (its exit code), chained to the original, not as a raw traceback."""

    def factory():
        raise error

    s = sup.ChunkSupervisor(_Failing(), ladder=[("next", factory)])
    with pytest.raises(sup.MsbfsError) as info:
        s.f_values(np.zeros((2, 1), np.int32))
    assert type(info.value) is typed
    assert info.value.__cause__ is error
    assert [e["action"] for e in s.events] == []


def test_audit_escalation_borrows_rungs_and_restores():
    """A failed audit retries the same engine, then borrows the ladder's
    rungs, and the original engine comes back once the call settles; a
    result that never passes raises CorruptionError (exit 9)."""
    verdicts = iter([["dist"], ["dist"], []])
    base = _Fixed()
    s = sup.ChunkSupervisor(
        base, ladder=[("alt", _Fixed)], auditor=lambda q, f: next(verdicts),
    )
    s.f_values(np.zeros((2, 1), np.int32))
    assert [e["action"] for e in s.events] == ["audit_fail", "audit_fail", "audit_degrade"]
    assert s.engine is base and len(s.ladder) == 1
    assert s.audited_total == 3 and s.audit_failures_total == 2
    always = sup.ChunkSupervisor(_Fixed(), auditor=lambda q, f: ["reached"])
    with pytest.raises(sup.CorruptionError) as info:
        always.f_values(np.zeros((2, 1), np.int32))
    assert info.value.exit_code == 9 and info.value.invariants == ("reached",)
    sampled = sup.ChunkSupervisor(_Fixed(), auditor=lambda q, f: [], audit_sample=0.25)
    for _ in range(8):
        sampled.f_values(np.zeros((1, 1), np.int32))
    assert sampled.audited_total == 2


def test_events_drain_and_record():
    s = sup.ChunkSupervisor(_Fixed())
    s.record_event("quarantine", vertex=7)
    assert s.drain_events() == [{"action": "quarantine", "vertex": 7}]
    assert s.events == []

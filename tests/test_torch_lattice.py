"""The port's engine lattice (ops/engine.py) against the JAX package's:
every knob combination resolves to the same axes and tokens or fails with
the same message, negotiation over the single-device engine classes picks
the same label or names the same missing tokens, the labels agree, and
each port engine class declares the JAX class's ``CAPABILITIES``."""

import itertools

import pytest

from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu.ops import (
    bell as jbell,
    bitbell as jbitbell,
    engine as jengine,
    lowk as jlowk,
    mxu as jmxu,
    packed as jpacked,
    push as jpush,
    push_packed as jpush_packed,
    stencil as jstencil,
    streamed as jstreamed,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.ops import (
    bell,
    bitbell,
    engine,
    lowk,
    mxu,
    packed,
    push,
    push_packed,
    stencil,
    streamed,
)

# (label, port class, JAX class): the single-device engines the port has.
CLASSES = [
    ("bitbell", bitbell.BitBellEngine, jbitbell.BitBellEngine),
    ("bell", bell.BellEngine, jbell.BellEngine),
    ("lowk", lowk.LowKEngine, jlowk.LowKEngine),
    ("mxu", mxu.MxuEngine, jmxu.MxuEngine),
    ("stencil", stencil.StencilEngine, jstencil.StencilEngine),
    ("streamed", streamed.StreamedBitBellEngine, jstreamed.StreamedBitBellEngine),
    ("packed", packed.PackedEngine, jpacked.PackedEngine),
    ("push", push.PushEngine, jpush.PushEngine),
    ("ppush", push_packed.PackedPushEngine, jpush_packed.PackedPushEngine),
    ("vmap", engine.Engine, jengine.Engine),
]

BACKENDS = sorted(jengine.BACKEND_AXES) + ["warp"]


def test_tables_match_jax():
    assert engine.AXES == jengine.AXES
    assert engine.BACKEND_AXES == jengine.BACKEND_AXES
    assert engine.BACKEND_EXTRAS == jengine.BACKEND_EXTRAS
    assert engine._INCOMPATIBLE == jengine._INCOMPATIBLE
    assert issubclass(engine.NegotiationError, ValueError)
    assert engine.QueryEngineBase.CAPABILITIES == frozenset()


@pytest.mark.parametrize("label,port_cls,jax_cls", CLASSES, ids=[c[0] for c in CLASSES])
def test_capabilities_match_jax(label, port_cls, jax_cls):
    assert port_cls.CAPABILITIES == jax_cls.CAPABILITIES
    assert engine.axis_tokens({"plane": "bit"}) == jengine.axis_tokens({"plane": "bit"})


def _outcome(mod, fn, *args, **kwargs):
    try:
        return ("ok", fn(*args, **kwargs))
    except mod.NegotiationError as exc:
        return ("error", str(exc))


def _combos(backend):
    return itertools.product(
        list(jengine.AXES["partition"]) + ["torus3d"],
        [None] + list(jengine.AXES["residency"]) + ["disk"],
        [None] + list(jengine.AXES["plane"]) + ["nibble"],
        [None] + list(jengine.AXES["kernel"]) + ["cuda"],
        (1, 3),
        (False, True),
    )


@pytest.mark.parametrize("backend", BACKENDS)
def test_resolve_and_negotiate_match_jax(backend):
    """Every combination for ``backend``: the same axes and tokens (or the
    same refusal), the same label, and the same negotiation winner (or the
    same no-winner message) over the port's classes and the JAX ones."""
    port_reg = [(lab, cls, lambda lab=lab: lab) for lab, cls, _ in CLASSES]
    jax_reg = [(lab, cls, lambda lab=lab: lab) for lab, _, cls in CLASSES]
    for part, res, plane, kernel, alv, weighted in _combos(backend):
        kw = dict(partition=part, residency=res, plane=plane, kernel=kernel,
                  async_levels=alv, weighted=weighted)
        got = _outcome(engine, engine.resolve_axes, backend, **kw)
        want = _outcome(jengine, jengine.resolve_axes, backend, **kw)
        assert got == want, (backend, kw)
        if got[0] == "error":
            continue
        axes, required = got[1]
        for extras in ((), ("banded",)):
            assert engine.engine_label(axes, alv, extras) == \
                jengine.engine_label(axes, alv, extras)
        assert _outcome(engine, engine.negotiate_engine, required, port_reg) == \
            _outcome(jengine, jengine.negotiate_engine, required, jax_reg)


def test_no_winner_message_matches_jax():
    class _A:
        CAPABILITIES = frozenset({"plane:bit"})

    class _B:
        CAPABILITIES = frozenset()

    msgs = []
    for mod in (engine, jengine):
        with pytest.raises(mod.NegotiationError) as exc:
            mod.negotiate_engine({"plane:bit", "reshard"},
                                 [("a", _A, lambda: None), ("b", _B, lambda: None)])
        msgs.append(str(exc.value))
    assert msgs[0] == msgs[1] == (
        "no engine provides {plane:bit, reshard}: "
        "a lacks {reshard}; b lacks {plane:bit, reshard}"
    )


def test_negotiation_never_builds_losers():
    calls = []
    reg = [(lab, cls, lambda lab=lab: calls.append(lab) or lab) for lab, cls, _ in CLASSES]
    _, required = engine.resolve_axes("lowk")
    assert engine.negotiate_engine(required, reg) == ("lowk", "lowk")
    assert calls == ["lowk"]

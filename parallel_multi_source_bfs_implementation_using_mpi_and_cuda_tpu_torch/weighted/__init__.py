"""Weighted distance-to-set: the bucketed delta-stepping route.

Its engines speak the :class:`..ops.engine.QueryEngineBase` contract, with
``f_values`` a cost sum instead of a hop sum, and are negotiated through
the same capability tokens as the lattice (:func:`..ops.engine.
negotiate_engine`): the ``weighted`` token, plus ``windowed`` or
``mesh2d``.  An ask no flavor provides fails naming the missing tokens;
a weightless graph is refused, never served hop counts as costs.
"""

from __future__ import annotations

from typing import Optional

from ..ops.engine import negotiate_engine
from ..runtime.supervisor import InputError
from ..utils import knobs
from .deltastep import (
    INF,
    DeltaStepEngineBase,
    WeightedBitBellEngine,
    WeightedMesh2DEngine,
    WeightedStencilEngine,
    resolve_delta,
)

__all__ = [
    "INF",
    "DeltaStepEngineBase",
    "WeightedBitBellEngine",
    "WeightedStencilEngine",
    "WeightedMesh2DEngine",
    "resolve_delta",
    "weighted_candidates",
    "negotiate_weighted_engine",
]

#: flavor name -> extra capability tokens beyond the base ``weighted``.
_FLAVOR_TOKENS = {
    "auto": frozenset(),
    "bitbell": frozenset(),
    "stencil": frozenset({"windowed"}),
    "mesh2d": frozenset({"mesh2d"}),
}


def weighted_candidates(graph, delta: Optional[int] = None, device=None,
                        plain: bool = False, native: bool = True):
    """(label, engine_cls, factory) triples in preference order for
    :func:`..ops.engine.negotiate_engine`; losers never build."""
    kw = dict(delta=delta, device=device, plain=plain, native=native)
    return [
        ("weighted-bitbell", WeightedBitBellEngine,
         lambda: WeightedBitBellEngine(graph, **kw)),
        ("weighted-stencil", WeightedStencilEngine,
         lambda: WeightedStencilEngine(graph, **kw)),
        ("weighted-mesh2d", WeightedMesh2DEngine,
         lambda: WeightedMesh2DEngine(graph, **kw)),
    ]


def negotiate_weighted_engine(
    graph, flavor: Optional[str] = None, delta: Optional[int] = None,
    device=None, plain: bool = False, native: bool = True,
):
    """``(label, engine)`` for ``graph``.  ``flavor`` (default: the
    ``MSBFS_WEIGHTED_ENGINE`` knob, else ``auto``) maps to the required
    tokens: ``auto``/``bitbell`` need ``weighted``, ``stencil`` adds
    ``windowed``, ``mesh2d`` adds ``mesh2d``.

    Raises :class:`InputError` on a weightless graph or an unknown
    flavor; the negotiation's ValueError, naming each candidate's missing
    tokens, on an ask no flavor meets."""
    if not getattr(graph, "has_weights", False):
        raise InputError(
            "weighted query against a weightless graph: the artifact has "
            "no edge-cost section (regenerate with gen_cli --weights, or "
            "convert with load_dimacs_gr(keep_weights=True))"
        )
    if flavor is None:
        flavor = knobs.raw("MSBFS_WEIGHTED_ENGINE", "auto") or "auto"
    flavor = flavor.strip().lower() or "auto"
    if flavor not in _FLAVOR_TOKENS:
        raise InputError(
            f"unknown weighted engine flavor {flavor!r} "
            f"(MSBFS_WEIGHTED_ENGINE: auto, bitbell, stencil, mesh2d)"
        )
    required = frozenset({"weighted"}) | _FLAVOR_TOKENS[flavor]
    return negotiate_engine(
        required, weighted_candidates(graph, delta, device, plain, native)
    )

"""The serving runtime: a daemon on one card, and a replicated fleet of
them.

The port's copy of the JAX package's serve/ (its docs/SERVING.md is the
operator manual):

* :mod:`.registry` — load-once graphs resident on the card, keyed by name
  + content hash, versioned by reload and by ``mutate``;
* :mod:`.protocol` — the JAX package's length-prefixed JSON frames;
* :mod:`.batcher` — micro-batching into power-of-two shape buckets, with
  admission, per-client rates and CoDel shedding;
* :mod:`.caches` — the result cache, the repair-seed plane cache and the
  warm-up ledger;
* :mod:`.journal` / :mod:`.lifecycle` — crash recovery, drain and socket
  reclaim;
* :mod:`.observe` — the ``trace`` and ``metrics`` verbs, and the fleet's
  roll-up of both;
* :mod:`.server` — the daemon (``serve``), :mod:`.client` — the client and
  the ``query``/``health``/``trace`` subcommands, :mod:`.smoke` — an end
  to end smoke;
* :mod:`.ring` — rendezvous-hash placement: graph content digest ->
  replication-factor owner set, minimal movement on replica loss;
* :mod:`.shards` — row-range shards of a graph too large for one
  replica, and the scatter/gather helpers;
* :mod:`.fleet` — the fleet supervisor (``fleet``): N replica daemons of
  this package, health heartbeats, backoff restarts, ring reconciliation;
* :mod:`.router` — the front-end failover/hedge/shed/vote router and the
  fleet's client-facing socket;
* :mod:`.autoscale` / :mod:`.brownout` — the fleet's pure overload
  controllers.
"""

from __future__ import annotations

__all__ = [
    "FleetFrontend",
    "FleetRouter",
    "FleetSupervisor",
    "MsbfsClient",
    "MsbfsServer",
    "PlacementRing",
    "ServerError",
]


def __getattr__(name):
    # Lazy re-exports: importing the package stays cheap (the CLI imports
    # it only to dispatch subcommands).
    if name == "MsbfsServer":
        from .server import MsbfsServer

        return MsbfsServer
    if name in ("MsbfsClient", "ServerError"):
        from . import client

        return getattr(client, name)
    if name == "FleetSupervisor":
        from .fleet import FleetSupervisor

        return FleetSupervisor
    if name in ("FleetFrontend", "FleetRouter"):
        from . import router

        return getattr(router, name)
    if name == "PlacementRing":
        from .ring import PlacementRing

        return PlacementRing
    raise AttributeError(name)

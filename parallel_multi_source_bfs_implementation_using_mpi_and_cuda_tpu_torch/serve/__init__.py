"""The serving runtime: a single-replica daemon on one card.

The port's copy of the JAX package's serve/ (its docs/SERVING.md is the
operator manual), without the replicated fleet:

* :mod:`.registry` — load-once graphs resident on the card, keyed by name
  + content hash, versioned by reload and by ``mutate``;
* :mod:`.protocol` — the JAX package's length-prefixed JSON frames;
* :mod:`.batcher` — micro-batching into power-of-two shape buckets, with
  admission, per-client rates and CoDel shedding;
* :mod:`.caches` — the result cache, the repair-seed plane cache and the
  warm-up ledger;
* :mod:`.journal` / :mod:`.lifecycle` — crash recovery, drain and socket
  reclaim;
* :mod:`.observe` — the ``trace`` and ``metrics`` verbs;
* :mod:`.server` — the daemon (``serve``), :mod:`.client` — the client and
  the ``query``/``health``/``trace`` subcommands, :mod:`.smoke` — an end
  to end smoke.
"""

from __future__ import annotations

__all__ = ["MsbfsClient", "MsbfsServer", "ServerError"]


def __getattr__(name):
    # Lazy re-exports: importing the package stays cheap (the CLI imports
    # it only to dispatch subcommands).
    if name == "MsbfsServer":
        from .server import MsbfsServer

        return MsbfsServer
    if name in ("MsbfsClient", "ServerError"):
        from . import client

        return getattr(client, name)
    raise AttributeError(name)

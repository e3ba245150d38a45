"""Dynamic graphs: versioned edge deltas + incremental BFS repair.

The port's copy of the JAX package's dynamic/ (host NumPy, as there):
the same digest chain, the same delta files, the same repaired planes.

Every engine in the repo assumes a frozen graph — one ``LoadGraphBin``,
one content hash, full recompute per query.  This subsystem makes *time*
a first-class axis (ROADMAP item 4a): :mod:`.delta` keeps a versioned
log of edge insert/delete batches against a registered base graph with a
content-derived ``(base_digest, version)`` identity, and :mod:`.repair`
re-settles only the distance cone a delta actually invalidates, seeded
from cached per-query planes, falling back to full recompute when a
host-side cost model says the cone is too large.  Serving exposes the
log through the ``mutate`` / ``versions`` wire verbs (docs/SERVING.md
"Mutations & versions").
"""

from .delta import (  # noqa: F401
    DeltaBatch,
    DeltaLog,
    canonical_edge_keys,
    keys_to_pairs,
    load_delta_bin,
    save_delta_bin,
)
from .repair import (  # noqa: F401
    RepairStats,
    repair_cost_estimate,
    repair_distances,
)

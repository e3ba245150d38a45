"""Rendezvous-hash placement ring for the serving fleet.

The port's copy of the JAX package's serve/ring.py: the same scores, so
both packages place the same digests on the same members (the JAX
package's docs/SERVING.md is the operator manual).

A fleet of N replica daemons must agree — with no coordination service —
on which replicas own each registered graph.  We use rendezvous
(highest-random-weight) hashing over the graph's *content digest*: every
(digest, member) pair gets a pseudo-random score from sha256, and the
digest's preference order is all members sorted by descending score.
The first ``replication`` members of that order are the owners; the
router walks the same order for failover, so the "next ring member" is
always well defined and identical on every node that knows the member
list.

Why rendezvous rather than a ring of virtual nodes: the member count is
small (a handful of replicas, not thousands of shards), so the O(N)
score scan is free, and HRW gives the minimal-movement property exactly
— when one member dies, the only keys that move are the ones it owned,
each promoting its next-preference member (the fleet analogue of the
supervisor's degrade-to-survivors resharding; placement spirit of arxiv 2112.01075's
memory-efficient live redistribution).  No token ranges to rebalance, no
stored state: membership + digest fully determine placement.  The same
property makes *elastic* membership cheap: the autoscaler's
:meth:`add_member` / :meth:`remove_member` move only the keys the
changed member wins/owned — scale events reshard graphs, never restart
the fleet.

Heterogeneous capacity: each member may carry a positive **weight**, and
the per-pair score becomes the weighted-rendezvous key
``w / -ln(u)`` with ``u`` the sha256 score normalized into (0, 1)
(Weighted Rendezvous Hashing, Schindelhauer/Schomaker): a member of
weight 2 wins ~2x the keys of a weight-1 member, and — because the key
is strictly increasing in ``u`` — equal weights reproduce the unweighted
preference order bit-for-bit, so the default fleet's placement is
unchanged.

Cross-host awareness: each member may advertise a **host** label.
Owner selection walks the preference order but skips members whose host
already holds a copy, so a graph's replicas land on distinct hosts
whenever enough hosts exist — a whole host going dark (``host_down``
chaos kind) then takes out at most one owner per graph.  Members
without a label count as each-on-its-own-host (the single-machine
default), which keeps label-free placement identical to the pre-host
behavior.

Scores key on the digest, not the graph *name*, so re-registering the
same bytes under another name lands on the same owners (their mxu tile
cache and result cache already hold that content), while a ``reload``
with new bytes may legitimately move.
"""

from __future__ import annotations

import hashlib
import math
from typing import Dict, Iterable, List, Optional, Sequence, Set

# sha256 leading-16-byte scores span [0, 2^128); +0.5 keeps the
# normalized u strictly inside (0, 1) so -ln(u) is finite and positive.
_SCORE_SPAN = float(1 << 128)


def _score(digest: str, member: str) -> int:
    """Pseudo-random weight of ``member`` for ``digest``: the leading 16
    bytes of sha256 over both, as an int.  Stable across processes and
    Python hash randomization (this is why built-in hash() is unusable
    here — every fleet node must compute identical placements)."""
    h = hashlib.sha256(f"{digest}|{member}".encode()).digest()
    return int.from_bytes(h[:16], "big")


def _weighted_key(digest: str, member: str, weight: float) -> float:
    """Weighted-rendezvous key ``w / -ln(u)``: strictly increasing in
    the raw score, so equal weights sort exactly like the unweighted
    ring, while a 2x weight wins ~2x the keys (each key's winner is the
    max over independent per-member draws)."""
    u = (_score(digest, member) + 0.5) / _SCORE_SPAN
    return weight / -math.log(u)


class PlacementRing:
    """Deterministic digest -> owner-set placement over a mutable member
    list.  Membership is the replica *names* (stable labels like ``r0``,
    not addresses — a restarted replica keeps its name, so placement
    survives restarts).  ``weights`` maps member -> positive capacity
    weight (absent = 1.0); ``hosts`` maps member -> host label (absent =
    the member is its own failure domain)."""

    def __init__(self, members: Sequence[str], replication: int = 2,
                 weights: Optional[Dict[str, float]] = None,
                 hosts: Optional[Dict[str, str]] = None,
                 epoch: int = 0):
        names = list(members)
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate ring members: {names}")
        if not names:
            raise ValueError("placement ring needs at least one member")
        if replication < 1:
            raise ValueError(f"replication must be >= 1, got {replication}")
        self.members: List[str] = names
        self.weights: Dict[str, float] = {}
        self.hosts: Dict[str, str] = {}
        for m, w in (weights or {}).items():
            self._set_weight(m, w)
        for m, h in (hosts or {}).items():
            self.hosts[m] = str(h)
        # More owners than members would silently under-replicate; clamp
        # loudly visible in .replication so health can report it.  The
        # requested value is kept so elastic membership can un-clamp:
        # growing past it restores the asked-for replication.
        self._want_replication = int(replication)
        self.replication = min(self._want_replication, len(names))
        # Membership epoch (docs/SERVING.md "Cross-machine transport &
        # fencing"): a monotonic view counter stamped on every wire
        # frame so a peer holding a stale member list can be refused
        # (FencedError) instead of silently served.  The supervisor owns
        # the durable counter and mirrors it here; ringless users (e.g.
        # bench harnesses) still get intrinsic bumps from
        # add_member/remove_member below.
        self.epoch = int(epoch)

    # ---- membership (autoscaler seam) ---------------------------------
    def _set_weight(self, member: str, weight) -> None:
        w = float(weight)
        if not (w > 0.0 and math.isfinite(w)):
            raise ValueError(
                f"member {member!r}: weight must be a positive finite "
                f"number, got {weight!r}"
            )
        self.weights[member] = w

    def add_member(self, name: str, weight: float = 1.0,
                   host: Optional[str] = None) -> None:
        """Grow the ring by one member.  HRW guarantees the only keys
        that move are the ones the newcomer wins."""
        if name in self.members:
            raise ValueError(f"ring member {name!r} already present")
        self._set_weight(name, weight)
        if host is not None:
            self.hosts[name] = str(host)
        self.members.append(name)
        self.replication = min(self._want_replication, len(self.members))
        self.epoch += 1

    def remove_member(self, name: str) -> None:
        """Shrink the ring by one member.  Only keys it owned move, each
        promoting its next-preference member."""
        if name not in self.members:
            raise ValueError(f"ring member {name!r} not present")
        if len(self.members) == 1:
            raise ValueError("cannot remove the last ring member")
        self.members.remove(name)
        self.weights.pop(name, None)
        self.hosts.pop(name, None)
        self.replication = min(self._want_replication, len(self.members))
        self.epoch += 1

    def weight_of(self, member: str) -> float:
        return self.weights.get(member, 1.0)

    def host_of(self, member: str) -> Optional[str]:
        return self.hosts.get(member)

    # ---- placement ----------------------------------------------------
    def preference(self, digest: str) -> List[str]:
        """ALL members, best owner first — the failover walk order.
        Ties in the (float) weighted key break on the exact integer
        score, so the order is total and platform-stable."""
        return sorted(
            self.members,
            key=lambda m: (
                _weighted_key(digest, m, self.weight_of(m)),
                _score(digest, m),
            ),
            reverse=True,
        )

    def owners(
        self, digest: str, alive: Optional[Iterable[str]] = None
    ) -> List[str]:
        """The ``replication`` members that own ``digest``, primary
        first.  With ``alive`` given, dead members are skipped and the
        next preference member stands in — so a key owned by a dead
        replica moves to exactly one new member and every other key
        stays put (the HRW minimal-movement property).

        Host-aware: the walk skips members whose host label already
        holds a copy, falling back to same-host members only when there
        are fewer distinct hosts than owners wanted — degraded
        colocation beats under-replication."""
        pref = self.preference(digest)
        if alive is not None:
            live: Set[str] = set(alive)
            pref = [m for m in pref if m in live]
        want = self.replication
        chosen: List[str] = []
        seen_hosts: Set[str] = set()
        for m in pref:
            h = self.hosts.get(m)
            if h is not None and h in seen_hosts:
                continue
            chosen.append(m)
            if h is not None:
                seen_hosts.add(h)
            if len(chosen) == want:
                return chosen
        for m in pref:  # fewer hosts than owners: colocate rather than lose
            if m not in chosen:
                chosen.append(m)
                if len(chosen) == want:
                    break
        return chosen

    def describe(self, digests: Iterable[str]) -> dict:
        """Placement table for observability (fleet stats verb)."""
        return {d: self.owners(d) for d in digests}

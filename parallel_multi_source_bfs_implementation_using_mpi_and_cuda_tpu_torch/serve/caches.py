"""Serving-side caches: LRU results + executable/compile bookkeeping.

Two caches front the engines (docs/SERVING.md):

* :class:`LRUCache` / the server's result cache — exact-request
  memoization keyed by (graph key, graph version, canonical query
  bytes).  The graph version rides in the key, so a reload invalidates
  every stale entry by construction (they age out of the LRU rather
  than needing a scan); :meth:`LRUCache.drop_where` additionally frees
  them eagerly on reload.
* :class:`ExecutableCache` — the warm-up ledger.  In the port a
  "compile" is the engine's ``compile(queries_shape)`` warm-up (the CUDA
  kernels themselves build once per process, at first use); this class
  records WHICH (graph, version, bucket) triples have been warmed and
  counts the cold warms, which is exactly what the ``stats`` verb
  reports, with the JAX package's meaning (compile count flat across
  same-bucket requests, +1 for a cold bucket).

A third cache serves the dynamic-graph subsystem (docs/SERVING.md
"Mutations & versions"):

* :class:`PlaneCache` — byte-capped LRU of certified per-query distance
  planes, keyed by (graph name, canonical query bytes) WITHOUT the
  version.  That omission is the point: unlike result-cache entries,
  which a ``mutate`` must make unreachable (stale answers are not
  answers), a stale plane is still a valid repair SEED — the entry
  records which ``(digest, version)`` it was certified against, and the
  repair path composes the delta span from there to the live version.
  Planes survive mutations by design; they age out by bytes.

All are thread-safe: connection handler threads probe the caches while
the batcher thread fills them.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Callable, Dict, Optional, Tuple


class LRUCache:
    """Bounded LRU with hit/miss/eviction counters.

    ``capacity <= 0`` disables caching (every ``get`` misses, ``put`` is
    a no-op) — the documented ``MSBFS_SERVE_RESULT_CACHE=0`` opt-out.
    """

    def __init__(self, capacity: int):
        self.capacity = int(capacity)
        self._data: OrderedDict = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def get(self, key):
        """Value or None (None is never a stored value here: entries are
        response dicts)."""
        with self._lock:
            if self.capacity <= 0 or key not in self._data:
                self.misses += 1
                return None
            self._data.move_to_end(key)
            self.hits += 1
            return self._data[key]

    def put(self, key, value) -> None:
        with self._lock:
            if self.capacity <= 0:
                return
            if key in self._data:
                self._data.move_to_end(key)
            self._data[key] = value
            while len(self._data) > self.capacity:
                self._data.popitem(last=False)
                self.evictions += 1

    def drop_where(self, predicate: Callable[[object], bool]) -> int:
        """Eagerly free entries whose key matches (reload invalidation);
        returns the count dropped."""
        with self._lock:
            stale = [k for k in self._data if predicate(k)]
            for k in stale:
                del self._data[k]
            return len(stale)

    def __len__(self) -> int:
        with self._lock:
            return len(self._data)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "size": len(self._data),
                "capacity": self.capacity,
            }


class PlaneCache:
    """Byte-capped LRU of repair-seed distance planes.

    Entries are ``(version, digest, dist)`` with ``dist`` a host (K, n)
    int32 plane certified at that version.  ``max_bytes <= 0`` disables
    (the ``MSBFS_SERVE_PLANE_CACHE_BYTES=0`` opt-out — the repair path
    then always falls back to full recompute).  Keys deliberately
    exclude the version: a mutate must NOT drop these (see module
    docstring); ``put`` overwrites the entry for a key with the newest
    plane, so each query's seed converges back toward version-fresh.
    """

    def __init__(self, max_bytes: int):
        self.max_bytes = int(max_bytes)
        self._data: OrderedDict = OrderedDict()
        self._bytes = 0
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def get(self, key) -> Optional[Tuple[int, str, object]]:
        """(version, digest, dist) or None."""
        with self._lock:
            if self.max_bytes <= 0 or key not in self._data:
                self.misses += 1
                return None
            self._data.move_to_end(key)
            self.hits += 1
            return self._data[key]

    def put(self, key, version: int, digest: str, dist) -> None:
        nbytes = int(dist.nbytes)
        with self._lock:
            if self.max_bytes <= 0 or nbytes > self.max_bytes:
                return  # a plane bigger than the cap would evict everything
            if key in self._data:
                self._bytes -= int(self._data[key][2].nbytes)
                self._data.move_to_end(key)
            self._data[key] = (int(version), str(digest), dist)
            self._bytes += nbytes
            while self._bytes > self.max_bytes and self._data:
                _, (_, _, old) = self._data.popitem(last=False)
                self._bytes -= int(old.nbytes)
                self.evictions += 1

    def drop_where(self, predicate: Callable[[object], bool]) -> int:
        """Eager invalidation for the cases where a seed really IS dead:
        a reload (new file content, no delta chain to compose) or a
        graph eviction."""
        with self._lock:
            stale = [k for k in self._data if predicate(k)]
            for k in stale:
                self._bytes -= int(self._data[k][2].nbytes)
                del self._data[k]
            return len(stale)

    def __len__(self) -> int:
        with self._lock:
            return len(self._data)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "size": len(self._data),
                "bytes": self._bytes,
                "max_bytes": self.max_bytes,
            }


class ExecutableCache:
    """Warmed-bucket registry + compile counters for the stats verb.

    A key is ``(graph_key, version, k_exec, s_pad)``.  :meth:`warm` runs
    ``warm_fn`` exactly once per cold key (under the lock of that key's
    first caller; the batcher is single-threaded so contention cannot
    actually occur — the lock is correctness insurance, not a hot path)
    and counts it as one compile against the bucket label.
    """

    def __init__(self):
        self._warmed: set = set()
        self._compiles: Dict[Tuple[str, str], int] = {}
        self._lock = threading.Lock()

    def warm(self, key, bucket_label: str, warm_fn: Callable[[], None]) -> bool:
        """Ensure ``key`` is warmed; returns True when THIS call compiled
        (cold bucket), False on a warm hit."""
        with self._lock:
            if key in self._warmed:
                return False
        warm_fn()  # outside the lock: a warm-up runs a whole batch
        with self._lock:
            if key in self._warmed:
                return False  # lost a (theoretical) race; count once
            self._warmed.add(key)
            self._compiles[bucket_label] = self._compiles.get(bucket_label, 0) + 1
        return True

    def compiles(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._compiles)

    def warmed_count(self) -> int:
        """Currently-warm bucket count (the health verb's
        ``warm_buckets``: live set size, unlike the compile odometer)."""
        with self._lock:
            return len(self._warmed)

    def total_compiles(self) -> int:
        with self._lock:
            return sum(self._compiles.values())

    def drop_where(self, predicate: Callable[[object], bool]) -> int:
        """Forget warmed keys matching ``predicate`` (graph reload: the
        rebuilt engine has fresh, unwarmed programs).  Compile counters
        are cumulative and survive — they are a lifetime odometer, not a
        live-set size."""
        with self._lock:
            stale = [k for k in self._warmed if predicate(k)]
            for k in stale:
                self._warmed.discard(k)
            return len(stale)

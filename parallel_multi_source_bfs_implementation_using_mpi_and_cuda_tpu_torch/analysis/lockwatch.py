"""Dynamic lock-order watchdog — the runtime arm of the lock pass.

``install()`` swaps ``threading.Lock``/``RLock`` for instrumented
proxies.  Each proxy is keyed by its creation site (file:line), every
thread keeps a stack of held keys, and each acquisition while holding
another key records an order edge A -> B.  Observing both A -> B and
B -> A across the run is an inversion: two threads can interleave into
a deadlock even if this run happened not to.  Inversions are recorded,
not raised inline — a detector that throws mid-test turns a latent
deadlock into a flaky suite — and read by whoever installed the
watchdog: the port's tests install it around a run of the port's
``serve`` under ``MSBFS_LOCK_WATCHDOG=1`` and uninstall it after (the
JAX package's analysis/lockwatch.py, which its conftest installs for a
whole session).

Edges between acquisitions of the *same* key (one site constructing
many locks, reentrant RLocks) are skipped: per-instance order within a
site is not a discipline the repo promises.
"""

from __future__ import annotations

import threading
import traceback
from typing import Dict, List, Optional, Set, Tuple

_state_lock = threading.Lock()  # guards the module-global edge tables
_edges: Dict[Tuple[str, str], str] = {}  # (keyA, keyB) -> witness stack line
_inversions: List[Dict[str, str]] = []
_installed: Optional[Tuple[object, object]] = None
_tls = threading.local()


def _creation_site() -> str:
    # First frame outside this module and outside threading.py.
    for frame in reversed(traceback.extract_stack()):
        fn = frame.filename
        if "lockwatch" in fn or fn.endswith("threading.py"):
            continue
        return f"{fn}:{frame.lineno}"
    return "<unknown>"


class _WatchedLock:
    """Delegating proxy around a real Lock/RLock.  __getattr__ forwards
    the private Condition hooks (_release_save/_acquire_restore/
    _is_owned), so watched RLocks keep working inside Condition."""

    def __init__(self, inner, key: str):
        self._inner = inner
        self._key = key

    def acquire(self, *a, **kw):
        got = self._inner.acquire(*a, **kw)
        if got:
            _note_acquire(self._key)
        return got

    def release(self):
        _note_release(self._key)
        return self._inner.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def __getattr__(self, name):
        return getattr(self._inner, name)


def _held() -> List[str]:
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    return stack


def _note_acquire(key: str) -> None:
    stack = _held()
    # Reentrant re-acquisition of a key already held by this thread
    # cannot deadlock against itself — no edge.
    if stack and stack[-1] != key and key not in stack:
        a, b = stack[-1], key
        with _state_lock:
            if (a, b) not in _edges:
                _edges[(a, b)] = f"{threading.current_thread().name}"
                if (b, a) in _edges:
                    _inversions.append({
                        "first": f"{a} -> {b}",
                        "second": f"{b} -> {a}",
                        "thread": threading.current_thread().name,
                        "other_thread": _edges[(b, a)],
                    })
    stack.append(key)


def _note_release(key: str) -> None:
    stack = _held()
    # Out-of-order release is legal (lock handoff patterns): drop the
    # most recent matching entry.
    for i in range(len(stack) - 1, -1, -1):
        if stack[i] == key:
            del stack[i]
            break


def armed() -> bool:
    """``MSBFS_LOCK_WATCHDOG=1``: the caller is asked to install the
    watchdog around what it runs."""
    from ..utils import knobs

    return knobs.raw("MSBFS_LOCK_WATCHDOG") == "1"


def install() -> None:
    """Swap the threading lock factories for watched ones.  Idempotent."""
    global _installed
    if _installed is not None:
        return
    real_lock, real_rlock = threading.Lock, threading.RLock
    _installed = (real_lock, real_rlock)

    def lock_factory():
        return _WatchedLock(real_lock(), _creation_site())

    def rlock_factory():
        return _WatchedLock(real_rlock(), _creation_site())

    threading.Lock = lock_factory
    threading.RLock = rlock_factory


def uninstall() -> None:
    global _installed
    if _installed is None:
        return
    threading.Lock, threading.RLock = _installed
    _installed = None


def reset() -> None:
    with _state_lock:
        _edges.clear()
        _inversions.clear()


def inversions() -> List[Dict[str, str]]:
    with _state_lock:
        return list(_inversions)


def edge_count() -> int:
    with _state_lock:
        return len(_edges)


def report() -> str:
    inv = inversions()
    if not inv:
        return f"lockwatch: {edge_count()} order edges, no inversions"
    lines = [f"lockwatch: {len(inv)} lock-order INVERSION(S):"]
    for i in inv:
        lines.append(f"  {i['first']} (thread {i['other_thread']}) vs "
                     f"{i['second']} (thread {i['thread']})")
    return "\n".join(lines)

"""Append-only daemon state journal (docs/SERVING.md "Crash recovery").

The serving daemon's durable state is tiny — which graphs are registered
(name, path, content hash) and which executable buckets have been warmed
— but losing it on a crash means every client must re-``load`` and every
first query re-compiles.  This module journals that state as JSON lines,
fsync'd per append, so a ``kill -9`` loses at most the line being
written (a torn tail is detected and dropped on replay, never
propagated).

Record grammar (one JSON object per line)::

    {"op": "load",   "name": ..., "path": ..., "hash": ...}
    {"op": "reload", "name": ..., "path": ..., "hash": ...}
    {"op": "warm",   "name": ..., "hash": ..., "k_exec": ..., "s_pad": ...}
    {"op": "mutate", "name": ..., "inserts": [[u, v], ...],
     "deletes": [[u, v], ...], "digest": ..., "token": ...}

The optional ``token`` on mutate records is the client's idempotency
token (docs/SERVING.md "Cross-machine transport & fencing"):
tolerated-absent on replay (pre-token journals stay readable), emitted
by compaction when present, and folded into the daemon's bounded dedup
window on restart so a retry that straddles a crash still re-acks
instead of re-applying.

:meth:`StateJournal.replay` folds the line stream into the reconciled
end state — last registration per name wins, warm records survive only
while their (name, hash) still matches the live registration, mutate
records form an ORDERED per-name delta chain that a load/reload resets
(new file content, fresh version 0) and compaction preserves verbatim
(each record's chained ``digest`` lets the restart verify the replayed
chain against what was journaled, the mutation analog of the loader's
``expected_hash`` contract) — and
:meth:`StateJournal.compact` atomically rewrites the file down to that
state (temp file + fsync + rename), so the journal stays proportional
to the live state, not to the daemon's lifetime.

Growth bound (round 9): a fleet replica lives for months, and reload
churn + bucket warms grow the file without limit, so :meth:`append`
auto-compacts when the file exceeds ``MSBFS_JOURNAL_MAX_BYTES``
(default 1 MiB, <= 0 disables).  Auto-compaction replays WITHOUT
tripping the ``journal_replay`` fault seam — that seam models restart
recovery, and a mid-serving compaction firing a restart-armed fault
would make every crash-replay test's trip counts time-dependent.

Fault sites ``journal_append`` / ``journal_replay`` (utils/faults.py)
let the ``crash`` kind kill the process mid-journal deterministically —
the recovery tests' stand-in for a real power cut.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from ..utils import faults, knobs

_OPS = ("load", "reload", "warm", "mutate", "shard")


def _valid_pairs(pairs) -> bool:
    """Mutate payload shape check: a list of [u, v] int pairs (bools are
    ints to json — exclude them; a corrupt journal line must drop, not
    crash the replay)."""
    if not isinstance(pairs, list):
        return False
    for p in pairs:
        if not (isinstance(p, (list, tuple)) and len(p) == 2):
            return False
        if not all(
            isinstance(x, int) and not isinstance(x, bool) for x in p
        ):
            return False
    return True


@dataclass
class JournalState:
    """The reconciled end state of a journal replay."""

    # name -> (path, hash) of the live registration
    graphs: Dict[str, Tuple[str, str]] = field(default_factory=dict)
    # (name, hash, k_exec, s_pad) warmed buckets for live registrations
    warm: Set[Tuple[str, str, int, int]] = field(default_factory=set)
    # name -> ordered mutate records ({"inserts", "deletes", "digest"})
    # for the live registration; order IS the version chain, so these
    # replay (and compact) strictly after the graph's load record
    deltas: Dict[str, List[dict]] = field(default_factory=dict)
    # name -> shard manifest record for a fleet-sharded graph: the
    # parent file's hash plus the ordered shard table ({"name", "path",
    # "hash", "lo", "hi"} each).  Last write wins — a re-plan (or a
    # reheal re-append) replaces the whole manifest, so replay restores
    # exactly the current shard topology (serve/shards.py).
    shards: Dict[str, dict] = field(default_factory=dict)
    replayed: int = 0  # records applied
    dropped: int = 0  # malformed/torn/stale lines skipped

    def records(self) -> List[dict]:
        """The state as a minimal record list (compaction's payload)."""
        out: List[dict] = []
        for n, (p, h) in sorted(self.graphs.items()):
            out.append({"op": "load", "name": n, "path": p, "hash": h})
            for d in self.deltas.get(n, ()):
                rec = {
                    "op": "mutate",
                    "name": n,
                    "inserts": d["inserts"],
                    "deletes": d["deletes"],
                    "digest": d["digest"],
                }
                if d.get("token") is not None:
                    rec["token"] = d["token"]
                out.append(rec)
        out.extend(
            {"op": "warm", "name": n, "hash": h, "k_exec": k, "s_pad": s}
            for n, h, k, s in sorted(self.warm)
        )
        out.extend(
            {
                "op": "shard",
                "name": n,
                "hash": m["hash"],
                "n": m["n"],
                "replicas": m["replicas"],
                "shards": m["shards"],
            }
            for n, m in sorted(self.shards.items())
        )
        return out


class StateJournal:
    """One journal file; append is thread-safe only under the caller's
    serialization (the server appends from its verb handlers and the
    single batcher thread, both already funneled through server locks
    for the state being journaled)."""

    def __init__(self, path: str, max_bytes: Optional[int] = None):
        self.path = path
        if max_bytes is None:
            max_bytes = knobs.get_int("MSBFS_JOURNAL_MAX_BYTES", 1 << 20)
        self.max_bytes = int(max_bytes)
        self.compactions = 0
        # Latched health gauge: False from the moment an append fails
        # until one lands again (the daemon's ``journal_writable``).
        self.writable = True

    def bytes(self) -> int:
        """Current journal size on disk (0 when it does not exist yet) —
        surfaced by the daemon's ``stats`` verb as ``journal_bytes``."""
        try:
            return os.path.getsize(self.path)
        except OSError:
            return 0

    # ---- append side ------------------------------------------------------
    def append(self, record: dict) -> None:
        """Durably append one record: write + flush + fsync, so the
        record survives a process kill the moment append returns.  A
        failed append — ENOSPC, a short write, a yanked volume — raises
        the typed :class:`~..runtime.supervisor.StorageError` (exit 12,
        docs/RESILIENCE.md "Disk exhaustion") and latches ``writable``
        False for the health verb; the DAEMON stays up (each caller
        decides whether its record was a durability promise or a warmth
        hint), and the first append that lands after the disk frees
        flips ``writable`` back.  Past ``max_bytes`` the file is
        auto-compacted down to the reconciled state (which keeps THIS
        record: compaction runs after the durable append, so a crash
        between the two still replays)."""
        from ..runtime.supervisor import StorageError

        line = json.dumps(record, separators=(",", ":"), sort_keys=True)
        try:
            faults.trip("journal_append")
            with open(self.path, "a", encoding="utf-8") as f:
                f.write(line + "\n")
                f.flush()
                os.fsync(f.fileno())
                size = f.tell()
        except OSError as exc:
            self.writable = False
            raise StorageError(
                f"journal append to {self.path} failed: {exc} — the "
                "record is NOT durable (a restart will not restore this "
                "state); free disk and retry"
            ) from exc
        self.writable = True
        if self.max_bytes > 0 and size > self.max_bytes:
            self.compact(self._replay(trip=False))
            self.compactions += 1

    # ---- replay side ------------------------------------------------------
    def replay(self) -> JournalState:
        """Read and reconcile the journal.  Missing file = empty state
        (first boot).  A torn final line — the crash-mid-append case —
        is dropped silently; a malformed line elsewhere is dropped with
        a stderr note (something other than a crash corrupted the file,
        the operator should know)."""
        return self._replay(trip=True)

    def _replay(self, trip: bool) -> JournalState:
        if trip:  # restart recovery only; auto-compaction skips the seam
            faults.trip("journal_replay")
        state = JournalState()
        try:
            with open(self.path, "r", encoding="utf-8") as f:
                raw = f.read()
        except FileNotFoundError:
            return state
        lines = raw.split("\n")
        torn_tail = bool(lines) and lines[-1] != ""
        if not torn_tail and lines:
            lines.pop()  # the empty split artifact after the final \n
        for i, line in enumerate(lines):
            if not line:
                continue
            record = self._parse(line)
            if record is None:
                state.dropped += 1
                if not (torn_tail and i == len(lines) - 1):
                    print(
                        f"msbfs serve: journal {self.path} line {i + 1} "
                        "is not a valid record; skipping it",
                        file=sys.stderr,
                    )
                continue
            if self._apply(state, record):
                state.replayed += 1
        return state

    @staticmethod
    def _parse(line: str) -> Optional[dict]:
        try:
            record = json.loads(line)
        except json.JSONDecodeError:
            return None
        if not isinstance(record, dict) or record.get("op") not in _OPS:
            return None
        return record

    @staticmethod
    def _apply(state: JournalState, record: dict) -> bool:
        """Fold one record into ``state``; False = dropped (stale warm,
        missing fields), which counts as dropped, never as replayed."""
        op = record["op"]
        name = str(record.get("name", "default"))
        if op in ("load", "reload"):
            path, digest = record.get("path"), record.get("hash")
            if not isinstance(path, str) or not isinstance(digest, str):
                state.dropped += 1
                return False
            state.graphs[name] = (path, digest)
            # A re-registration with new content strands the old warms
            # AND resets the delta chain: version 0 is the file content.
            state.warm = {
                w for w in state.warm if not (w[0] == name and w[1] != digest)
            }
            state.deltas.pop(name, None)
            return True
        if op == "mutate":
            if name not in state.graphs:
                state.dropped += 1  # chain with no base graph
                return False
            inserts = record.get("inserts")
            deletes = record.get("deletes")
            digest = record.get("digest")
            if not _valid_pairs(inserts) or not _valid_pairs(deletes) or not isinstance(digest, str):
                state.dropped += 1
                return False
            token = record.get("token")
            if token is not None and not isinstance(token, str):
                token = None  # corrupt token degrades to absent, not a crash
            state.deltas.setdefault(name, []).append(
                {"inserts": inserts, "deletes": deletes, "digest": digest,
                 "token": token}
            )
            return True
        if op == "shard":
            # Fleet shard manifest (serve/shards.py): structural check
            # field by field — a torn or hand-mangled manifest must drop
            # (the supervisor re-plans from the registered parent), not
            # crash replay or resurrect a half-table.
            digest = record.get("hash")
            table = record.get("shards")
            if (
                not isinstance(digest, str)
                or not isinstance(table, list)
                or not table  # a sharded graph with no shards is torn
            ):
                state.dropped += 1
                return False
            try:
                total_n = int(record["n"])
                replicas = int(record["replicas"])
            except (KeyError, TypeError, ValueError):
                state.dropped += 1
                return False
            if isinstance(total_n, bool) or total_n < 0 or replicas < 1:
                state.dropped += 1
                return False
            for row in table:
                if not isinstance(row, dict):
                    state.dropped += 1
                    return False
                if not all(
                    isinstance(row.get(k), str) and row.get(k)
                    for k in ("name", "path", "hash")
                ):
                    state.dropped += 1
                    return False
                lo, hi = row.get("lo"), row.get("hi")
                if not all(
                    isinstance(x, int) and not isinstance(x, bool)
                    for x in (lo, hi)
                ) or not (0 <= lo < hi <= total_n):
                    state.dropped += 1
                    return False
            state.shards[name] = {
                "hash": digest,
                "n": total_n,
                "replicas": replicas,
                "shards": table,
            }
            return True
        # op == "warm"
        digest = record.get("hash")
        live = state.graphs.get(name)
        if live is None or not isinstance(digest, str):
            state.dropped += 1
            return False
        if live[1] != digest:
            state.dropped += 1  # warm for content no longer registered
            return False
        try:
            k_exec, s_pad = int(record["k_exec"]), int(record["s_pad"])
        except (KeyError, TypeError, ValueError):
            state.dropped += 1
            return False
        state.warm.add((name, digest, k_exec, s_pad))
        return True

    # ---- compaction -------------------------------------------------------
    def compact(self, state: JournalState) -> None:
        """Atomically rewrite the journal to the reconciled state: temp
        file in the same directory, fsync, rename — a crash at any point
        leaves either the old journal or the new one, never a mix."""
        directory = os.path.dirname(os.path.abspath(self.path)) or "."
        fd, tmp = tempfile.mkstemp(
            prefix=".journal.", suffix=".tmp", dir=directory
        )
        try:
            with os.fdopen(fd, "w", encoding="utf-8") as f:
                for record in state.records():
                    f.write(
                        json.dumps(record, separators=(",", ":"),
                                   sort_keys=True) + "\n"
                    )
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.path)
        except OSError as exc:
            print(
                f"msbfs serve: journal compaction failed: {exc}; keeping "
                "the uncompacted journal",
                file=sys.stderr,
            )
            try:
                os.unlink(tmp)
            except OSError:
                pass

"""Checkpoint/resume for long query batches (``MSBFS_CHECKPOINT``).

The port's copy of the JAX package's utils/checkpoint.py, with the same
journal format byte for byte, so a journal written by either package
resumes in the other:

* queries run in chunks of ``chunk`` groups through the engine's
  ``f_values`` (or ``query_stats`` when stats are journaled);
* after each chunk the journal is rewritten whole — a ``msbfs-ckpt-v1``
  magic and the workload fingerprint, then one ``gid,F`` row (or
  ``gid,F,levels,reached`` with stats) per completed query — to a
  temporary file that is fsync'd and moved in with ``os.replace``, so a
  crash loses at most the chunk in flight;
* a restart reads the journal, skips every completed chunk and finishes
  the rest; selection then runs over the merged F values with the
  reference's argmin (ties to the lowest index, main.cu:379-397).

The fingerprint (n, directed edge count, the query shape and a hash of
the query ids) makes a journal of another graph or query set raise
instead of mixing results.
"""

from __future__ import annotations

import hashlib
import os
from typing import Optional, Tuple

import numpy as np
import torch

from ..ops.objective import select_best

_MAGIC = "msbfs-ckpt-v1"


def workload_fingerprint(n: int, num_edges: int, queries: np.ndarray) -> str:
    h = hashlib.sha256()
    h.update(f"{n}:{num_edges}:{queries.shape}".encode())
    h.update(np.ascontiguousarray(queries, dtype=np.int32).tobytes())
    return h.hexdigest()[:16]


def _host(values) -> np.ndarray:
    if isinstance(values, torch.Tensor):
        return values.cpu().numpy()
    return np.asarray(values)


class CheckpointedRunner:
    """Drives ``engine.f_values`` chunk by chunk with a resumable journal;
    ``stats`` journals per-query (levels, reached) beside F through
    ``engine.query_stats`` (rows resumed from a stats-less journal keep
    -1 placeholders)."""

    def __init__(self, engine, path: str, chunk: int = 64, stats: bool = False):
        self.engine = engine
        self.path = str(path)
        self.chunk = max(1, int(chunk))  # <= 0 would silently compute nothing
        self.stats = bool(stats)
        self.last_stats: Optional[Tuple[np.ndarray, np.ndarray]] = None

    def _read(self, fingerprint: str) -> dict:
        """{gid: (F, levels, reached)} of completed queries; {} when the
        journal is absent."""
        if not os.path.exists(self.path):
            return {}
        done = {}
        with open(self.path) as f:
            header = f.readline().strip().split(",")
            if header[:1] != [_MAGIC]:
                raise ValueError(f"{self.path}: not a checkpoint journal")
            if len(header) < 2:  # truncated: magic present, fingerprint lost
                raise ValueError(f"{self.path}: malformed checkpoint header")
            if header[1] != fingerprint:
                raise ValueError(
                    f"{self.path}: checkpoint belongs to a different "
                    f"workload (have {header[1]}, want {fingerprint})"
                )
            for line in f:
                parts = line.strip().split(",")
                # 2-column rows are F only; 4-column rows add levels,reached.
                if len(parts) >= 4:
                    done[int(parts[0])] = (
                        int(parts[1]), int(parts[2]), int(parts[3]),
                    )
                else:
                    done[int(parts[0])] = (int(parts[1]), -1, -1)
        return done

    def _write(self, fingerprint: str, done: dict) -> None:
        tmp = f"{self.path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            f.write(f"{_MAGIC},{fingerprint}\n")
            for gid in sorted(done):
                fv, lv, rc = done[gid]
                if lv >= 0 or rc >= 0:
                    f.write(f"{gid},{fv},{lv},{rc}\n")
                else:
                    f.write(f"{gid},{fv}\n")
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path)  # atomic: a crash keeps the old journal

    def run(self, n: int, num_edges: int, queries: np.ndarray) -> Tuple[np.ndarray, int]:
        """All K F values (completing missing chunks); returns (F (K,)
        int64, the number of queries computed by this call)."""
        queries = np.asarray(queries, dtype=np.int32)
        k = queries.shape[0]
        fp = workload_fingerprint(n, num_edges, queries)
        done = self._read(fp)
        computed = 0
        for lo in range(0, k, self.chunk):
            hi = min(lo + self.chunk, k)
            if all(g in done for g in range(lo, hi)):
                continue
            chunk_q = queries[lo:hi]
            stats = self.engine.query_stats(chunk_q) if self.stats else None
            if stats is not None:
                levels, reached, f = (_host(x) for x in stats)
                for g in range(lo, hi):
                    i = g - lo
                    done[g] = (int(f[i]), int(levels[i]), int(reached[i]))
            else:
                f = _host(self.engine.f_values(chunk_q))
                for g in range(lo, hi):
                    done[g] = (int(f[g - lo]), -1, -1)
            computed += hi - lo
            self._write(fp, done)
        out = np.array([done[g][0] for g in range(k)], dtype=np.int64)
        if self.stats:
            self.last_stats = (
                np.array([done[g][1] for g in range(k)], dtype=np.int32),
                np.array([done[g][2] for g in range(k)], dtype=np.int32),
            )
        return out, computed

    def best(self, n: int, num_edges: int, queries: np.ndarray) -> Tuple[int, int]:
        f, _ = self.run(n, num_edges, queries)
        arr = torch.from_numpy(f)
        min_f, min_k = select_best(arr, arr >= 0)
        return int(min_f), int(min_k)

    def clear(self) -> None:
        if os.path.exists(self.path):
            os.remove(self.path)

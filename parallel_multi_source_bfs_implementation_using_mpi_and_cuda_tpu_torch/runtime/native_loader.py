"""ctypes bindings for the native host runtime (``runtime/loader.cpp``).

The same entry points, buffer protocol and return values as the JAX
package's runtime/native_loader.py: the caller allocates every buffer
(no memory crosses the language boundary), e.g. for a graph file

  1. ``msbfs_graph_header(path, &n, &m)`` reads the header;
  2. Python allocates ``row_offsets`` (n+1 int64) and ``col_indices``
     (2m int32);
  3. ``msbfs_load_graph_csr(path, n, m, row_offsets, col_indices)``
     decodes the records into the insertion-order CSR.

The library is built at first use, from ``loader.cpp`` only, with the
host C++ compiler (``$CXX``, else ``c++``, else ``g++``) and the JAX
package's flags, into the package's ``build/`` (listed in .gitignore).
Its name carries a digest of the source, the flags, the compiler's
version and the host CPU (``-march=native``), so a changed input builds
anew.  Concurrent first uses (test workers) serialise on a lock file, and
each build writes a temporary file that ``os.replace`` moves into place,
so no process ever loads half a library.  A missing or failing compiler
raises :class:`NativeBuildError` with its output: there is no fallback.
The NumPy builds stay beside their callers as the plain versions, reached
only by an explicit ``native=False``.

``MSBFS_NATIVE_THREADS`` sets the exact thread count of every pass (all
give the same bytes at any count); unset, a pass takes the hardware's
threads, fewer on a small input.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import platform
import shutil
import subprocess
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np

# The package's build directory (listed in .gitignore): this library and
# the CUDA kernels' (runtime/kernels.py).  This module imports no torch,
# so that gen_cli needs none.
BUILD_DIR = Path(__file__).resolve().parents[1] / "build"

SOURCE = Path(__file__).resolve().with_name("loader.cpp")
CXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC", "-pthread", "-shared")


class BuildResult(NamedTuple):
    path: Path
    seconds: float  # 0.0 when an earlier build of the same sources was reused
    log: str  # the compiler's output (nvcc's: register and shared-memory use per kernel)


class NativeBuildError(RuntimeError):
    """The native runtime could not be built or loaded."""


def _compiler() -> str:
    """The host C++ compiler: ``$CXX`` when set, else ``c++`` or ``g++``."""
    names = [os.environ["CXX"]] if os.environ.get("CXX") else ["c++", "g++"]
    for name in names:
        found = shutil.which(name)
        if found:
            return found
    raise NativeBuildError(
        f"no host C++ compiler ({' or '.join(names)} not found): the native "
        f"runtime is built from {SOURCE.name} at first use"
    )


def _cpu_id() -> str:
    """The host CPU's model and feature flags (what -march=native reads)."""
    lines = [platform.machine()]
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("model name", "flags", "Features")):
                    lines.append(line.strip())
                if len(lines) == 3:
                    break
    except OSError:
        pass
    return "\n".join(lines)


def _target(cxx: str) -> Path:
    version = subprocess.run(
        [cxx, "--version"], capture_output=True, text=True, timeout=60
    ).stdout
    digest = hashlib.sha256()
    digest.update(SOURCE.read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    digest.update(version.encode())
    digest.update(_cpu_id().encode())
    return BUILD_DIR / f"loader-{digest.hexdigest()[:16]}.so"


def build() -> BuildResult:
    """Compile ``loader.cpp`` unless an up-to-date library exists; return
    its path, the build's seconds (0.0 when reused) and the compiler's
    output."""
    cxx = _compiler()
    target = _target(cxx)
    if target.exists():
        return BuildResult(target, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(target.with_suffix(".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if target.exists():  # another process built it meanwhile
            return BuildResult(target, 0.0, "")
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise NativeBuildError(
                f"{SOURCE.name} failed to build ({cxx} exit {proc.returncode}):\n"
                f"{proc.stdout}"
            )
        os.replace(tmp, target)
    return BuildResult(target, seconds, proc.stdout)


_I64 = np.ctypeslib.ndpointer(dtype=np.int64, ndim=1, flags="C_CONTIGUOUS")
_I32 = np.ctypeslib.ndpointer(dtype=np.int32, ndim=1, flags="C_CONTIGUOUS")
_EDGES = np.ctypeslib.ndpointer(dtype=np.int32, ndim=2, flags="C_CONTIGUOUS")
_L = ctypes.c_int64
_SIGNATURES = {
    "msbfs_native_threads": (ctypes.c_int, [_L]),
    "msbfs_graph_header": (
        ctypes.c_int, [ctypes.c_char_p, ctypes.POINTER(_L), ctypes.POINTER(_L)]
    ),
    "msbfs_load_graph_csr": (ctypes.c_int, [ctypes.c_char_p, _L, _L, _I64, _I32]),
    "msbfs_load_graph_csr_weighted": (
        ctypes.c_int, [ctypes.c_char_p, _L, _L, _I32, _I64, _I32, _I32]
    ),
    "msbfs_csr_from_edges": (ctypes.c_int, [_L, _L, _EDGES, _I64, _I32]),
    "msbfs_csr_from_edges_weighted": (
        ctypes.c_int, [_L, _L, _EDGES, _I32, _I64, _I32, _I32]
    ),
    "msbfs_dedup_rows": (_L, [_L, _L, _I64, _I32, _I32, _I64]),
    "msbfs_dedup_rows_weighted": (_L, [_L, _L, _I64, _I32, _I32, _I32, _I32, _I64]),
    "msbfs_split_slots": (_L, [_L, _I32, _I32, _I32, ctypes.c_int32, _I32, _I32, _I32]),
    "msbfs_row_pieces": (_L, [_L, _I32, _L, _I64, _L, ctypes.c_int, _I32]),
    "msbfs_bell_assign": (_L, [_L, _I64, ctypes.c_int, _I32, _I64, _I64, _I64, _I64]),
    "msbfs_bell_fill": (
        ctypes.c_int,
        [_L, _I64, _I64, ctypes.c_int, _I32, _I32, _L, _I64, _I64, _I64,
         ctypes.c_int32, _I32],
    ),
    "msbfs_rmat_edges": (
        ctypes.c_int,
        [ctypes.c_int32, _L, ctypes.c_double, ctypes.c_double, ctypes.c_double,
         ctypes.c_uint64, _EDGES],
    ),
    "msbfs_gr_scan": (
        ctypes.c_int, [ctypes.c_char_p, ctypes.POINTER(_L), ctypes.POINTER(_L)]
    ),
    "msbfs_gr_arcs": (ctypes.c_int, [ctypes.c_char_p, _L, _L, _I32, _I32]),
    "msbfs_snap_scan": (ctypes.c_int, [ctypes.c_char_p, ctypes.POINTER(_L)]),
    "msbfs_snap_pairs": (ctypes.c_int, [ctypes.c_char_p, _L, _I32, _I32]),
}


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """Build (if needed) and load the library, once per process."""
    path = build().path
    try:
        lib = ctypes.CDLL(str(path))
        for name, (restype, argtypes) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.restype = restype
            fn.argtypes = argtypes
    except (OSError, AttributeError) as exc:
        raise NativeBuildError(f"cannot load {path}: {exc}") from exc
    return lib


def threads(work: int) -> int:
    """The threads a pass over ``work`` items takes (a CSR build over m
    records: ``work`` = 2m)."""
    return int(library().msbfs_native_threads(int(work)))


def load_graph_csr(path: str, numpy_errors: bool = False, weights=None):
    """Decode a reference-format graph file into its insertion-order CSR;
    ``IOError`` on an unreadable header or a failed decode (rc 4: an
    endpoint out of range), as the JAX package's native decoder.  With
    ``numpy_errors`` an endpoint out of range raises the NumPy decoder's
    ``ValueError`` instead.  ``weights``, the file's (m,) record costs,
    become the graph's ``edge_weights``, a cost beside each slot."""
    from ..models.csr import CSRGraph

    lib = library()
    n = ctypes.c_int64()
    m = ctypes.c_int64()
    rc = lib.msbfs_graph_header(path.encode(), ctypes.byref(n), ctypes.byref(m))
    if rc != 0:
        raise IOError(f"native loader: cannot read header of {path} (rc={rc})")
    row_offsets = np.zeros(n.value + 1, dtype=np.int64)
    col_indices = np.zeros(2 * m.value, dtype=np.int32)
    edge_weights = None
    if weights is None:
        rc = lib.msbfs_load_graph_csr(path.encode(), n.value, m.value, row_offsets,
                                      col_indices)
    else:
        weights = np.ascontiguousarray(weights, dtype=np.int32)
        if weights.shape != (m.value,):
            raise ValueError(f"weights must be ({m.value},), got {weights.shape}")
        edge_weights = np.zeros(2 * m.value, dtype=np.int32)
        rc = lib.msbfs_load_graph_csr_weighted(path.encode(), n.value, m.value, weights,
                                               row_offsets, col_indices, edge_weights)
    if rc != 0:
        if rc == 4 and numpy_errors:
            raise ValueError(f"edge endpoint out of range [0, {n.value})")
        raise IOError(f"native loader: failed to decode {path} (rc={rc})")
    return CSRGraph(
        n=int(n.value), m=int(m.value), row_offsets=row_offsets, col_indices=col_indices,
        edge_weights=edge_weights,
    )


def csr_from_edges(n: int, edges: np.ndarray, weights=None):
    """(row_offsets, col_indices) of an (m, 2) record array; ``ValueError``
    on an endpoint outside [0, n) or beyond int32.  With ``weights`` ((m,)
    int32 record costs) a third array, the cost of every slot."""
    edges = np.asarray(edges)
    if edges.size and edges.dtype != np.int32 and (
        edges.min() < -(2**31) or edges.max() >= 2**31
    ):
        # The int32 cast would wrap, possibly onto a valid id.
        raise ValueError("edge endpoint exceeds int32")
    edges = np.ascontiguousarray(edges, dtype=np.int32)
    m = edges.shape[0]
    row_offsets = np.zeros(n + 1, dtype=np.int64)
    col_indices = np.empty(2 * m, dtype=np.int32)
    if weights is None:
        rc = library().msbfs_csr_from_edges(n, m, edges, row_offsets, col_indices)
    else:
        weights = np.ascontiguousarray(weights, dtype=np.int32)
        edge_weights = np.empty(2 * m, dtype=np.int32)
        rc = library().msbfs_csr_from_edges_weighted(
            n, m, edges, weights, row_offsets, col_indices, edge_weights
        )
    if rc == 4:
        raise ValueError(f"edge endpoint out of range [0, {n})")
    if rc != 0:
        raise ValueError(f"native csr_from_edges failed (rc={rc})")
    if weights is None:
        return row_offsets, col_indices
    return row_offsets, col_indices, edge_weights


def dedup_rows(row_offsets: np.ndarray, col_indices: np.ndarray):
    """(dst int32, deg int64): each CSR row sorted, duplicates and
    self-loops dropped, ``dst`` cut to the dedup slot count."""
    n = row_offsets.shape[0] - 1
    row_offsets = np.ascontiguousarray(row_offsets, dtype=np.int64)
    col_indices = np.ascontiguousarray(col_indices, dtype=np.int32)
    out_dst = np.empty(col_indices.shape[0], dtype=np.int32)
    out_deg = np.empty(max(n, 1), dtype=np.int64)
    w = library().msbfs_dedup_rows(
        n, col_indices.shape[0], row_offsets, col_indices, out_dst, out_deg
    )
    if w < 0:
        raise ValueError("native dedup_rows: corrupt CSR input")
    return out_dst[:w], out_deg[:n]


def dedup_rows_weighted(row_offsets: np.ndarray, col_indices: np.ndarray,
                        edge_weights: np.ndarray):
    """(dst int32, w int32, deg int64): :func:`dedup_rows` with parallel
    slots collapsed to their least cost ``w``."""
    n = row_offsets.shape[0] - 1
    row_offsets = np.ascontiguousarray(row_offsets, dtype=np.int64)
    col_indices = np.ascontiguousarray(col_indices, dtype=np.int32)
    edge_weights = np.ascontiguousarray(edge_weights, dtype=np.int32)
    out_dst = np.empty(col_indices.shape[0], dtype=np.int32)
    out_w = np.empty(col_indices.shape[0], dtype=np.int32)
    out_deg = np.empty(max(n, 1), dtype=np.int64)
    w = library().msbfs_dedup_rows_weighted(
        n, col_indices.shape[0], row_offsets, col_indices, edge_weights, out_dst, out_w,
        out_deg,
    )
    if w < 0:
        raise ValueError("native dedup_rows_weighted: corrupt CSR input")
    return out_dst[:w], out_w[:w], out_deg[:n]


def split_slots(u: np.ndarray, v: np.ndarray, w: np.ndarray, delta: int):
    """((u, v, w) of the light slots, w <= delta, and of the heavy ones):
    int32 views of one partitioned copy, each side in slot order, as
    ``(u[keep], v[keep], w[keep])`` for ``keep`` each side's mask."""
    u, v, w = (np.ascontiguousarray(a, dtype=np.int32) for a in (u, v, w))
    if not u.ndim == v.ndim == w.ndim == 1 or not u.shape == v.shape == w.shape:
        raise ValueError(f"split_slots: u, v, w must be one length, got "
                         f"{u.shape}, {v.shape}, {w.shape}")
    out = np.empty((3, w.shape[0]), dtype=np.int32)
    num_light = library().msbfs_split_slots(w.shape[0], u, v, w, np.int32(delta), *out)
    if num_light < 0:
        raise ValueError("native split_slots: bad input")
    return tuple(out[:, :num_light]), tuple(out[:, num_light:])


def row_pieces(rows: np.ndarray, piece_slots: int, cuts=None) -> np.ndarray:
    """(R, 3) int32 (start, end, owner): :func:`..models.csr.row_pieces`,
    the same bytes, in a counting pass and a threaded fill."""
    rows = np.ascontiguousarray(rows, dtype=np.int32).reshape(-1)
    cuts = np.ascontiguousarray(np.sort(cuts) if cuts is not None else [], dtype=np.int64)
    lib = library()
    args = (rows.shape[0], rows, cuts.shape[0], cuts, int(piece_slots))
    count = lib.msbfs_row_pieces(*args, 0, np.empty(0, dtype=np.int32))
    if count < 0:
        raise ValueError("native row_pieces: bad input")
    out = np.empty((count, 3), dtype=np.int32)
    lib.msbfs_row_pieces(*args, 1, out.reshape(-1))
    return out


def bell_level(item_start, item_count, item_vals, widths, sentinel_value):
    """One BELL forest level in two passes (row assignment, then the
    padded fill with the values mapped and the sentinel written):
    (flat int32, shapes, rows_per_owner int64, first_row int64), exactly
    what models/bell.py's NumPy build gives."""
    item_start = np.ascontiguousarray(item_start, dtype=np.int64)
    item_count = np.ascontiguousarray(item_count, dtype=np.int64)
    item_vals = np.ascontiguousarray(item_vals, dtype=np.int32)
    widths_arr = np.ascontiguousarray(widths, dtype=np.int32)
    v_total = item_count.shape[0]
    nb = widths_arr.shape[0]
    rows_per_owner = np.empty(max(v_total, 1), dtype=np.int64)
    first_row = np.empty(max(v_total, 1), dtype=np.int64)
    bucket_rows = np.empty(max(nb, 1), dtype=np.int64)
    flat_off = np.empty(max(nb, 1), dtype=np.int64)
    lib = library()
    slots = lib.msbfs_bell_assign(
        v_total, item_count, nb, widths_arr, rows_per_owner, first_row,
        bucket_rows, flat_off,
    )
    if slots < 0:
        raise ValueError("native bell_assign: bad input")
    flat = np.empty(slots, dtype=np.int32)
    rc = lib.msbfs_bell_fill(
        v_total, item_start, item_count, nb, widths_arr, item_vals,
        item_vals.shape[0], first_row, bucket_rows, flat_off,
        np.int32(sentinel_value), flat,
    )
    if rc != 0:
        raise ValueError(f"native bell_fill failed (rc={rc})")
    shapes = tuple((int(bucket_rows[b]), int(widths_arr[b])) for b in range(nb))
    return flat, shapes, rows_per_owner[:v_total], first_row[:v_total]



def rmat_edges(scale: int, m: int, a: float, b: float, c: float, seed: int) -> np.ndarray:
    """(m, 2) int32 R-MAT records over 2^scale vertices from the native
    sampler: models/generators.py's construction from splitmix64 streams
    (not NumPy's), a function of the seed alone at any thread count;
    ``ValueError`` on a bad scale, m or probabilities."""
    out = np.empty((m, 2), dtype=np.int32)
    rc = library().msbfs_rmat_edges(scale, m, a, b, c, seed & (2**64 - 1), out)
    if rc != 0:
        raise ValueError(f"native rmat_edges failed (rc={rc})")
    return out


_GR_ERRORS = {
    1: "cannot open file",
    2: "no 'p sp <n> <m>' header line",
    3: "malformed arc line",
    4: "arc endpoint outside 1..n",
    5: "arc count changed between scan and parse",
    6: "header vertex count exceeds int32 (reference format is int32 n)",
}

_SNAP_ERRORS = {
    1: "cannot open file",
    3: "malformed edge line (expected two integer ids)",
    5: "edge count changed between scan and parse",
    6: "vertex id exceeds int32",
}


def load_gr_arcs(path: str):
    """(n, (R, 2) int32 0-based arcs in file order) of a plain-text DIMACS
    ``.gr`` file, costs dropped; ``ValueError`` naming the fault (the
    rc of either pass) on a file utils/io.py's Python loop would refuse."""
    lib = library()
    n = _L()
    arcs = _L()
    rc = lib.msbfs_gr_scan(path.encode(), ctypes.byref(n), ctypes.byref(arcs))
    if rc != 0:
        raise ValueError(f"{path}: {_GR_ERRORS.get(rc, f'native gr_scan rc={rc}')}")
    u = np.empty(arcs.value, dtype=np.int32)
    v = np.empty(arcs.value, dtype=np.int32)
    rc = lib.msbfs_gr_arcs(path.encode(), n.value, arcs.value, u, v)
    if rc != 0:
        raise ValueError(f"{path}: {_GR_ERRORS.get(rc, f'native gr_arcs rc={rc}')}")
    return int(n.value), np.stack([u, v], axis=1)


def load_snap_pairs(path: str) -> np.ndarray:
    """(R, 2) int32 0-based pairs of a plain-text SNAP edge list, in file
    order ("#"/"%" comments and blank lines skipped); ``ValueError``
    naming the fault on a file the Python loop would refuse."""
    lib = library()
    pairs = _L()
    rc = lib.msbfs_snap_scan(path.encode(), ctypes.byref(pairs))
    if rc != 0:
        raise ValueError(f"{path}: {_SNAP_ERRORS.get(rc, f'native snap_scan rc={rc}')}")
    u = np.empty(pairs.value, dtype=np.int32)
    v = np.empty(pairs.value, dtype=np.int32)
    rc = lib.msbfs_snap_pairs(path.encode(), pairs.value, u, v)
    if rc != 0:
        raise ValueError(f"{path}: {_SNAP_ERRORS.get(rc, f'native snap_pairs rc={rc}')}")
    return np.stack([u, v], axis=1)

"""Build, load and launch the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` compiles with nvcc, for ``sm_90a`` (Hopper), into
its own shared library with a plain C interface, loaded with ctypes.  The
sources build in parallel — one nvcc process each, all started together —
at first use, into ``build/`` inside the package (listed in .gitignore);
a library is named by a hash of its sources and flags, so an unchanged
source is not rebuilt.  Nothing here runs at import time: the CPU test
suite imports every module on a machine with no nvcc and no card.

Every C entry point takes the device ordinal first and the CUDA stream
last, launches on that stream without synchronising, and returns
``cudaGetLastError()``; :func:`launch` raises on a nonzero code and counts
the launch in :mod:`..utils.timing` only when it succeeded.  A failed build
or launch raises — there is no fallback to the plain versions.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

import torch

from ..utils.timing import record_launch
from .native_loader import BUILD_DIR, BuildResult

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_U = ctypes.c_uint

# kernel name -> (C entry point, argtypes after the device ordinal and
# before the stream[, source]): the source is csrc/<name>.cu unless named
# (a library with two entry points).
KERNELS = {
    "stencil_sweep": (
        "msbfs_stencil_sweep",
        [_P, _P, _P, _L, _I, ctypes.POINTER(_I), _I, _P, _I, _I, _I, _I, _I, _I,
         _P, _P, _P, _L, _I, _I],
    ),
    "level_apply": (
        "msbfs_level_apply",
        [_P, _P, _P, _L, _I, _P, _P, _P, _P, _P, _I, _I, _I, _P, _P, _L, _P, _P, _L, _L],
    ),
    "tile_hits": (
        "msbfs_tile_hits",
        [_P, _P, _P, _P, _P, _I, _I, _I, _P, _I, _I, _I, _I, _I, _I],
    ),
    "push_or": (
        "msbfs_push_or",
        [_P, _P, _P, _P, _L, _I, _P, _L, _P, _L, _I, _P, _I],
    ),
    "ell_hits": (
        "msbfs_ell_hits",
        [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _L, _L, _I, _I, _I, _I, _P],
    ),
    "forest_or": (
        "msbfs_forest_or",
        [_P, _P, ctypes.POINTER(_L), _I, _P, _P, _P, _L, _I, _L, _I, _I, _P, _I],
    ),
    "forest_map": (
        "msbfs_forest_map",
        [_P, _L, _I, _I, _P, _I, _I, _P, _P, _P, _I],
        "forest_or",
    ),
    "forest_segment": (
        "msbfs_forest_segment",
        [_P, _L, _P, _P, _I, _L, _P, _I, _I, _I, _I, _P, _I, _I, _P, _L, _P, _I],
        "forest_or",
    ),
    "forest_gather": (
        "msbfs_forest_gather",
        [_P, _P, _P, _L, _L, _I, _I, _P, _I],
        "forest_or",
    ),
    "flag_pull": (
        "msbfs_flag_pull",
        [_P, _P, _P, _I, _P, ctypes.POINTER(_L), _I, _P, _P, _I, _P, _P, _P, _P, _P,
         _L, _I, _L, _I, _I, _I, _I, _P, _P, _P, _P, _L, _P, _L, _P, _I],
    ),
    "batch_start": (
        "msbfs_batch_start",
        [_P, _L, _L, _L, _I, _P, _L, _P, _P, _I, _P, _P, _P, _P, _P, _P, _L, _P, _L, _L],
    ),
    "csr_pull": (
        "msbfs_csr_pull",
        [_I, _P, _L, _L, _P, _P, _L, _I, _L, _L, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _P],
    ),
    "queue_expand": (
        "msbfs_queue_expand",
        [_P, _P, _L, _I, _L, _P, _P, _I, _P, _L, _P, _P, _P, _P, _P],
        "queue_push",
    ),
    "queue_compact": (
        "msbfs_queue_compact",
        [_I, _P, _P, _P, _L, _I, _L, _P, _L, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _L,
         _I, _P, _P, _P, _P, _P, _I],
        "queue_push",
    ),
    "halo_pair_or": (
        "msbfs_halo_pair_or",
        [ctypes.POINTER(_L), _I, _I, _P, _P, _I],
        "halo_exchange",
    ),
    "halo_push_match": (
        "msbfs_halo_push_match",
        [_P, _L, _P, _P, _P, _L, _P, _P, _P, _P, _P, _U],
        "halo_exchange",
    ),
    "halo_push_or": (
        "msbfs_halo_push_or",
        [_P, _L, _I, _P, _P, _P, _L, _P, _P, _L],
        "halo_exchange",
    ),
    "owner_push_expand": (
        "msbfs_owner_push_expand",
        [_P, _I, _P, _L, _P, _P, _I, _P, _L, _L, _L, _P, _P, _L, _P, _P, _P, _I, _P, _U],
        "halo_exchange",
    ),
    "weighted_relax": (
        "msbfs_weighted_relax",
        [_P, _P, _P, _I, _P, _P, _P, _L, _L, _I, _I],
    ),
    "chunk_merge": (
        "msbfs_chunk_merge",
        [ctypes.POINTER(_L), _I, _L, _I, _P, _P, _P, _P, _P, _I, _I, _P],
        "mesh_wire",
    ),
    "wire_encode": (
        "msbfs_wire_encode",
        [_P, _L, _I, _L, _P, _P, _P, _P, _U],
        "mesh_wire",
    ),
    "forest_max": (
        "msbfs_forest_max",
        [_P, _L, _P, _P, _I, _L, _P, _I, _I, _I, _I, _P, _P, _L, _L, _P, _I],
    ),
    "forest_max_commit": (
        "msbfs_forest_max_commit",
        [_P, _L, _P, _P, _I, _I, _I, _I, _I, _P, _P, _L, _L, _P, _I, _L, _L, _P, _P, _P, _I,
         _P, _I, _P],
        "forest_max",
    ),
}


class KernelError(RuntimeError):
    """A kernel failed to build, to load, or to launch."""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = os.path.join(home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise KernelError(
        "nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): the CUDA kernels "
        "are built from csrc/ at first use"
    )


def source(name: str) -> str:
    """The csrc/ file (without ``.cu``) that holds kernel ``name``."""
    return KERNELS[name][2] if len(KERNELS[name]) > 2 else name


def _target(src: str) -> Path:
    digest = hashlib.sha256()
    digest.update((CSRC_DIR / f"{src}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src}-{digest.hexdigest()[:16]}.so"


def build_all() -> Dict[str, BuildResult]:
    """Compile every kernel source that has no up-to-date library, all
    nvcc processes at once; returns each kernel's library and log (the
    kernels of one source share both)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    built: Dict[str, BuildResult] = {}
    running = {}
    for src in dict.fromkeys(source(name) for name in KERNELS):
        target = _target(src)
        if target.exists():
            built[src] = BuildResult(target, 0.0, "")
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [
            _nvcc(), *NVCC_FLAGS, "-I", str(CSRC_DIR),
            "-o", str(tmp), str(CSRC_DIR / f"{src}.cu"),
        ]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        running[src] = (proc, tmp, target, time.perf_counter())
    failures = []
    for src, (proc, tmp, target, t0) in running.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"{src}.cu (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, target)  # atomic: concurrent builders never see half a file
        built[src] = BuildResult(target, seconds, log)
    if failures:
        raise KernelError("kernel build failed:\n" + "\n".join(failures))
    return {name: built[source(name)] for name in KERNELS}


@functools.lru_cache(maxsize=None)
def library() -> Dict[str, tuple]:
    """Build (if needed) and load every kernel; name -> (C entry point,
    its library's error-string function).  Cached for the process: a
    library is loaded once."""
    fns = {}
    for name, result in build_all().items():
        lib = ctypes.CDLL(str(result.path))
        symbol, argtypes = KERNELS[name][:2]
        fn = getattr(lib, symbol)
        fn.argtypes = [_I, *argtypes, _P]
        fn.restype = _I
        err = lib.msbfs_error_string
        err.argtypes = [_I]
        err.restype = ctypes.c_char_p
        fns[name] = (fn, err)
    return fns


def launch(name: str, device: torch.device, *args, variant: str = "") -> None:
    """Launch kernel ``name`` on ``device``'s current stream; raise on a
    refused launch, count it otherwise (under ``name``, and under
    ``variant`` in the variant tally when the wrapper picked one)."""
    fn, err = library()[name]
    index = device.index if device.index is not None else torch.cuda.current_device()
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = fn(index, *args, stream)
    if rc != 0:
        raise KernelError(
            f"{name} launch failed: {err(rc).decode()} (cudaError {rc})"
        )
    record_launch(name, variant)

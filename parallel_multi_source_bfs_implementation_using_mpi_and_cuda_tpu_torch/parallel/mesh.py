"""Device meshes: a grid of ``torch.device`` entries with axis names.

The JAX package's parallel/mesh.py builds a ``jax.sharding.Mesh`` and lets
``shard_map`` place every shard.  The port keeps that one-controller
model in PyTorch's idiom: one process, a :class:`Mesh` whose entries are
explicit devices, and engines that hold one piece of state per entry and
run it on that entry's device.

An entry is a logical shard: a mesh may name the same device more than
once.  That is how the tests run a (4, 2) mesh on ``cpu`` and how one
H100 runs every sharded engine; the CLI builds meshes of distinct cards
only.  The multi-process bring-up (the JAX package's
``initialize_distributed``, ``MSBFS_COORDINATOR``) is not ported.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

QUERY_AXIS = "q"
VERTEX_AXIS = "v"

# 2D adjacency-partition axes: 'r' indexes the row block a tile serves
# (destination vertices), 'c' the column block (source vertices).
ROW_AXIS = "r"
COL_AXIS = "c"


class Mesh:
    """A grid of devices with one name per axis.

    ``devices`` is an object array of ``torch.device`` of rank
    ``len(axis_names)``; ``shape`` maps each axis name to its size, as a
    JAX mesh's does."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        grid = np.empty(np.shape(devices), dtype=object)
        for idx in np.ndindex(grid.shape):
            grid[idx] = torch.device(np.asarray(devices, dtype=object)[idx])
        if grid.ndim != len(axis_names):
            raise ValueError(f"{grid.ndim}-d device grid for axes {tuple(axis_names)}")
        self.devices = grid
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, grid.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def flat_devices(self):
        """Every entry in row-major order (rank r is entry r)."""
        return list(self.devices.reshape(-1))

    def distinct_devices(self):
        """The distinct devices, in order of first appearance."""
        return list(dict.fromkeys(self.flat_devices()))

    def __repr__(self):
        dims = ", ".join(f"{a}={s}" for a, s in self.shape.items())
        return f"Mesh({dims}, devices={[str(d) for d in self.distinct_devices()]})"


def _card_devices():
    if not torch.cuda.is_available():
        from ..runtime.supervisor import DeviceError

        raise DeviceError(
            "no CUDA device: pass ``devices`` (a logical mesh may repeat one device)"
        )
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(
    num_query_shards: Optional[int] = None,
    num_vertex_shards: int = 1,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """Build a ('q', 'v') mesh: query-parallel x vertex-parallel.

    ``num_query_shards=None`` puts every remaining device on the query
    axis.  ``devices`` default to the cards present."""
    devs = list(devices if devices is not None else _card_devices())
    if num_query_shards is None:
        if len(devs) % num_vertex_shards:
            raise ValueError(
                f"{len(devs)} devices not divisible by {num_vertex_shards} vertex shards"
            )
        num_query_shards = len(devs) // num_vertex_shards
    total = num_query_shards * num_vertex_shards
    if total > len(devs):
        raise ValueError(f"mesh wants {total} devices, only {len(devs)} available")
    grid = np.empty(total, dtype=object)
    grid[:] = devs[:total]
    return Mesh(grid.reshape(num_query_shards, num_vertex_shards), (QUERY_AXIS, VERTEX_AXIS))


def make_mesh2d(rows: int, cols: int, devices: Optional[Sequence] = None) -> Mesh:
    """Build an ('r', 'c') mesh for the 2D adjacency partition: entry
    (i, j) holds the (row block i, column block j) tile, row-major."""
    if rows < 1 or cols < 1:
        raise ValueError(f"mesh shape {rows}x{cols} must be positive")
    devs = list(devices if devices is not None else _card_devices())
    total = rows * cols
    if total > len(devs):
        raise ValueError(
            f"mesh {rows}x{cols} wants {total} devices, only {len(devs)} available"
        )
    grid = np.empty(total, dtype=object)
    grid[:] = devs[:total]
    return Mesh(grid.reshape(rows, cols), (ROW_AXIS, COL_AXIS))


def parse_mesh_spec(spec: str) -> tuple:
    """Parse an ``MSBFS_MESH=RxC`` spec into (rows, cols); anything but two
    positive integer factors raises ValueError."""
    s = str(spec).strip().lower()
    parts = s.split("x")
    if len(parts) != 2:
        raise ValueError(f"MSBFS_MESH={spec!r}: expected RxC (e.g. 4x2)")
    try:
        rows, cols = int(parts[0]), int(parts[1])
    except ValueError:
        raise ValueError(f"MSBFS_MESH={spec!r}: factors must be integers") from None
    if rows < 1 or cols < 1:
        raise ValueError(f"MSBFS_MESH={spec!r}: factors must be >= 1")
    return rows, cols


def default_mesh(max_devices: Optional[int] = None, devices: Optional[Sequence] = None) -> Mesh:
    """1-D query mesh over up to ``max_devices`` devices (the reference's
    ``-gn``); ``devices`` default to the cards present."""
    devs = list(devices if devices is not None else _card_devices())
    if max_devices is not None:
        devs = devs[: max(1, min(max_devices, len(devs)))]
    return make_mesh(num_query_shards=len(devs), devices=devs)

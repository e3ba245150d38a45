"""Device memory budget for engine routing."""

from __future__ import annotations

import torch

from . import knobs

# The JAX package's default where a backend reports no memory size; the
# port's CPU runs (tests) use it so that they route as the JAX CLI does.
DEFAULT_HBM_BYTES = 16 * 1024**3


def device_hbm_bytes(device=None, default: int = DEFAULT_HBM_BYTES) -> int:
    """Per-device memory budget: ``MSBFS_HBM_BYTES`` when set and an
    integer; else a CUDA device's total memory; else ``default``."""
    env = knobs.raw("MSBFS_HBM_BYTES")
    if env:
        try:
            return int(env)
        except ValueError:
            pass  # malformed knob falls back, like every other env knob
    if device is not None and torch.device(device).type == "cuda":
        return int(torch.cuda.get_device_properties(torch.device(device)).total_memory)
    return default

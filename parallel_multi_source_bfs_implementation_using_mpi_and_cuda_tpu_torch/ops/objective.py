"""The objective F(U) and best-query selection (reference main.cu:75-89,
379-397).

F(U) is the sum of distances over reached vertices only, in int64.  The
winner is the first strict minimum of F over valid entries (F >= 0
and ``valid``), ties to the lowest query index; with no valid entry the
result is (-1, -1).
"""

from __future__ import annotations

from typing import Tuple

import torch

_INT64_MAX = torch.iinfo(torch.int64).max


def f_of_u(dist: torch.Tensor) -> torch.Tensor:
    """Sum of non-negative distances over the last axis, int64 (reference
    main.cu:75-89): a (n,) vector gives a 0-d tensor, (K, n) gives (K,)."""
    return torch.where(dist >= 0, dist, 0).to(torch.int64).sum(dim=-1)


def select_best(
    f_values: torch.Tensor, valid: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(minF, minK) as int64 0-d tensors on ``f_values``' device."""
    dev = f_values.device
    if f_values.shape[0] == 0:
        minus_one = torch.tensor(-1, dtype=torch.int64, device=dev)
        return minus_one, minus_one.clone()
    f_values = f_values.to(torch.int64)
    valid = valid & (f_values >= 0)
    keyed = torch.where(valid, f_values, torch.full_like(f_values, _INT64_MAX))
    # argmin returns the first minimal index: the reference's tie-break.
    min_k = torch.argmin(keyed)
    any_valid = valid.any()
    min_f = torch.where(any_valid, keyed[min_k], torch.full_like(keyed[0], -1))
    min_k = torch.where(any_valid, min_k, torch.full_like(min_k, -1))
    return min_f, min_k

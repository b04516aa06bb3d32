"""The row plan of a NaN-padded batch, shared by the kernels that stop each
row at its extent: K7 (:mod:`.kalman_kernels`) and K6/K10/K11
(:mod:`.markov_kernels`).

A row's extent is 1 + its last step with a z or x entry that is not NaN
(0 for a row with none); a step past it holds only NaNs.  The plan holds
each row's extent and a stable order of the rows by extent, longest
first, so that a kernel's tile of consecutive rows runs nearly uniform
loop counts.  Plain torch on the batch's device, no host synchronisation.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["MaskedPlan", "masked_plan"]


class MaskedPlan(NamedTuple):
    """The order a kernel takes the rows in: ``rows (n,)`` int32, the
    caller's row at each position; ``extent (n,)`` int32, each position's
    row's last step with a z or x entry that is not NaN plus one (0:
    none), non-increasing."""

    rows: torch.Tensor
    extent: torch.Tensor


def masked_plan(zp: torch.Tensor, xp: torch.Tensor) -> MaskedPlan:
    """The plan of a batch ``zp (T, d, n)``, ``xp (T, l, n)`` (any
    strides): each row's extent and the rows ordered by extent, longest
    first, ties in row order (a stable sort)."""
    T = zp.shape[0]
    seen = (zp == zp).any(1) | (xp == xp).any(1)  # (T, n)
    step = torch.arange(1, T + 1, dtype=torch.int32, device=zp.device)[:, None]
    extent = torch.where(seen, step, 0).amax(0).to(torch.int32)
    order = torch.sort(T - extent, stable=True).indices
    return MaskedPlan(order.to(torch.int32), extent[order].contiguous())

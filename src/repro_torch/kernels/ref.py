"""Plain PyTorch versions of the port's kernels (the ``ref.py`` contract).

Each function here is the semantics its hand-written kernel reproduces
bit for bit.  The CPU path runs these; on the card they are the yardstick
the kernels are compared with.
"""
from __future__ import annotations

import torch

NEG = -1e30
POS = 1e30


def ref_masked_argext(scores: torch.Tensor, mask: torch.Tensor, *,
                      is_max: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """Masked first-occurrence arg-extremum over the last axis.

    Disabled entries are filled with ∓1e30, ``idx`` (int32) is the first
    index attaining the extremum of the *filled* row (so a masked entry
    can win a tie with an enabled ∓1e30 score, as ``argmax`` on the
    filled row does), and a row with no enabled entry yields ``idx == -1``
    with the fill value.  NaN scores are outside the contract.
    """
    fill = NEG if is_max else POS
    v = torch.where(mask, scores.float(), fill)
    idx = (torch.argmax(v, -1) if is_max else torch.argmin(v, -1)).int()
    some = torch.broadcast_to(mask, v.shape).any(-1)
    val = v.amax(-1) if is_max else v.amin(-1)
    return torch.where(some, idx, -1), val

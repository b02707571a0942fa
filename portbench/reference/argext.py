"""The masked first-occurrence arg-extremum in plain PyTorch: the
reference's stand-in for the program's selection kernel (a frozen copy
of the port's plain version, ``repro_torch/kernels/ref.py``)."""
from __future__ import annotations

import torch

NEG = -1e30
POS = 1e30


def masked_argext(scores: torch.Tensor, mask: torch.Tensor, *,
                  is_max: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """Over the last axis: ``idx`` (int32) is the first index attaining
    the extremum of the row with disabled entries filled with ∓1e30, -1
    where no entry is enabled; ``val`` the extremum of the filled row."""
    fill = NEG if is_max else POS
    v = torch.where(mask, scores.float(), fill)
    idx = (torch.argmax(v, -1) if is_max else torch.argmin(v, -1)).int()
    some = torch.broadcast_to(mask, v.shape).any(-1)
    val = v.amax(-1) if is_max else v.amin(-1)
    return torch.where(some, idx, -1), val


def masked_argmax(scores, mask):
    return masked_argext(scores, mask, is_max=True)


def masked_argmin(scores, mask):
    return masked_argext(scores, mask, is_max=False)

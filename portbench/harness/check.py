"""The comparison that decides ``correct``: the program's answers for a
mission drawn from the seed against the plain reference's for the same
inputs.  Every number is a count of disagreements, and every limit is 0:
the reference runs the same arithmetic in the same order, so the card
has to agree with it exactly."""
from __future__ import annotations

import numpy as np
import torch


def named_leaves(tree, name: str = "") -> list:
    """``(path, numpy array)`` of every leaf of a NamedTuple tree."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        out = []
        for field, v in zip(tree._fields, tree):
            out += named_leaves(v, f"{name}.{field}" if name else field)
        return out
    a = tree.detach().cpu().numpy() if isinstance(tree, torch.Tensor) \
        else np.asarray(tree)
    return [(name, a)]


def state_numbers(got: list, want: list) -> dict:
    """Leaves and elements of the program's final state that differ from
    the reference's (a leaf missing on either side, or of another shape
    or dtype, is a whole leaf off)."""
    g, w = dict(got), dict(want)
    leaves_off = values_off = 0
    for key in sorted(set(g) | set(w)):
        a, b = g.get(key), w.get(key)
        if a is None or b is None or a.shape != b.shape \
                or a.dtype != b.dtype:
            leaves_off += 1
            values_off += int(max(np.size(a), np.size(b)))
            continue
        n = int(np.count_nonzero(~((a == b) | ((a != a) & (b != b)))))
        leaves_off += n > 0
        values_off += n
    return dict(leaves_off=leaves_off, values_off=values_off)


def summary_numbers(got: dict, want: dict) -> dict:
    """Fields of the fleet summary that differ (exactly)."""
    keys = set(got) | set(want)
    return dict(summary_off=sum(got.get(k) != want.get(k) for k in keys))


def records_numbers(got: list, want: list) -> dict:
    """Per-tick decision records that differ, and missing or extra ones."""
    n = max(len(got), len(want))
    off = sum(1 for i in range(n)
              if i >= len(got) or i >= len(want) or got[i] != want[i])
    return dict(records_off=off)


def limits(numbers: dict) -> dict:
    """Each number beside its limit (0: an exact comparison)."""
    return {k: dict(value=v, limit=0) for k, v in numbers.items()}


def is_correct(checks: dict) -> bool:
    return bool(checks) and all(c["value"] <= c["limit"]
                                for c in checks.values())

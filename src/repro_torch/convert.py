"""numpy ↔ port NamedTuples: the port's data boundary.

:func:`from_numpy` turns any NamedTuple of numpy arrays (matched by field
name, nested queues and estimator state included) into the port's
``FleetSignals`` / ``Profiles`` / ``PolicyParams`` / ``EdgeState`` on a
device; :func:`to_numpy` goes the other way.  Dtypes are the reference's:
float32, int32 and bool, and anything else raises.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import sched
from repro_torch.sim import fleet

_DTYPES = {np.dtype(np.float32): torch.float32,
           np.dtype(np.int32): torch.int32,
           np.dtype(np.bool_): torch.bool}

# nested NamedTuple fields, by (parent class, field)
_NESTED = {(fleet.EdgeState, "eq"): sched.EdgeQueue,
           (fleet.EdgeState, "cq"): sched.CloudQueue,
           (fleet.EdgeState, "adapt"): sched.AdaptState}


def _tensor(a, device: torch.device) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype not in _DTYPES:
        raise TypeError(f"from_numpy: unsupported dtype {arr.dtype} (want "
                        f"float32, int32 or bool)")
    return torch.tensor(arr).to(device)


def from_numpy(cls, tree, device="cuda"):
    """``cls`` (a port NamedTuple class) built from ``tree``'s fields of
    the same names, each placed on ``device``."""
    dev = resolve_device(device)
    out = {}
    for name in cls._fields:
        val = getattr(tree, name)
        sub = _NESTED.get((cls, name))
        out[name] = from_numpy(sub, val, dev) if sub is not None \
            else _tensor(val, dev)
    return cls(**out)


def to_numpy(tree):
    """The same NamedTuple with every tensor leaf as a host numpy array."""
    if isinstance(tree, tuple):
        return type(tree)(*(to_numpy(v) for v in tree))
    return tree.detach().cpu().numpy()

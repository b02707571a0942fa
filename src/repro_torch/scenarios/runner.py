"""Fleet-level summaries of a final stacked state (port of the summary
half of ``repro.scenarios.runner``)."""
from __future__ import annotations

import numpy as np
import torch


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def fleet_summary(final) -> dict[str, float]:
    """Scalar fleet-level metrics from a stacked final ``EdgeState``
    (tensors on any device, or numpy arrays)."""
    success = int(_host(final.n_success).sum())
    miss = int(_host(final.n_miss).sum())
    drop = int(_host(final.n_drop).sum())
    settled = max(success + miss + drop, 1)
    return dict(
        completed=success, missed=miss, dropped=drop,
        completion_rate=success / settled,
        qos_utility=float(_host(final.qos_utility).sum()),
        qoe_utility=float(_host(final.qoe_utility).sum()),
        stolen=int(_host(final.n_stolen).sum()),
        peer_offloaded=int(_host(final.n_peer_out).sum()))

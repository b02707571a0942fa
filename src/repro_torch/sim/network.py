"""Link-shaping traces and the bandwidth-penalty convention (paper §8.5).

The subset of ``repro.sim.network`` the fleet tick program needs, copied
so the port never imports the JAX package.  Trace functions are
array-native numpy (signals are built on the host from a seed); the
bandwidth penalty is evaluated per tick on tensors.

Bandwidth-penalty convention: the penalty is the **signed** difference
``transfer_ms(SEGMENT_KB, bw(t)) − transfer_ms(SEGMENT_KB,
NOMINAL_BW_MBPS)``, exactly ``0.0`` at ``bw ≡ NOMINAL_BW_MBPS``.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

SEGMENT_KB = 38.0          # 1 s video segment size (§8.1)
NOMINAL_BW_MBPS = 20.0     # bandwidth assumed by the t̂ benchmarks


def bandwidth_penalty_ms(bw_mbps: torch.Tensor,
                         segment_kb: float = SEGMENT_KB) -> torch.Tensor:
    """Signed shaping delta vs the nominal benchmark bandwidth.

    ``scalar / tensor`` in PyTorch multiplies by the reciprocal (two
    roundings), so the numerator is a full tensor and the division is
    the correctly rounded one the reference computes; the penalty is
    then exactly ``0.0`` at nominal bandwidth.
    """
    clipped = bw_mbps.clamp(min=1e-3)
    return (torch.full_like(clipped, segment_kb * 8.0) / clipped
            - segment_kb * 8.0 / NOMINAL_BW_MBPS)


def sample_trace(fn: Callable, times: np.ndarray) -> np.ndarray:
    """Evaluate a trace over a time grid in one call (array-native traces
    evaluate vectorized; scalar-only callables fall back to a loop)."""
    times = np.asarray(times)
    try:
        out = np.asarray(fn(times), dtype=np.float32)
        if out.shape == times.shape:
            return out
    except (TypeError, ValueError):
        pass
    return np.asarray([fn(float(t)) for t in times], dtype=np.float32)


def _scalarize(out: np.ndarray, t) -> np.ndarray | float:
    return out if np.ndim(t) else float(out)


def trapezium(low: float = 0.0, high: float = 400.0,
              ramp_up: tuple[float, float] = (60_000.0, 90_000.0),
              ramp_down: tuple[float, float] = (210_000.0, 240_000.0),
              ) -> Callable[[float], float]:
    """§8.5 trapezium waveform for added one-way latency θ(t)."""
    u0, u1 = ramp_up
    d0, d1 = ramp_down
    # step ramps select an empty branch, but both ramp expressions are
    # evaluated: keep their denominators nonzero
    du = max(u1 - u0, 1e-9)
    dd = max(d1 - d0, 1e-9)

    def theta(t):
        ta = np.asarray(t, dtype=float)
        up = low + (high - low) * (ta - u0) / du
        down = high - (high - low) * (ta - d0) / dd
        out = np.where((ta < u0) | (ta >= d1), low,
                       np.where(ta < u1, up,
                                np.where(ta < d0, high, down)))
        return _scalarize(out, t)

    return theta

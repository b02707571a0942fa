"""Link-shaping traces, the bandwidth-penalty convention (paper §8.5) and
the cloud latency model of the serve engine.

The subset of ``repro.sim.network`` the fleet tick program and the serve
engine need, copied so the port never imports the JAX package.  Trace
functions are array-native numpy (signals are built on the host from a
seed); the fleet evaluates the bandwidth penalty per tick on tensors,
the serve engine's :class:`CloudLatencyModel` on host floats.

Bandwidth-penalty convention: the penalty is the **signed** difference
``transfer_ms(SEGMENT_KB, bw(t)) − transfer_ms(SEGMENT_KB,
NOMINAL_BW_MBPS)``, exactly ``0.0`` at ``bw ≡ NOMINAL_BW_MBPS``.
"""
from __future__ import annotations

import dataclasses
import math
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


def transfer_ms(size_kb: float, bw_mbps: float) -> float:
    """Transfer time of ``size_kb`` at ``bw_mbps`` (8 kb per kB)."""
    return size_kb * 8.0 / max(bw_mbps, 1e-3)


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


def constant(value: float) -> Callable[[float], float]:
    def trace(t):
        return _scalarize(np.full(np.shape(t), value, dtype=float), t)
    return trace


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


@dataclasses.dataclass
class CloudLatencyModel:
    """Actual cloud duration: FaaS execution + WAN effects (Fig 1b, 2).

    ``t̂`` is the benchmarked p95 end-to-end estimate.  A sample is a
    lognormal body calibrated so ~5 % of unshaped samples exceed t̂, plus
    the shaped deltas: added latency θ(t) and the **signed** bandwidth
    penalty relative to the nominal benchmark bandwidth.  Cold starts
    appear as a small probability of a large additive delay (§4).
    """

    median_frac: float = 0.70
    sigma: float = 0.18           # p95 of LogNormal(ln .7, .18) ≈ 0.94·t̂
    cold_start_p: float = 0.01
    cold_start_ms: float = 900.0
    latency_at: Callable[[float], float] = dataclasses.field(
        default_factory=lambda: constant(0.0))
    bandwidth_at: Callable[[float], float] = dataclasses.field(
        default_factory=lambda: constant(NOMINAL_BW_MBPS))
    segment_kb: float = SEGMENT_KB

    def shaped_delta(self, now: float) -> float:
        """θ(now) plus the signed bandwidth penalty at time ``now``."""
        return self.latency_at(now) + (
            transfer_ms(self.segment_kb, self.bandwidth_at(now))
            - self.segment_kb * 8.0 / NOMINAL_BW_MBPS)

    def sample(self, rng: np.random.Generator, t_cloud: float,
               now: float, model: str | None = None) -> float:
        body = t_cloud * float(rng.lognormal(math.log(self.median_frac),
                                             self.sigma))
        if rng.random() < self.cold_start_p:
            body += self.cold_start_ms
        return body + self.shaped_delta(now)

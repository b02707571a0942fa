"""Network and execution-latency models (paper §1.2 Figs 1–2, §8.5).

A copy of ``repro.sim.network``, kept so the port never imports the JAX
package: the link-shaping traces (``constant``, ``trapezium``, the
``cellular_bandwidth_trace`` random walk), the bandwidth-penalty
convention, and the execution-duration samplers of the event simulator
(``EdgeLatencyModel``, ``CloudLatencyModel``) with their table-backed
forms that replay the fleet's sampled ``exec_jit`` lane
(``TableEdgeLatencyModel``, ``TableCloudLatencyModel``).  Trace
functions are array-native numpy (signals are built on the host from a
seed); samplers draw from a ``numpy.random.Generator`` owned by the
simulator.  The fleet evaluates the bandwidth penalty per tick on
tensors (:func:`bandwidth_penalty_ms`); the oracle and the serve engine
on host scalars and arrays (:func:`host_bandwidth_penalty_ms`).

Bandwidth-penalty convention: the penalty is the **signed** difference
of a segment's transfer times, ``SEGMENT_KB·8 / bw(t) − SEGMENT_KB·8 /
NOMINAL_BW_MBPS``, exactly ``0.0`` at ``bw ≡ NOMINAL_BW_MBPS``.
All times ms, bandwidth Mbps, sizes kB.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np
import torch

SEGMENT_KB = 38.0          # 1 s video segment size (§8.1)
NOMINAL_BW_MBPS = 20.0     # bandwidth assumed by the t̂ benchmarks


def transfer_ms(size_kb: float, bw_mbps: float) -> float:
    """Transfer time of ``size_kb`` at ``bw_mbps`` (8 kb per kB)."""
    return size_kb * 8.0 / max(bw_mbps, 1e-3)


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


def host_bandwidth_penalty_ms(bw_mbps, segment_kb: float = SEGMENT_KB):
    """The signed shaping delta on host scalars and numpy arrays.

    The reference's branch, kept as it is: Python numbers and arrays are
    clipped with ``np.maximum``, anything else (a numpy ``float32``
    scalar from a trace) with its own ``.clip``, which keeps its dtype.
    """
    clipped = np.maximum(bw_mbps, 1e-3) if isinstance(
        bw_mbps, (int, float, np.ndarray)) else bw_mbps.clip(1e-3)
    return (segment_kb * 8.0 / clipped
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


def cellular_bandwidth_trace(seed: int = 7, duration_ms: float = 600_000.0,
                             step_ms: float = 1_000.0, lo: float = 0.25,
                             hi: float = 40.0, start: float = 18.0,
                             ) -> Callable[[float], float]:
    """Synthetic mobile 4G bandwidth trace (Fig 2c analogue).

    Bounded multiplicative random walk with occasional deep fades,
    anchored at ``bw(0) == clip(start)``; queries beyond ``duration_ms``
    wrap around (periodic extension).
    """
    rng = np.random.default_rng(seed)
    n = int(duration_ms / step_ms) + 1
    vals = np.empty(n)
    vals[0] = min(max(start, lo), hi)
    v = vals[0]
    for i in range(1, n):
        v *= math.exp(rng.normal(0.0, 0.25))
        if rng.random() < 0.04:       # deep fade (underpass / handover)
            v *= 0.08
        v = min(max(v, lo), hi)
        vals[i] = v

    def bw(t):
        idx = (np.asarray(t, dtype=float) / step_ms).astype(int) % n
        return _scalarize(vals[idx], t)

    return bw


@dataclasses.dataclass
class EdgeLatencyModel:
    """Actual edge duration t̄_i^j around the 99th-pct estimate t_i (Fig 1a).

    The estimate is a p99, so actual durations are usually *below* it —
    the slack that work stealing (§5.3) exploits.
    """

    mean_frac: float = 0.62
    sd_frac: float = 0.10
    lo_frac: float = 0.42
    hi_frac: float = 1.10   # rare overruns beyond the p99 estimate
    spike_p: float = 0.0    # transient stalls (GC pause, thermal throttle)
    spike_mult: float = 1.4

    def sample(self, rng: np.random.Generator, t_edge: float,
               now: float = 0.0, model: str | None = None) -> float:
        # ``now``/``model`` serve the table-backed subclass; the
        # distributional model ignores them
        f = rng.normal(self.mean_frac, self.sd_frac)
        f = float(np.clip(f, self.lo_frac, self.hi_frac))
        if self.spike_p and rng.random() < self.spike_p:
            f *= self.spike_mult
        return t_edge * f


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
        return self.latency_at(now) + host_bandwidth_penalty_ms(
            self.bandwidth_at(now), self.segment_kb)

    def sample(self, rng: np.random.Generator, t_cloud: float,
               now: float, model: str | None = None) -> float:
        body = t_cloud * float(rng.lognormal(math.log(self.median_frac),
                                             self.sigma))
        if rng.random() < self.cold_start_p:
            body += self.cold_start_ms
        return body + self.shaped_delta(now)


# ---------------------------------------------------------------------------
# table-backed samplers: the oracle drawing the fleet's samples
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TableEdgeLatencyModel(EdgeLatencyModel):
    """Edge durations from a per-(tick, model) multiplier table.

    ``table`` is the ``float32 [T, M]`` edge lane of
    :func:`repro_torch.scenarios.compile.compile_exec_jitter`, the array
    the fleet consumes as ``FleetSignals.exec_jit[..., 0]``, so a task
    executing at time ``now`` draws the same multiplier in both
    simulators.  The duration is ``t_edge · base_frac · table[now // dt,
    model]``; ``base_frac`` is the fleet's ``edge_frac``.
    """

    table: np.ndarray | None = None
    names: tuple[str, ...] = ()
    dt: float = 25.0
    base_frac: float = 0.62

    def __post_init__(self):
        self._idx = {n: i for i, n in enumerate(self.names)}

    def sample(self, rng: np.random.Generator, t_edge: float,
               now: float = 0.0, model: str | None = None) -> float:
        tick = min(int(now / self.dt), self.table.shape[0] - 1)
        jit = float(self.table[tick, self._idx[model]]) \
            if model is not None else 1.0
        return t_edge * self.base_frac * jit


@dataclasses.dataclass
class TableCloudLatencyModel(CloudLatencyModel):
    """Cloud durations from a per-(tick, model) multiplier table (the
    cloud lane, ``FleetSignals.exec_jit[..., 1]``).

    The multiplier scales the compute body only; θ(t) and bandwidth
    shaping stay the additive ``shaped_delta``, as in the fleet's act
    formula.  ``base_frac`` is the fleet's ``cloud_frac``; the lognormal
    and cold-start draws of the parent are bypassed, so given the table
    the sample is deterministic.
    """

    table: np.ndarray | None = None
    names: tuple[str, ...] = ()
    dt: float = 25.0
    base_frac: float = 0.80

    def __post_init__(self):
        self._idx = {n: i for i, n in enumerate(self.names)}

    def sample(self, rng: np.random.Generator, t_cloud: float,
               now: float, model: str | None = None) -> float:
        tick = min(int(now / self.dt), self.table.shape[0] - 1)
        jit = float(self.table[tick, self._idx[model]]) \
            if model is not None else 1.0
        return t_cloud * self.base_frac * jit + self.shaped_delta(now)

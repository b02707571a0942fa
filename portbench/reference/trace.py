"""Frozen copy of the port's flight-recorder counters
(``repro_torch/obs/trace.py``): the per-tick decision counters the
stream cell's decision records are read from.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class TraceSpec:
    """What the fleet tick should record.

    ``t_hat``
        the per-tick adapted cloud-latency estimate ``adapt.current``
        (the ``record_trace=True`` stream; ``[T, E, M]`` from
        :func:`~repro_torch.sim.fleet.run_fleet`, ``[R, T, E, M]`` from
        the batch paths).
    ``counters``
        the full :class:`TickCounters` decision stream.
    ``hist_bins`` / ``hist_max_ms``
        resolution of the slack/latency histograms: ``hist_bins`` equal
        buckets over ``[0, hist_max_ms)`` ms, the last bucket absorbing
        anything larger.
    """

    t_hat: bool = False
    counters: bool = False
    hist_bins: int = 32
    hist_max_ms: float = 4_000.0

    @property
    def enabled(self) -> bool:
        return self.t_hat or self.counters

    @classmethod
    def off(cls) -> "TraceSpec":
        return cls()

    @classmethod
    def full(cls, **kw) -> "TraceSpec":
        return cls(t_hat=True, counters=True, **kw)


class TickCounters(NamedTuple):
    """Per-(tick, edge) decision counters (the reference's 28 leaves, in
    its order).  Scalars are int32 per edge; per-model leaves ``[…, M]``
    and histograms ``[…, B]``.  Event counters count this tick's
    decisions; ``eq_depth``/``cq_depth``/``slots_busy`` and ``valid``
    are end-of-tick gauges."""

    # --- routing / admission events -----------------------------------
    arrivals: torch.Tensor        # tasks arriving at this edge
    admit_edge: torch.Tensor      # inserted into the edge queue
    admit_cloud: torch.Tensor     # pushed onto the cloud queue
    migrated: torch.Tensor        # §5.2 migration victims evicted
    # --- cloud pool events --------------------------------------------
    cloud_dispatch: torch.Tensor  # matured tasks dispatched into a slot
    pool_blocked: torch.Tensor    # matured but parked on a full pool
    # --- GEMS window events -------------------------------------------
    gems_moved: torch.Tensor      # Alg-1 reschedules moved to the cloud
    gems_withheld: torch.Tensor   # blocked by the GEMS-B winnability gate
    # --- edge executor events -----------------------------------------
    edge_exec: torch.Tensor       # tasks started on the edge executor
    # --- drops by cause -----------------------------------------------
    drop_infeasible: torch.Tensor  # JIT/feasibility drops
    drop_unstolen: torch.Tensor    # steal-only parked tasks that expired
    drop_qfull: torch.Tensor       # lost to a full edge or cloud queue
    drop_crash: torch.Tensor       # edge-queue tasks flushed by a crash
    drop_timeout: torch.Tensor     # parked cloud tasks past the give-up
    # --- cross-edge events (filled between ticks) ---------------------
    peer_out: torch.Tensor        # tasks exported to a peer edge
    peer_in: torch.Tensor         # tasks imported from a peer edge
    # --- per-model outcome deltas -------------------------------------
    hit: torch.Tensor             # i32[M] deadline hits
    miss: torch.Tensor            # i32[M] deadline misses
    drop: torch.Tensor            # i32[M] drops, all causes
    stolen: torch.Tensor          # i32[M] §5.3 steals
    # --- utility deltas -----------------------------------------------
    qos: torch.Tensor             # f32 QoS utility earned this tick
    qoe: torch.Tensor             # f32 QoE utility earned this tick
    # --- end-of-tick gauges -------------------------------------------
    eq_depth: torch.Tensor        # edge-queue occupancy
    cq_depth: torch.Tensor        # cloud-queue occupancy
    slots_busy: torch.Tensor      # FaaS slots still busy at tick end
    valid: torch.Tensor           # bool: this (tick, edge) cell is live
    # --- per-task tail evidence ---------------------------------------
    slack_hist: torch.Tensor      # i32[B] deadline slack of successes
    latency_hist: torch.Tensor    # i32[B] arrival→completion, successes


# TickCounters leaves that are per-tick event counts: zeroed on padded
# (valid=False) cells; the rest are gauges or outcome deltas
EVENT_FIELDS = (
    "arrivals", "admit_edge", "admit_cloud", "migrated", "cloud_dispatch",
    "pool_blocked", "gems_moved", "gems_withheld", "edge_exec",
    "drop_infeasible", "drop_unstolen", "drop_qfull", "drop_crash",
    "drop_timeout", "peer_out", "peer_in", "slack_hist", "latency_hist")


def zero_counters(n_models: int, spec: TraceSpec, lead: tuple = (), *,
                  device) -> TickCounters:
    """A fresh all-zero accumulator for one tick, every leaf leading with
    ``lead`` (the tick's batch axes)."""
    lead = tuple(lead)

    def z(shape=(), dtype=torch.int32):
        return torch.zeros(lead + shape, dtype=dtype, device=device)

    zi, zm, zb = z(), z((n_models,)), z((spec.hist_bins,))
    return TickCounters(
        arrivals=zi, admit_edge=zi, admit_cloud=zi, migrated=zi,
        cloud_dispatch=zi, pool_blocked=zi, gems_moved=zi, gems_withheld=zi,
        edge_exec=zi, drop_infeasible=zi, drop_unstolen=zi, drop_qfull=zi,
        drop_crash=zi, drop_timeout=zi, peer_out=zi, peer_in=zi,
        hit=zm, miss=zm, drop=zm, stolen=zm,
        qos=z(dtype=torch.float32), qoe=z(dtype=torch.float32),
        eq_depth=zi, cq_depth=zi, slots_busy=zi, valid=z(dtype=torch.bool),
        slack_hist=zb, latency_hist=zb)


def hist_counts(values: torch.Tensor, mask: torch.Tensor,
                spec: TraceSpec) -> torch.Tensor:
    """Bucket the masked ``values`` of the last axis into the spec's
    fixed bins → ``int32[..., B]``.

    Bin ``k`` covers ``[k·w, (k+1)·w)`` with ``w = hist_max_ms / bins``;
    negatives go to bin 0 and overflow to the last bin, so the total is
    always ``mask.sum(-1)``.  The scaled value is clamped to
    ``[0, bins - 1]`` in float before the cast to int32, which gives the
    reference's bin (a saturating cast, then a clip) for every finite
    input; the counts are a one-hot compare-and-sum, which reads nothing
    back to the host.
    """
    bins = spec.hist_bins
    # the reference multiplies by the f32 rounding of bins / max
    scale = float(np.float32(bins / spec.hist_max_ms))
    idx = (values * scale).clamp(0.0, float(bins - 1)).to(torch.int32)
    hit = (idx.unsqueeze(-1) == torch.arange(bins, dtype=torch.int32,
                                             device=idx.device)) \
        & mask.unsqueeze(-1)
    return hit.sum(-2, dtype=torch.int32)


def resolve_spec(trace, record_trace: bool = False) -> TraceSpec:
    """Normalize the public API's trace arguments to one TraceSpec.

    ``record_trace=True`` is the older alias for
    ``TraceSpec(t_hat=True)``; an explicit ``trace`` wins.
    """
    if trace is None:
        return TraceSpec(t_hat=True) if record_trace else TraceSpec()
    if not isinstance(trace, TraceSpec):
        raise TypeError(f"trace must be a TraceSpec, got {type(trace)!r}")
    return trace

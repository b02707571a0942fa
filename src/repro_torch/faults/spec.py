"""Deterministic, seeded fault schedules for the chaos engine; a copy of
``repro.faults.spec``.

A :class:`FaultSpec` is a declarative bundle of hostile events — edge
crashes, network partitions, jamming windows, correlated cloud
brownouts, DDoS-shaped arrival floods and telemetry-channel chaos —
that :mod:`repro_torch.faults.compile` lowers into *both* backends:

* dense ``FleetSignals`` lanes (``edge_up``/``link_up`` booleans, θ
  overlays added to the ``theta`` channel, bandwidth caps min'd into
  ``bw``, flood arrivals emitted through the shared sink protocol) for
  the compiled tick program, and
* the matching event-oracle models (per-edge outage windows, crash
  windows, θ/bandwidth trace transforms, the same flood arrivals) for
  :class:`repro_torch.sim.engine.Simulator`.

Everything is a frozen dataclass keyed only by scenario seed + per-fault
seed, so a schedule is reproducible bit-for-bit across backends and
across kill/restore of the streaming controller.

This module imports nothing from the rest of the package (stdlib only)
so ``scenarios.spec`` can depend on it without cycles.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


def _check_window(kind: str, start_ms: float, end_ms: float) -> None:
    if start_ms < 0.0:
        raise ValueError(f"{kind}.start_ms must be >= 0, got {start_ms}")
    if end_ms <= start_ms:
        raise ValueError(
            f"{kind} window must satisfy end_ms > start_ms, got "
            f"[{start_ms}, {end_ms})")


@dataclass(frozen=True)
class EdgeCrash:
    """Edge ``edge`` is down on ``[start_ms, end_ms)``.

    While down the edge admits nothing (arrivals re-route cloudward or
    drop, per policy), its queue is flushed as drops at crash time, and
    work stealing / new executions are suspended.  The task that was
    *in flight* at crash time completes — the model is a scheduler
    crash, not a power cut — and the edge restarts with an empty queue.
    """
    edge: int
    start_ms: float
    end_ms: float

    def __post_init__(self) -> None:
        if self.edge < 0:
            raise ValueError(f"EdgeCrash.edge must be >= 0, got {self.edge}")
        _check_window("EdgeCrash", self.start_ms, self.end_ms)


@dataclass(frozen=True)
class Partition:
    """The edge↔cloud link is severed on ``[start_ms, end_ms)``.

    Affects ``edges`` (all edges when ``None``): cloud dispatch is
    parked (tasks wait, exactly like a cloud outage seen from the
    affected edges) and GEMS pool migration across the link halts.
    Edge-local execution continues.
    """
    start_ms: float
    end_ms: float
    edges: Optional[Tuple[int, ...]] = None

    def __post_init__(self) -> None:
        _check_window("Partition", self.start_ms, self.end_ms)
        if self.edges is not None and any(e < 0 for e in self.edges):
            raise ValueError(f"Partition.edges must be >= 0: {self.edges}")


@dataclass(frozen=True)
class Jamming:
    """RF jamming on ``[start_ms, end_ms)``: the link survives but is
    shaped — a flat ``theta_ms`` penalty is added to cloud latency and
    the cellular bandwidth is capped at ``bw_cap_mbps`` for ``edges``
    (all when ``None``)."""
    start_ms: float
    end_ms: float
    theta_ms: float = 250.0
    bw_cap_mbps: float = 2.0
    edges: Optional[Tuple[int, ...]] = None

    def __post_init__(self) -> None:
        _check_window("Jamming", self.start_ms, self.end_ms)
        if self.theta_ms < 0.0:
            raise ValueError(f"Jamming.theta_ms must be >= 0: {self.theta_ms}")
        if self.bw_cap_mbps <= 0.0:
            raise ValueError(
                f"Jamming.bw_cap_mbps must be > 0: {self.bw_cap_mbps}")


@dataclass(frozen=True)
class Brownout:
    """Correlated cloud brownout: θ(t) for *every* edge gains a
    trapezoidal overlay ramping to ``theta_ms`` over ``ramp_ms`` on
    ``[start_ms, end_ms)``.  This layers on top of whatever θ model the
    scenario already carries — the DEMS-A estimator has to chase it."""
    start_ms: float
    end_ms: float
    theta_ms: float = 300.0
    ramp_ms: float = 5_000.0

    def __post_init__(self) -> None:
        _check_window("Brownout", self.start_ms, self.end_ms)
        if self.theta_ms < 0.0:
            raise ValueError(
                f"Brownout.theta_ms must be >= 0: {self.theta_ms}")
        if self.ramp_ms < 0.0:
            raise ValueError(f"Brownout.ramp_ms must be >= 0: {self.ramp_ms}")
        if 2.0 * self.ramp_ms > self.end_ms - self.start_ms:
            raise ValueError(
                "Brownout ramps overlap: 2*ramp_ms exceeds the window "
                f"({self.ramp_ms} vs [{self.start_ms}, {self.end_ms}))")


@dataclass(frozen=True)
class Flood:
    """DDoS-shaped arrival flood: ``rate_hz`` extra full-model frames
    per second are injected at ``edges`` (all when ``None``) on
    ``[start_ms, end_ms)``, attributed to a synthetic attacker drone.
    Timing is drawn from a deterministic stream keyed by
    ``(scenario seed, flood seed, edge)`` so both backends see the
    identical flood."""
    start_ms: float
    end_ms: float
    rate_hz: float = 10.0
    edges: Optional[Tuple[int, ...]] = None
    seed: int = 0

    def __post_init__(self) -> None:
        _check_window("Flood", self.start_ms, self.end_ms)
        if self.rate_hz <= 0.0:
            raise ValueError(f"Flood.rate_hz must be > 0: {self.rate_hz}")


@dataclass(frozen=True)
class TelemetryChaos:
    """Lossy at-least-once telemetry channel between the fleet and the
    streaming controller: each event is independently dropped with
    ``drop_p``, duplicated with ``dup_p``, and delayed by up to
    ``max_delay_ms`` with ``reorder_p`` (which reorders it past later
    events).  Consumed by :func:`repro_torch.faults.compile.perturb_telemetry`
    in controller tests — the dense/oracle backends see the ground
    truth, the controller sees the chaos."""
    drop_p: float = 0.0
    dup_p: float = 0.0
    reorder_p: float = 0.0
    max_delay_ms: float = 200.0
    seed: int = 0

    def __post_init__(self) -> None:
        for name in ("drop_p", "dup_p", "reorder_p"):
            v = getattr(self, name)
            if not 0.0 <= v <= 1.0:
                raise ValueError(
                    f"TelemetryChaos.{name} must be in [0, 1]: {v}")
        if self.max_delay_ms < 0.0:
            raise ValueError(
                f"TelemetryChaos.max_delay_ms must be >= 0: "
                f"{self.max_delay_ms}")


@dataclass(frozen=True)
class FaultSpec:
    """The full deterministic fault schedule for one scenario."""
    crashes: Tuple[EdgeCrash, ...] = ()
    partitions: Tuple[Partition, ...] = ()
    jamming: Tuple[Jamming, ...] = ()
    brownouts: Tuple[Brownout, ...] = ()
    floods: Tuple[Flood, ...] = ()
    telemetry: Optional[TelemetryChaos] = None

    def __post_init__(self) -> None:
        # overlapping crash windows on the same edge are contradictory
        by_edge: dict = {}
        for c in self.crashes:
            by_edge.setdefault(c.edge, []).append((c.start_ms, c.end_ms))
        for edge, wins in by_edge.items():
            wins.sort()
            for (s0, e0), (s1, _) in zip(wins, wins[1:]):
                if s1 < e0:
                    raise ValueError(
                        f"overlapping EdgeCrash windows on edge {edge}: "
                        f"[{s0}, {e0}) and [{s1}, ...)")

    def validate_edges(self, n_edges: int) -> None:
        """Raise if any fault names an edge outside ``range(n_edges)``."""
        for c in self.crashes:
            if c.edge >= n_edges:
                raise ValueError(
                    f"EdgeCrash.edge {c.edge} out of range for "
                    f"{n_edges} edges")
        for group in (self.partitions, self.jamming, self.floods):
            for f in group:
                if f.edges is not None and any(
                        e >= n_edges for e in f.edges):
                    raise ValueError(
                        f"{type(f).__name__}.edges {f.edges} out of range "
                        f"for {n_edges} edges")

    def shifted(self, dt_ms: float) -> "FaultSpec":
        """A copy with every window shifted by ``dt_ms`` (test helper)."""
        def mv(f):
            return dataclasses.replace(
                f, start_ms=f.start_ms + dt_ms, end_ms=f.end_ms + dt_ms)
        return dataclasses.replace(
            self,
            crashes=tuple(mv(c) for c in self.crashes),
            partitions=tuple(mv(p) for p in self.partitions),
            jamming=tuple(mv(j) for j in self.jamming),
            brownouts=tuple(mv(b) for b in self.brownouts),
            floods=tuple(mv(f) for f in self.floods))

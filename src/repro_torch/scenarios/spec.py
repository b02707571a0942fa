"""Declarative scenario specifications (fleet control plane); a copy of
``repro.scenarios.spec``.

A :class:`ScenarioSpec` describes *what happens* during a fleet mission —
edge sites on a 2-D plane with coverage zones and heterogeneous speeds,
drones flying waypoint routes (with spawn/despawn churn), arrival-rate
bursts, WAN latency shaping and cloud outages — independently of *how* it
is simulated.  :mod:`repro_torch.scenarios.compile` lowers a spec to

* per-edge :class:`repro_torch.sim.engine.Arrival` streams + latency traces for
  the discrete-event oracle, and
* dense per-tick array signals (drone→edge assignment baked into arrival
  masks, per-edge θ(t) and load multipliers, cloud-up mask) for the
  batched fleet tick program in :mod:`repro_torch.sim.fleet`.

All times are milliseconds, positions meters, speeds m/s.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core.task import PASSIVE, TABLE1, ModelProfile
from repro_torch.faults.spec import FaultSpec

DEFAULT_SEGMENT_MS = 1_000.0


@dataclasses.dataclass(frozen=True)
class EdgeSite:
    """One base station: position, coverage radius, relative speed.

    ``speed_factor`` scales the edge's *actual and expected* execution
    latency (>1 = slower hardware), modeling heterogeneous Jetson tiers.
    """

    x: float = 0.0
    y: float = 0.0
    radius: float = 1_500.0
    speed_factor: float = 1.0


@dataclasses.dataclass(frozen=True)
class DroneSpec:
    """One drone: a waypoint route plus optional churn window.

    The drone flies the waypoint polyline at ``speed_mps``, ping-ponging
    back and forth; ``speed_mps == 0`` or a single waypoint means it
    hovers at ``waypoints[0]``.  Outside [``spawn_ms``, ``despawn_ms``)
    the drone emits no tasks (churn / dropout).
    """

    waypoints: tuple[tuple[float, float], ...] = ((0.0, 0.0),)
    speed_mps: float = 0.0
    spawn_ms: float = 0.0
    despawn_ms: Optional[float] = None   # None → mission end


@dataclasses.dataclass(frozen=True)
class Burst:
    """Arrival-rate burst: segment rate × ``rate_mult`` during the window."""

    start_ms: float
    end_ms: float
    rate_mult: float = 2.0


@dataclasses.dataclass(frozen=True)
class CloudOutage:
    """Cloud FaaS unavailability window with post-recovery cold starts."""

    start_ms: float
    end_ms: float
    cold_ms: float = 600.0          # penalty on dispatches just after the end
    cold_window_ms: float = 3_000.0


@dataclasses.dataclass(frozen=True)
class ThetaTrapezium:
    """§8.5 trapezium added-latency waveform, optionally per edge subset."""

    low: float = 0.0
    high: float = 400.0
    ramp_up: tuple[float, float] = (60_000.0, 90_000.0)
    ramp_down: tuple[float, float] = (210_000.0, 240_000.0)
    edges: Optional[tuple[int, ...]] = None   # None → every edge


@dataclasses.dataclass(frozen=True)
class BandwidthTrace:
    """Cellular bandwidth shaping (Fig 2c analogue), per edge subset.

    Parameters mirror :func:`repro_torch.sim.network.cellular_bandwidth_trace`;
    the compiled trace applies the *signed* transfer-penalty convention
    (see ``network.py``) identically in the oracle's
    ``CloudLatencyModel.shaped_delta`` and the fleet's dense ``bw``
    signal.  The walk seed derives from ``seed`` alone (not the
    scenario's), so reseeded replicas of one mission share the same radio
    environment.
    """

    seed: int = 7
    lo: float = 0.25
    hi: float = 40.0
    start: float = 18.0
    step_ms: float = 1_000.0
    edges: Optional[tuple[int, ...]] = None   # None → every edge


@dataclasses.dataclass(frozen=True)
class DurationJitter:
    """Stochastic per-(model, tick) execution-duration multipliers.

    Both simulators draw the *same* seeded log-normal sample tables
    (``compile.compile_exec_jitter``): the fleet consumes them as the
    dense ``FleetSignals.exec_jit`` lane; the oracle indexes the
    identical tables through ``network.TableEdgeLatencyModel`` /
    ``TableCloudLatencyModel``, so fleet-vs-oracle agreement holds on
    stochastic scenarios too.  Multipliers have median 1.0
    (``exp(N(0, sigma))``) and scale only the compute body of a task —
    θ(t) and bandwidth shaping stay additive on top, matching the
    oracle's conventions.  ``sigma == 0`` yields *exactly* 1.0, making
    the zero-variance mode bit-identical to ``jitter=None``.

    ``heavy_tail_p`` mixes in Lambda cold-start-like stragglers: with
    that probability a cloud sample is further multiplied by
    ``heavy_tail_mult``.  Clip bounds keep edge samples inside the
    oracle's admissible fraction band.
    """

    edge_sigma: float = 0.10
    cloud_sigma: float = 0.18
    heavy_tail_p: float = 0.0
    heavy_tail_mult: float = 3.0
    edge_clip: tuple[float, float] = (0.68, 1.77)
    cloud_clip: tuple[float, float] = (0.40, 6.0)
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class ScenarioSpec:
    """A complete mission description, compilable to both simulators."""

    name: str
    duration_ms: float = 300_000.0
    segment_ms: float = DEFAULT_SEGMENT_MS
    model_names: tuple[str, ...] = PASSIVE
    edges: tuple[EdgeSite, ...] = (EdgeSite(),)
    drones: tuple[DroneSpec, ...] = (DroneSpec(), DroneSpec(), DroneSpec())
    bursts: tuple[Burst, ...] = ()
    outages: tuple[CloudOutage, ...] = ()
    theta: Optional[ThetaTrapezium] = None
    bandwidth: Optional[BandwidthTrace] = None
    # each edge's share of the bounded cloud FaaS concurrency: the
    # oracle Simulator's ``cloud_concurrency`` and the fleet simulator's
    # per-edge ``cloud_slots`` (small values → queue-wait under load)
    cloud_concurrency: int = 16
    # stochastic execution durations (None → deterministic Table-1 means)
    jitter: Optional[DurationJitter] = None
    # chaos-engine fault schedule (None → no injected faults); see
    # repro_torch.faults.spec.FaultSpec for the catalogue
    faults: Optional[FaultSpec] = None
    # QoE windows on every model: ``(alpha, beta)`` overrides the
    # Table-1 profiles' (QoS-only) zeros, Table-2 style — live windowed
    # workloads for GEMS policies and the degradation scoreboard
    qoe: Optional[tuple[float, float]] = None
    seed: int = 0

    def __post_init__(self) -> None:
        """Reject out-of-range / contradictory specs with a clear error
        instead of silently compiling garbage signals."""
        if self.duration_ms <= 0.0:
            raise ValueError(
                f"duration_ms must be > 0, got {self.duration_ms}")
        if self.segment_ms <= 0.0:
            raise ValueError(
                f"segment_ms must be > 0, got {self.segment_ms}")
        if not self.edges:
            raise ValueError("a scenario needs at least one edge site")
        if self.cloud_concurrency <= 0:
            raise ValueError(
                f"cloud_concurrency must be >= 1, got "
                f"{self.cloud_concurrency}")
        for e in self.edges:
            if e.radius <= 0.0 or e.speed_factor <= 0.0:
                raise ValueError(
                    f"EdgeSite radius/speed_factor must be > 0: {e}")
        for d in self.drones:
            if d.despawn_ms is not None and d.despawn_ms <= d.spawn_ms:
                raise ValueError(
                    f"DroneSpec despawn_ms must exceed spawn_ms: {d}")
        for b in self.bursts:
            if b.end_ms <= b.start_ms or b.start_ms < 0.0:
                raise ValueError(
                    f"Burst window must satisfy 0 <= start < end: {b}")
            if b.rate_mult <= 0.0:
                raise ValueError(f"Burst rate_mult must be > 0: {b}")
        wins = sorted((o.start_ms, o.end_ms) for o in self.outages)
        for (s, e) in wins:
            if e <= s or s < 0.0:
                raise ValueError(
                    f"CloudOutage window must satisfy 0 <= start < end: "
                    f"[{s}, {e})")
        for (s0, e0), (s1, _) in zip(wins, wins[1:]):
            if s1 < e0:
                raise ValueError(
                    f"overlapping CloudOutage windows: [{s0}, {e0}) and "
                    f"[{s1}, ...)")
        for o in self.outages:
            if o.cold_ms < 0.0 or o.cold_window_ms < 0.0:
                raise ValueError(
                    f"CloudOutage cold_ms/cold_window_ms must be >= 0: {o}")
        j = self.jitter
        if j is not None:
            if j.edge_sigma < 0.0 or j.cloud_sigma < 0.0:
                raise ValueError(
                    f"DurationJitter sigmas must be >= 0: {j}")
            if not 0.0 <= j.heavy_tail_p <= 1.0:
                raise ValueError(
                    f"DurationJitter heavy_tail_p must be in [0, 1]: {j}")
            for name, clip in (("edge_clip", j.edge_clip),
                               ("cloud_clip", j.cloud_clip)):
                if clip[0] < 0.0 or clip[1] < clip[0]:
                    raise ValueError(
                        f"DurationJitter {name} must satisfy "
                        f"0 <= lo <= hi: {clip}")
        if self.qoe is not None:
            alpha, beta = self.qoe
            if not 0.0 < alpha <= 1.0 or beta < 0.0:
                raise ValueError(
                    f"qoe must satisfy 0 < alpha <= 1 and beta >= 0, "
                    f"got {self.qoe}")
        if self.faults is not None:
            # FaultSpec fields self-validate in their own __post_init__;
            # edge indices can only be checked against this spec
            self.faults.validate_edges(self.n_edges)

    @property
    def models(self) -> list[ModelProfile]:
        ms = [TABLE1[n] for n in self.model_names]
        if self.qoe is not None:
            alpha, beta = self.qoe
            ms = [dataclasses.replace(m, qoe_alpha=alpha, qoe_beta=beta)
                  for m in ms]
        return ms

    @property
    def n_edges(self) -> int:
        return len(self.edges)

    @property
    def n_drones(self) -> int:
        return len(self.drones)

    def edge_models(self, e: int) -> list[ModelProfile]:
        """Model table as seen by edge ``e`` (speed factor folded into t)."""
        sf = self.edges[e].speed_factor
        if sf == 1.0:
            return self.models
        return [dataclasses.replace(m, t_edge=m.t_edge * sf)
                for m in self.models]

    def drone_alive(self, d: int, t: float) -> bool:
        dr = self.drones[d]
        end = self.duration_ms if dr.despawn_ms is None else dr.despawn_ms
        return dr.spawn_ms <= t < end

    def reseeded(self, seeds: tuple[int, ...]) -> tuple["ScenarioSpec", ...]:
        """Replicas of this mission differing only in the RNG seed (the
        unit of a seed sweep)."""
        return tuple(dataclasses.replace(self, seed=s) for s in seeds)

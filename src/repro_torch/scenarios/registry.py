"""Named scenario library; a copy of ``repro.scenarios.registry``.

Each entry is a zero-argument builder returning a fresh
:class:`ScenarioSpec`; ``get(name)`` also accepts overrides (e.g. a
shorter ``duration_ms`` for tests and quick sweeps).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.core.task import ACTIVE, PASSIVE
from repro_torch.faults import (Brownout, EdgeCrash, FaultSpec, Flood,
                                Jamming, Partition)
from repro_torch.scenarios.spec import (BandwidthTrace, Burst, CloudOutage,
                                        DroneSpec, DurationJitter, EdgeSite,
                                        ScenarioSpec, ThetaTrapezium)


def baseline() -> ScenarioSpec:
    """The paper's 3D-P workload as a degenerate scenario: one edge, three
    hovering drones, no events — compiles bit-for-bit to ``task_stream``."""
    return ScenarioSpec(name="baseline")


def rush_hour() -> ScenarioSpec:
    """Arrival burst: every drone triples its segment rate for a minute
    (VIP convoy passes through) while the fleet keeps steady elsewhere."""
    return ScenarioSpec(
        name="rush-hour",
        edges=(EdgeSite(0, 0), EdgeSite(3_000, 0)),
        drones=(DroneSpec(waypoints=((0.0, 100.0),)),
                DroneSpec(waypoints=((100.0, 0.0),)),
                DroneSpec(waypoints=((3_000.0, 100.0),)),
                DroneSpec(waypoints=((2_900.0, 0.0),))),
        bursts=(Burst(start_ms=60_000.0, end_ms=120_000.0, rate_mult=3.0),))


def roaming_vips() -> ScenarioSpec:
    """Two VIP drones commute across three coverage zones (handover) while
    two station-keeping drones hold the end zones (active workload)."""
    return ScenarioSpec(
        name="roaming-vips",
        model_names=ACTIVE,
        edges=(EdgeSite(0, 0), EdgeSite(2_500, 0), EdgeSite(5_000, 0)),
        drones=(DroneSpec(waypoints=((0.0, 0.0), (5_000.0, 0.0)),
                          speed_mps=25.0),
                DroneSpec(waypoints=((5_000.0, 200.0), (0.0, 200.0)),
                          speed_mps=18.0),
                DroneSpec(waypoints=((100.0, 0.0),)),
                DroneSpec(waypoints=((4_900.0, 0.0),))))


def flaky_cloud() -> ScenarioSpec:
    """§8.5 trapezium WAN latency plus a hard cloud outage with cold
    starts on recovery — the regime where edge-heavy policies win."""
    return ScenarioSpec(
        name="flaky-cloud",
        theta=ThetaTrapezium(),
        outages=(CloudOutage(start_ms=150_000.0, end_ms=180_000.0,
                             cold_ms=900.0, cold_window_ms=5_000.0),))


def hetero_edges() -> ScenarioSpec:
    """Heterogeneous edge tiers: an Orin-class fast site, a Nano-class
    slow site, and a nominal one, each serving local drones."""
    return ScenarioSpec(
        name="hetero-edges",
        edges=(EdgeSite(0, 0, speed_factor=0.7),
               EdgeSite(3_000, 0, speed_factor=1.0),
               EdgeSite(6_000, 0, speed_factor=1.6)),
        drones=tuple(DroneSpec(waypoints=((x, 0.0),))
                     for x in (0.0, 100.0, 3_000.0, 3_100.0, 6_000.0,
                               6_100.0)))


def churn() -> ScenarioSpec:
    """Drone churn: staggered spawns and dropouts (battery swaps, crashes)
    across two sites — arrival load ramps up, shifts, and decays."""
    d = 300_000.0
    return ScenarioSpec(
        name="churn",
        edges=(EdgeSite(0, 0), EdgeSite(3_000, 0)),
        drones=(DroneSpec(waypoints=((0.0, 0.0),), despawn_ms=0.6 * d),
                DroneSpec(waypoints=((100.0, 0.0),), spawn_ms=0.2 * d),
                DroneSpec(waypoints=((200.0, 0.0),), spawn_ms=0.4 * d,
                          despawn_ms=0.8 * d),
                DroneSpec(waypoints=((3_000.0, 0.0),), despawn_ms=0.5 * d),
                DroneSpec(waypoints=((3_100.0, 0.0),), spawn_ms=0.1 * d),
                DroneSpec(waypoints=((3_200.0, 0.0),), spawn_ms=0.5 * d)))


def cloud_crunch() -> ScenarioSpec:
    """Finite cloud pool under pressure: each edge's FaaS share shrinks to
    two concurrent slots while a mid-mission burst quadruples arrivals —
    the GEMS_STRESS-style regime where cloud *queue-wait*, not WAN
    latency, is what the scheduler must adapt around."""
    return ScenarioSpec(
        name="cloud-crunch",
        cloud_concurrency=2,
        bursts=(Burst(start_ms=10_000.0, end_ms=40_000.0, rate_mult=4.0),))


def bw_fade() -> ScenarioSpec:
    """Cellular deep fade: the edge↔cloud link's bandwidth walks far below
    the nominal 20 Mbps (Fig 2c), inflating every transfer by the signed
    penalty convention — edge-leaning policies should win."""
    return ScenarioSpec(
        name="bw-fade",
        bandwidth=BandwidthTrace(seed=11, lo=0.3, hi=6.0, start=2.0))


def duration_jitter() -> ScenarioSpec:
    """Stochastic execution durations (Fig 1 distributions): two edges of
    four drones with log-normal per-(tick, model) duration multipliers on
    both the Jetson-class edge and the Lambda cloud — the fidelity regime
    where *tail* latency, not mean latency, decides deadline hits.
    Multi-edge, so ``*-COOP`` policies get same-sample oracle validation
    through the lockstep :class:`~repro_torch.sim.engine.FleetOracle`."""
    return ScenarioSpec(
        name="duration-jitter",
        edges=(EdgeSite(0, 0), EdgeSite(3_000, 0)),
        drones=(DroneSpec(waypoints=((0.0, 100.0),)),
                DroneSpec(waypoints=((100.0, 0.0),)),
                DroneSpec(waypoints=((3_000.0, 100.0),)),
                DroneSpec(waypoints=((2_900.0, 0.0),))),
        jitter=DurationJitter(edge_sigma=0.10, cloud_sigma=0.18))


def heavy_tail() -> ScenarioSpec:
    """Long-tailed cloud durations (Fig 1b): moderate body jitter plus a
    5 % chance any cloud sample triples (Lambda cold-start-shaped
    stragglers) — p99 deadline-hit is where policies separate."""
    return ScenarioSpec(
        name="heavy-tail",
        jitter=DurationJitter(edge_sigma=0.08, cloud_sigma=0.25,
                              heavy_tail_p=0.05, heavy_tail_mult=3.0))


def flash_crowd() -> ScenarioSpec:
    """Hostile demand spike: a legitimate crowd surge (3× burst) with an
    attacker flood riding inside it — admission control and backpressure
    must shed without starving the real traffic."""
    return ScenarioSpec(
        name="flash-crowd",
        edges=(EdgeSite(0, 0), EdgeSite(3_000, 0)),
        drones=(DroneSpec(waypoints=((0.0, 100.0),)),
                DroneSpec(waypoints=((100.0, 0.0),)),
                DroneSpec(waypoints=((3_000.0, 100.0),)),
                DroneSpec(waypoints=((2_900.0, 0.0),))),
        bursts=(Burst(start_ms=30_000.0, end_ms=90_000.0, rate_mult=3.0),),
        faults=FaultSpec(
            floods=(Flood(start_ms=40_000.0, end_ms=80_000.0,
                          rate_hz=6.0),)))


def ddos_flood() -> ScenarioSpec:
    """Adversarial arrival flood: one edge takes ~25 Hz of junk inference
    requests for a minute — far past its service rate, so survival means
    dropping cheaply and keeping the ledger exact, not keeping up."""
    return ScenarioSpec(
        name="ddos-flood",
        faults=FaultSpec(
            floods=(Flood(start_ms=30_000.0, end_ms=90_000.0,
                          rate_hz=25.0, edges=(0,)),)))


def partition() -> ScenarioSpec:
    """Network partition + edge crash: edge 0 loses its WAN uplink for
    30 s (dispatches park, GEMS migration halts) while edge 1's
    scheduler crashes mid-window (queue flushed, arrivals re-route
    cloud-ward) — the compound-failure regime."""
    return ScenarioSpec(
        name="partition",
        edges=(EdgeSite(0, 0), EdgeSite(3_000, 0)),
        drones=(DroneSpec(waypoints=((0.0, 100.0),)),
                DroneSpec(waypoints=((100.0, 0.0),)),
                DroneSpec(waypoints=((3_000.0, 100.0),)),
                DroneSpec(waypoints=((2_900.0, 0.0),))),
        faults=FaultSpec(
            partitions=(Partition(start_ms=40_000.0, end_ms=70_000.0,
                                  edges=(0,)),),
            crashes=(EdgeCrash(edge=1, start_ms=50_000.0,
                               end_ms=65_000.0),)))


def brownout() -> ScenarioSpec:
    """Correlated cloud brownout: every edge's WAN latency ramps to a
    +350 ms plateau and back (trapezoid layered on θ(t)) — the slow-burn
    degradation where adaptive estimators must steer work edge-ward.
    Runs the ACTIVE workload so QoE windows are live and the
    degradation scoreboard gets a QoE-retention row."""
    return ScenarioSpec(
        name="brownout",
        model_names=ACTIVE,
        qoe=(0.85, 480.0),
        faults=FaultSpec(
            brownouts=(Brownout(start_ms=30_000.0, end_ms=210_000.0,
                                theta_ms=350.0, ramp_ms=20_000.0),)))


SCENARIOS: dict[str, Callable[[], ScenarioSpec]] = {
    "baseline": baseline,
    "rush-hour": rush_hour,
    "roaming-vips": roaming_vips,
    "flaky-cloud": flaky_cloud,
    "hetero-edges": hetero_edges,
    "churn": churn,
    "cloud-crunch": cloud_crunch,
    "bw-fade": bw_fade,
    "duration-jitter": duration_jitter,
    "heavy-tail": heavy_tail,
    "flash-crowd": flash_crowd,
    "ddos-flood": ddos_flood,
    "partition": partition,
    "brownout": brownout,
}


def names() -> tuple[str, ...]:
    return tuple(SCENARIOS)


def get(name: str, **overrides) -> ScenarioSpec:
    if name not in SCENARIOS:
        raise ValueError(f"unknown scenario {name!r}; choose from "
                         f"{sorted(SCENARIOS)}")
    spec = SCENARIOS[name]()
    return dataclasses.replace(spec, **overrides) if overrides else spec

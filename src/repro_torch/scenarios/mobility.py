"""Drone mobility and edge-coverage geometry on the 2-D plane; a copy of
``repro.scenarios.mobility``.

Pure functions from (spec, drone, time) to positions and covering edges —
shared by the oracle and the fleet compilers so both simulators see the
exact same drone→edge handover times.
"""
from __future__ import annotations

import math

from repro_torch.scenarios.spec import DroneSpec, ScenarioSpec


def position(drone: DroneSpec, t_ms: float) -> tuple[float, float]:
    """Drone position at ``t_ms``: ping-pong along the waypoint polyline."""
    wps = drone.waypoints
    if drone.speed_mps <= 0.0 or len(wps) < 2:
        return wps[0]
    seg_len = [math.dist(wps[i], wps[i + 1]) for i in range(len(wps) - 1)]
    total = sum(seg_len)
    if total <= 0.0:
        return wps[0]
    traveled = drone.speed_mps * (t_ms / 1_000.0)
    s = math.fmod(traveled, 2.0 * total)
    if s > total:                       # returning leg of the ping-pong
        s = 2.0 * total - s
    for i, L in enumerate(seg_len):
        if s <= L or i == len(seg_len) - 1:
            f = 0.0 if L == 0.0 else min(s / L, 1.0)
            (x0, y0), (x1, y1) = wps[i], wps[i + 1]
            return (x0 + f * (x1 - x0), y0 + f * (y1 - y0))
        s -= L
    return wps[-1]


def covering_edge(spec: ScenarioSpec, pos: tuple[float, float]) -> int:
    """Index of the edge serving ``pos``: nearest in-coverage site, falling
    back to the nearest site overall when no coverage zone contains it."""
    dists = [math.dist(pos, (e.x, e.y)) for e in spec.edges]
    in_range = [i for i, (d, e) in enumerate(zip(dists, spec.edges))
                if d <= e.radius]
    pool = in_range if in_range else range(len(spec.edges))
    return min(pool, key=lambda i: dists[i])


def assignment(spec: ScenarioSpec, d: int, t_ms: float) -> int:
    """Edge homing drone ``d``'s arrivals at time ``t_ms`` (handover)."""
    return covering_edge(spec, position(spec.drones[d], t_ms))

"""Lower a :class:`~repro_torch.faults.spec.FaultSpec` into backend
inputs; a copy of ``repro.faults.compile``, drawing the same seeded
streams.

Everything here is deliberately *shared* between the two consumers:

* the fleet compiler (:func:`repro_torch.scenarios.compile.compile_fleet`)
  evaluates the overlay/cap callables on the tick grid and merges the
  boolean lanes into ``FleetSignals``;
* the oracle runner wraps the same callables around each edge's
  ``theta_fn``/``bw_fn`` and feeds the window lists to
  :class:`repro_torch.sim.engine.Simulator`.

Because both sides consume the *same* functions and the *same* seeded
event lists, a fault schedule means the identical thing in either
backend — which is what lets the fleet-vs-oracle agreement tests extend
to hostile conditions.
"""
from __future__ import annotations

from typing import Callable, Iterable, List, Sequence, Tuple

import numpy as np

from repro_torch.faults.spec import FaultSpec, TelemetryChaos

# deterministic RNG stream tags (decimal-safe, disjoint from the
# scenario compiler's 0x6275 burst / 0x4A17 jitter / 0x0dde order tags)
_FLOOD_TAG = 0xF10D
_TELEM_TAG = 0x7E1E


def _affects(edges, e: int) -> bool:
    return edges is None or e in edges


def _in_window(t: np.ndarray, start: float, end: float) -> np.ndarray:
    return (t >= start) & (t < end)


# ---------------------------------------------------------------------------
# boolean availability lanes (fleet) / window lists (oracle)
# ---------------------------------------------------------------------------

def edge_up_dense(faults: FaultSpec, times: np.ndarray,
                  n_edges: int) -> np.ndarray:
    """``bool [T, E]`` — False while the edge is crashed."""
    up = np.ones((len(times), n_edges), dtype=bool)
    for c in faults.crashes:
        if c.edge < n_edges:
            up[_in_window(times, c.start_ms, c.end_ms), c.edge] = False
    return up


def link_up_dense(faults: FaultSpec, times: np.ndarray,
                  n_edges: int) -> np.ndarray:
    """``bool [T, E]`` — False while the edge↔cloud link is partitioned."""
    up = np.ones((len(times), n_edges), dtype=bool)
    for p in faults.partitions:
        mask = _in_window(times, p.start_ms, p.end_ms)
        for e in range(n_edges):
            if _affects(p.edges, e):
                up[mask, e] = False
    return up


def crash_windows(faults: FaultSpec,
                  n_edges: int) -> List[Tuple[Tuple[float, float], ...]]:
    """Per-edge sorted ``(start, end)`` crash windows for the oracle."""
    out: List[List[Tuple[float, float]]] = [[] for _ in range(n_edges)]
    for c in faults.crashes:
        if c.edge < n_edges:
            out[c.edge].append((c.start_ms, c.end_ms))
    return [tuple(sorted(w)) for w in out]


def partition_windows(faults: FaultSpec,
                      n_edges: int) -> List[Tuple[Tuple[float, float], ...]]:
    """Per-edge sorted ``(start, end)`` partition windows.

    The oracle models a partition as a per-edge cloud outage with no
    cold-start penalty: dispatch parks, pending tasks wait, and the
    DEMS/GEMS policies see exactly what the fleet's ``link_up`` gate
    produces.
    """
    out: List[List[Tuple[float, float]]] = [[] for _ in range(n_edges)]
    for p in faults.partitions:
        for e in range(n_edges):
            if _affects(p.edges, e):
                out[e].append((p.start_ms, p.end_ms))
    return [tuple(sorted(w)) for w in out]


# ---------------------------------------------------------------------------
# θ overlays and bandwidth caps (array-native; both backends call these)
# ---------------------------------------------------------------------------

def theta_overlay_fn(faults: FaultSpec,
                     edge: int) -> Callable[[float], float]:
    """Added WAN latency (ms) for ``edge`` as an array-native f(t_ms).

    Sum of every jamming window covering the edge (flat penalty) and
    every correlated brownout (trapezoidal ramp, all edges).  Returns a
    plain ``lambda t: 0.0``-equivalent when nothing applies, so wrapping
    is free for fault-free scenarios.
    """
    jams = [j for j in faults.jamming if _affects(j.edges, edge)]
    brs = list(faults.brownouts)

    def fn(t):
        ts = np.asarray(t, dtype=np.float64)
        add = np.zeros_like(ts)
        for j in jams:
            add = add + np.where(
                _in_window(ts, j.start_ms, j.end_ms), j.theta_ms, 0.0)
        for b in brs:
            ramp = max(b.ramp_ms, 1e-9)
            shape = np.minimum(
                np.clip((ts - b.start_ms) / ramp, 0.0, 1.0),
                np.clip((b.end_ms - ts) / ramp, 0.0, 1.0))
            add = add + np.where(
                _in_window(ts, b.start_ms, b.end_ms),
                b.theta_ms * shape, 0.0)
        return add
    return fn


def bw_cap_fn(faults: FaultSpec, edge: int) -> Callable[[float], float]:
    """Bandwidth ceiling (Mbps) for ``edge``, ``+inf`` outside jamming."""
    jams = [j for j in faults.jamming if _affects(j.edges, edge)]

    def fn(t):
        ts = np.asarray(t, dtype=np.float64)
        cap = np.full(ts.shape, np.inf)
        for j in jams:
            cap = np.where(_in_window(ts, j.start_ms, j.end_ms),
                           np.minimum(cap, j.bw_cap_mbps), cap)
        return cap
    return fn


# ---------------------------------------------------------------------------
# DDoS-shaped arrival floods (shared event list → both sinks)
# ---------------------------------------------------------------------------

def flood_events(scenario_seed: int, faults: FaultSpec, n_edges: int,
                 n_models: int, duration_ms: float,
                 n_drones: int = 0) -> List[Tuple[float, int, int, np.ndarray]]:
    """Deterministic flood arrivals as ``(t_ms, drone, edge, order)``.

    One event is one full-model frame (the same unit the benign stream
    emits), attributed to a synthetic attacker drone id past the real
    fleet.  The stream is keyed ``[scenario_seed, 0xF10D, flood_seed,
    edge]`` so both compilers — and a restarted streaming controller —
    draw the identical flood.  Sorted by (time, edge) so sink order is
    deterministic too.
    """
    events: List[Tuple[float, int, int, np.ndarray]] = []
    for i, f in enumerate(faults.floods):
        attacker = n_drones + i
        hi = min(f.end_ms, duration_ms)
        if hi <= f.start_ms:
            continue
        n = int(round(f.rate_hz * (hi - f.start_ms) / 1_000.0))
        for e in range(n_edges):
            if not _affects(f.edges, e):
                continue
            rng = np.random.default_rng(
                [scenario_seed, _FLOOD_TAG, f.seed, e])
            times = np.sort(rng.uniform(f.start_ms, hi, size=n))
            for t in times:
                events.append((float(t), attacker, e,
                               rng.permutation(n_models)))
    events.sort(key=lambda ev: (ev[0], ev[2]))
    return events


# ---------------------------------------------------------------------------
# telemetry-channel chaos (controller tests: drop / duplicate / reorder)
# ---------------------------------------------------------------------------

def perturb_telemetry(events: Sequence, chaos: TelemetryChaos,
                      time_of: Callable[[object], float] = None
                      ) -> List:
    """At-least-once channel simulation over an event sequence.

    Each event is independently dropped (``drop_p``), duplicated
    (``dup_p``) and/or delayed by up to ``max_delay_ms`` (``reorder_p``);
    the surviving deliveries are returned in delivery order (a delayed
    event lands *after* later-sent events — the out-of-order replay the
    controller's at-least-once contract has to absorb).  ``time_of``
    extracts an event's send time (default: ``event[0]``).
    """
    if time_of is None:
        time_of = lambda ev: float(ev[0])   # noqa: E731
    rng = np.random.default_rng([chaos.seed, _TELEM_TAG])
    deliveries: List[Tuple[float, int, object]] = []
    for i, ev in enumerate(events):
        if rng.random() < chaos.drop_p:
            continue
        copies = 2 if rng.random() < chaos.dup_p else 1
        for _ in range(copies):
            delay = (rng.uniform(0.0, chaos.max_delay_ms)
                     if rng.random() < chaos.reorder_p else 0.0)
            deliveries.append((time_of(ev) + delay, i, ev))
    deliveries.sort(key=lambda d: (d[0], d[1]))
    return [ev for _, _, ev in deliveries]

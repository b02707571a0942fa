"""The general traffic generator: every mix is parameters for these
functions.  Copies of the program's own generators, kept here so that a
change to the program cannot move the yardstick:

* :func:`steady_signals` — the paper's steady workload as dense tick
  signals (``repro_torch/sim/fleet.py::default_signals``): each drone a
  1 s video segment at a random phase, a task of every model a segment;
* :func:`trapezium` — the §8.5 θ waveform (``repro_torch/sim/network.py``);
* :func:`paper_events` — the same stream as controller telemetry
  (``chip_smoke.py::paper_events``);
* :func:`stream_signals` — the dense signals a controller's
  ``SignalWindowBuilder`` makes of those events (forward spill, a seeded
  insertion order a tick), which the reference runs.

Everything is numpy, drawn from ``numpy.random.default_rng`` of the
run's seed and the mission slot.
"""
from __future__ import annotations

import numpy as np

NOMINAL_BW_MBPS = 20.0
SIGNAL_FIELDS = ("times", "theta", "bw", "arrive", "order", "load_mult",
                 "cloud_up", "valid", "exec_jit", "edge_up", "link_up")


def mission_rng(seed: int, slot: int) -> np.random.Generator:
    """The generator of mission slot ``slot`` of a run with ``seed`` (any
    integer; negative ones are taken modulo 2**64)."""
    return np.random.default_rng([seed % 2**64, slot])


def trapezium(low: float, high: float, ramp_up, ramp_down):
    """θ(t): ``low``, ramping to ``high`` over ``ramp_up`` (ms), held,
    ramping back over ``ramp_down``."""
    u0, u1 = ramp_up
    d0, d1 = ramp_down
    du = max(u1 - u0, 1e-9)
    dd = max(d1 - d0, 1e-9)

    def theta(t):
        ta = np.asarray(t, dtype=float)
        up = low + (high - low) * (ta - u0) / du
        down = high - (high - low) * (ta - d0) / dd
        return np.where((ta < u0) | (ta >= d1), low,
                        np.where(ta < u1, up, np.where(ta < d0, high, down)))

    return theta


def _theta_trace(theta: dict | None, times: np.ndarray) -> np.ndarray:
    if theta is None:
        return np.zeros(times.shape[0], np.float32)
    fn = trapezium(theta["low"], theta["high"], theta["ramp_up"],
                   theta["ramp_down"])
    return np.asarray(fn(times), dtype=np.float32)


def steady_signals(n_models: int, n_edges: int, drones_per_edge: int,
                   duration_ms: float, dt: float, theta: dict | None,
                   rng: np.random.Generator) -> dict:
    """The paper's steady workload as dense tick signals (numpy arrays in
    the fields' order), drawn as the program's ``default_signals`` draws
    them."""
    m = n_models
    n_ticks = int(duration_ms / dt)
    times = np.arange(n_ticks, dtype=np.float32) * dt
    arrive = np.zeros((n_ticks, n_edges, m), dtype=bool)
    for e in range(n_edges):
        for _ in range(drones_per_edge):
            phase = rng.uniform(0, 1000.0)
            seg_t = np.arange(phase, duration_ms, 1000.0)
            ticks = np.minimum((seg_t / dt).astype(int), n_ticks - 1)
            arrive[ticks, e, :] = True
    theta_t = _theta_trace(theta, times)
    bw_t = np.full(n_ticks, NOMINAL_BW_MBPS, np.float32)
    order = rng.permuted(np.tile(np.arange(m), (n_ticks, n_edges, 1)),
                         axis=2).astype(np.int32)
    te = (n_ticks, n_edges)
    return dict(
        times=times, theta=np.broadcast_to(theta_t[:, None], te).copy(),
        bw=np.broadcast_to(bw_t[:, None], te).copy(), arrive=arrive,
        order=order, load_mult=np.ones(te, np.float32),
        cloud_up=np.ones(n_ticks, bool), valid=np.ones(te, bool),
        exec_jit=np.ones((n_ticks, n_edges, m, 2), np.float32),
        edge_up=np.ones(te, bool), link_up=np.ones(te, bool))


def paper_events(n_models: int, n_edges: int, drones_per_edge: int,
                 duration_ms: float, rng: np.random.Generator) -> list:
    """The paper's steady stream as telemetry: each drone's segments (1 s
    apart from a random phase), each a task of every model, as
    ``(t_ms, edge, model)`` in time order."""
    ev = []
    for e in range(n_edges):
        for _ in range(drones_per_edge):
            for t in np.arange(rng.uniform(0, 1000.0), duration_ms, 1000.0):
                ev += [(float(t), e, k) for k in range(n_models)]
    return sorted(ev)


def stream_signals(events: list, n_models: int, n_edges: int, dt: float,
                   n_ticks: int, order_seed: int = 0) -> dict:
    """The signals of ``n_ticks`` ticks that a ``SignalWindowBuilder`` in
    streaming mode makes of ``events`` submitted in order, each before its
    tick is stepped: an arrival lands in tick ``int(t / dt)`` and spills
    forward to the next tick whose (edge, model) cell is free; a tick's
    insertion order is the permutation of ``default_rng([order_seed,
    0x0dde, tick])``; every other channel keeps its default.  Arrivals
    that spill past ``n_ticks`` are not in these ticks."""
    m, e = n_models, n_edges
    taken: dict = {}
    arrive = np.zeros((n_ticks, e, m), bool)
    for t_ms, edge, model in events:
        tk = int(t_ms / dt)
        while taken.get((tk, edge, model)):
            tk += 1
        taken[(tk, edge, model)] = True
        if tk < n_ticks:
            arrive[tk, edge, model] = True
    order = np.stack([
        np.random.default_rng([order_seed, 0x0dde, t]).permuted(
            np.tile(np.arange(m), (e, 1)), axis=1)
        for t in range(n_ticks)]).astype(np.int32)
    te = (n_ticks, e)
    return dict(
        times=np.arange(n_ticks, dtype=np.float32) * dt,
        theta=np.zeros(te, np.float32),
        bw=np.full(te, NOMINAL_BW_MBPS, np.float32), arrive=arrive,
        order=order, load_mult=np.ones(te, np.float32),
        cloud_up=np.ones(n_ticks, bool), valid=np.ones(te, bool),
        exec_jit=np.ones((n_ticks, e, m, 2), np.float32),
        edge_up=np.ones(te, bool), link_up=np.ones(te, bool))

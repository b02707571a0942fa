"""Lower a :class:`ScenarioSpec` to simulator inputs; a copy of
``repro.scenarios.compile``.

Two targets, sharing the same arrival-time and handover geometry so the
oracle and the fleet simulator see the same mission:

* :func:`compile_oracle` — per-edge :class:`repro_torch.sim.engine.Arrival`
  streams plus per-edge θ(t) traces and outage windows for the
  discrete-event engine.  For a single static edge with no events the
  generated stream is **bit-for-bit identical** to
  :func:`repro_torch.sim.workloads.task_stream` (same RNG draw order).
* :func:`compile_fleet` — dense per-tick :class:`~repro_torch.sim.fleet.
  FleetSignals` tensors on a device: the drone→edge assignment is baked
  into the arrival mask (handover re-homes future arrivals), edge speed
  factors become per-edge load multipliers, outages become the cloud-up
  mask and a post-outage cold-start bump on θ, and the cellular
  bandwidth trace becomes the dense ``bw`` channel (same signed
  transfer-penalty convention as the oracle's
  ``CloudLatencyModel.shaped_delta``).

Everything is built in numpy on the host, drawing the reference's seeded
streams in the reference's order, so the arrays equal the reference's
bit for bit; only the finished window becomes tensors, with the dtypes
of ``default_signals`` (f32 channels, bool masks, i32 order).

The batching half lowers many runs to one batch: a scenario over seeds
(:func:`compile_fleet_batch`), and scenarios × policies × seeds as one
padded batch (:func:`compile_registry_batch`) or as exact-shape buckets
(:func:`compile_registry_groups`).  Their signals are compiled on the
host and reach the device once, as the stacked batch.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Callable

import numpy as np
import torch

from repro_torch import faults as fl
from repro_torch import resolve_device
from repro_torch.scenarios.mobility import assignment
from repro_torch.scenarios.spec import ScenarioSpec
from repro_torch.sim import network
from repro_torch.sim.engine import Arrival
from repro_torch.sim.fleet import (FleetBatch, FleetSignals,
                                   _resolve_policy, build_fleet_batch,
                                   plan_buckets, stack_signals)


@dataclasses.dataclass
class OracleInputs:
    """Compiled inputs for one :class:`repro_torch.sim.engine.Simulator`
    per edge."""

    spec: ScenarioSpec
    edge_arrivals: list[list[Arrival]]
    theta_fns: list[Callable[[float], float]]
    bw_fns: list[Callable[[float], float]]
    # (start, end, cold_ms, cold_window_ms) per outage — the engine's
    # 4-tuple form, preserving each outage's own cold-start profile
    outages: tuple[tuple[float, float, float, float], ...]
    # chaos-engine lowering (None without a fault schedule): per-edge
    # outage lists (fleet-wide outages + that edge's partition windows as
    # zero-cold outages) and per-edge crash windows for the engine's
    # edge_down_windows
    edge_outages: list | None = None
    crashes: list | None = None


def _theta_fn(spec: ScenarioSpec, e: int) -> Callable[[float], float]:
    th = spec.theta
    if th is None or (th.edges is not None and e not in th.edges):
        return network.constant(0.0)
    return network.trapezium(th.low, th.high, th.ramp_up, th.ramp_down)


def _bw_fn(spec: ScenarioSpec, e: int) -> Callable[[float], float]:
    """Edge ``e``'s cellular bandwidth trace (nominal when unshaped)."""
    b = spec.bandwidth
    if b is None or (b.edges is not None and e not in b.edges):
        return network.constant(network.NOMINAL_BW_MBPS)
    return network.cellular_bandwidth_trace(
        seed=b.seed, duration_ms=spec.duration_ms, step_ms=b.step_ms,
        lo=b.lo, hi=b.hi, start=b.start)


def n_steps(total_ms: float, step_ms: float, what: str = "duration") -> int:
    """Number of ``step_ms`` steps covering ``total_ms``, validated.

    ``int(total / step)`` truncates: a duration not divisible by the step
    (or mere float drift, e.g. ``0.1 * 3``) silently drops the final
    steps.  Round instead, tolerate only float noise, and raise on
    genuinely non-divisible specs so the mission horizon is always exact.
    """
    ratio = total_ms / step_ms
    n = round(ratio)
    if n <= 0 or abs(ratio - n) > 1e-6 * max(1.0, abs(ratio)):
        raise ValueError(
            f"{what} {total_ms} ms is not an integer multiple of the "
            f"{step_ms} ms step (ratio {ratio!r}); pick divisible values "
            "so no ticks are silently dropped")
    return int(n)


def _arrival_times(spec: ScenarioSpec, d: int,
                   rng: np.random.Generator) -> tuple[float, list[float]]:
    """Base (phase, segment times) for drone ``d`` — task_stream protocol."""
    phase = float(rng.uniform(0, spec.segment_ms))
    n_segments = n_steps(spec.duration_ms, spec.segment_ms, "duration")
    times = [s * spec.segment_ms + phase for s in range(n_segments)]
    return phase, times


def _burst_times(spec: ScenarioSpec, phase: float) -> list[float]:
    """Extra arrival times so total rate = rate_mult × base inside bursts."""
    extra: list[float] = []
    for b in spec.bursts:
        if b.rate_mult <= 1.0:
            continue
        step = spec.segment_ms / (b.rate_mult - 1.0)
        t = b.start_ms + (phase % step)
        while t < min(b.end_ms, spec.duration_ms):
            extra.append(t)
            t += step
    return extra


def _emit(spec: ScenarioSpec, sink, seed=None) -> None:
    """Walk every arrival event once, calling ``sink(t, d, e, order)``.

    The base loop replicates ``workloads.task_stream`` draw-for-draw (one
    shared RNG: per-drone phase, then per-segment model permutation), so a
    1-edge static no-event spec compiles to the identical stream.  Burst
    extras draw from per-drone child generators to leave the base stream
    untouched.
    """
    rng = np.random.default_rng(spec.seed if seed is None else seed)
    m = len(spec.model_names)
    extras: list[tuple[float, int]] = []
    for d in range(spec.n_drones):
        phase, times = _arrival_times(spec, d, rng)
        for t in times:
            if t >= spec.duration_ms:
                continue
            order = rng.permutation(m)
            if not spec.drone_alive(d, t):
                continue                      # churn: draw but do not emit
            sink(t, d, assignment(spec, d, t), order)
        extras.extend((t, d) for t in _burst_times(spec, phase))
    for t, d in sorted(extras):
        erng = np.random.default_rng([spec.seed, 0x6275, d, int(t)])
        order = erng.permutation(m)
        if spec.drone_alive(d, t):
            sink(t, d, assignment(spec, d, t), order)


def compile_exec_jitter(spec: ScenarioSpec, dt: float = 25.0,
                        n_ticks: int | None = None
                        ) -> tuple[np.ndarray, np.ndarray]:
    """Per-(tick, model) execution-duration multiplier tables.

    Returns ``(edge_tab, cloud_tab)``, each ``float32 [T, M]`` with
    median-1.0 log-normal samples per :class:`~repro_torch.scenarios.spec.
    DurationJitter` — or exact ones when ``spec.jitter`` is ``None`` (and
    bit-identically when every sigma is zero, since ``exp(N(0, 0)) ==
    1.0``).  Both simulators consume the *same* tables: the fleet as the
    dense ``FleetSignals.exec_jit`` lane, the oracle through
    :class:`repro_torch.sim.network.TableEdgeLatencyModel` /
    :class:`~repro_torch.sim.network.TableCloudLatencyModel` indexing by
    ``min(now // dt, T - 1)`` — so a task executing at time ``t`` draws
    the same multiplier in either backend.
    """
    m = len(spec.model_names)
    if n_ticks is None:
        n_ticks = n_steps(spec.duration_ms, dt, "duration")
    j = spec.jitter
    if j is None:
        ones = np.ones((n_ticks, m), np.float32)
        return ones, ones.copy()
    rng = np.random.default_rng([spec.seed, 0x4A17, j.seed])

    def lognormal(sigma: float, clip: tuple[float, float]) -> np.ndarray:
        x = np.exp(rng.normal(0.0, sigma, size=(n_ticks, m)))
        return np.clip(x, clip[0], clip[1])

    edge = lognormal(j.edge_sigma, j.edge_clip)
    cloud = lognormal(j.cloud_sigma, j.cloud_clip)
    if j.heavy_tail_p > 0.0:
        # Lambda cold-start-like stragglers: rare multiplicative spikes
        tail = rng.random(size=(n_ticks, m)) < j.heavy_tail_p
        cloud = np.where(
            tail, np.clip(cloud * j.heavy_tail_mult, *j.cloud_clip), cloud)
    return edge.astype(np.float32), cloud.astype(np.float32)


class SignalWindowBuilder:
    """Incremental, dt-aligned assembly of :class:`FleetSignals` windows.

    The seam between the scenario compiler and an online control plane:
    telemetry events land in their ``dt`` tick — arrivals spill
    *forward* to the next free (edge, model) cell, exactly the batch
    compiler's convention; channel updates (θ, bandwidth, edge load,
    cloud availability) hold their last value forward — and
    :meth:`emit_window` pops the next ``n`` ticks as a window of
    tensors on ``device`` for
    :meth:`repro_torch.sim.fleet.FleetProgram.step_chunk`.

    Two modes share the code path:

    * **compiler mode** (``horizon_ticks`` set): the buffer is the whole
      mission and arrivals that run off the end spill *backwards* from
      their original tick (a burst reaching the horizon keeps its task
      count).  :func:`compile_fleet` is exactly this: feed every event,
      bulk-load the dense channels, emit one horizon-length window.
      The ``order`` lane defaults to a placeholder the compiler always
      overwrites via :meth:`load_dense`.
    * **streaming mode** (no horizon): the buffer grows with telemetry,
      nothing ever spills backwards, and events older than the emit
      cursor clamp forward to it (the past cannot be rewritten — the
      documented late-telemetry contract).  The ``order`` lane draws a
      per-tick seeded permutation (``[order_seed, 0x0dde, tick]``), so
      insertion order is reproducible across restarts regardless of
      window boundaries.

    ``exec_jit`` defaults to the deterministic ×1.0 lane in both modes
    (live cloud variability enters through θ/bandwidth telemetry);
    compiler mode overwrites it with the sampled tables.
    """

    # channels with a forward-hold current value (name → per-row shape fn)
    _HELD = ("theta", "bw", "load_mult", "cloud_up", "exec_jit",
             "edge_up", "link_up")

    def __init__(self, n_edges: int, n_models: int, *, dt: float = 25.0,
                 horizon_ticks: int | None = None, start_tick: int = 0,
                 order_seed: int = 0, device="cuda"):
        self.device = resolve_device(device)
        self.n_edges, self.n_models = int(n_edges), int(n_models)
        self.dt = float(dt)
        self.horizon = horizon_ticks
        self.order_seed = order_seed
        self._base = int(start_tick)   # absolute tick of buffer row 0
        self._rows = 0                 # allocated rows past the base
        self._hi = int(start_tick)     # one past the last tick touched
        e, m = self.n_edges, self.n_models
        self._cur = dict(
            theta=np.zeros(e, np.float32),
            bw=np.full(e, network.NOMINAL_BW_MBPS, np.float32),
            load_mult=np.ones(e, np.float32),
            cloud_up=True,
            exec_jit=np.ones((e, m, 2), np.float32),
            edge_up=np.ones(e, bool),
            link_up=np.ones(e, bool))
        self._buf: dict[str, np.ndarray] = {}
        self._ensure_rows(horizon_ticks if horizon_ticks is not None else 64)

    # -- buffer management -------------------------------------------------
    def _default_order(self, tick0: int, n: int) -> np.ndarray:
        e, m = self.n_edges, self.n_models
        if self.horizon is not None:
            # compiler-mode placeholder: always overwritten by load_dense
            return np.broadcast_to(np.arange(m, dtype=np.int32),
                                   (n, e, m)).copy()
        return np.stack([
            np.random.default_rng([self.order_seed, 0x0dde, t]).permuted(
                np.tile(np.arange(m), (e, 1)), axis=1)
            for t in range(tick0, tick0 + n)]).astype(np.int32)

    def _ensure_rows(self, rows: int) -> None:
        if rows <= self._rows:
            return
        rows = max(rows, 2 * self._rows)
        if self.horizon is not None:
            rows = min(rows, self.horizon - self._base)
        n_new = rows - self._rows
        e, m = self.n_edges, self.n_models
        cur = self._cur
        grow = dict(
            arrive=np.zeros((n_new, e, m), bool),
            theta=np.broadcast_to(cur["theta"], (n_new, e)).copy(),
            bw=np.broadcast_to(cur["bw"], (n_new, e)).copy(),
            load_mult=np.broadcast_to(cur["load_mult"], (n_new, e)).copy(),
            cloud_up=np.full(n_new, cur["cloud_up"], bool),
            valid=np.ones((n_new, e), bool),
            exec_jit=np.broadcast_to(cur["exec_jit"],
                                     (n_new, e, m, 2)).copy(),
            edge_up=np.broadcast_to(cur["edge_up"], (n_new, e)).copy(),
            link_up=np.broadcast_to(cur["link_up"], (n_new, e)).copy(),
            order=self._default_order(self._base + self._rows, n_new))
        self._buf = grow if not self._buf else {
            k: np.concatenate([self._buf[k], grow[k]]) for k in grow}
        self._rows = rows

    def _tick(self, t_ms: float) -> int:
        """The dt tick a timestamp lands in: clamped into the horizon in
        compiler mode, forward to the emit cursor in streaming mode."""
        tk = int(t_ms / self.dt)
        if self.horizon is not None:
            tk = min(tk, self.horizon - 1)
        return max(tk, self._base)

    def _touch(self, tk: int) -> int:
        """Allocate through absolute tick ``tk``; return its row."""
        self._ensure_rows(tk - self._base + 1)
        self._hi = max(self._hi, tk + 1)
        return tk - self._base

    @property
    def cursor(self) -> int:
        """The first tick the next :meth:`emit_window` will cover."""
        return self._base

    @property
    def pending_ticks(self) -> int:
        """Ticks of telemetry seen beyond the emit cursor."""
        return self._hi - self._base

    # -- telemetry ingestion ----------------------------------------------
    def add_arrival(self, t_ms: float, edge: int, model: int) -> int:
        """One task arrival; returns the tick it landed in after spill.

        The fleet step inserts at most one task per (edge, model) per
        tick, so coincident same-model arrivals spill forward to the
        next free cell (and, in compiler mode only, backwards when the
        horizon is full) — an exact task count at the price of a few
        ``dt`` of skew.
        """
        tk = self._tick(t_ms)
        r = self._touch(tk)
        a = self._buf["arrive"]
        if self.horizon is not None:
            last = self.horizon - 1 - self._base
            while r < last and a[r, edge, model]:
                r += 1
            if a[r, edge, model]:      # horizon full → spill backwards so
                r = tk - self._base    # a burst running to the end still
                while r > 0 and a[r, edge, model]:   # keeps its task count
                    r -= 1
        else:
            while True:
                if a[r, edge, model]:
                    r = self._touch(self._base + r + 1)
                    a = self._buf["arrive"]
                    continue
                break
        a[r, edge, model] = True
        self._hi = max(self._hi, self._base + r + 1)
        return self._base + r

    def set_theta(self, t_ms: float, value: float,
                  edge: int | None = None) -> None:
        """Added WAN latency θ from ``t_ms`` on (one edge, or all)."""
        self._set("theta", t_ms, value, edge)

    def set_bandwidth(self, t_ms: float, mbps: float,
                      edge: int | None = None) -> None:
        """Cellular bandwidth from ``t_ms`` on (one edge, or all)."""
        self._set("bw", t_ms, mbps, edge)

    def set_load(self, t_ms: float, mult: float,
                 edge: int | None = None) -> None:
        """Edge execution-time multiplier from ``t_ms`` on."""
        self._set("load_mult", t_ms, mult, edge)

    def set_cloud_up(self, t_ms: float, up: bool) -> None:
        """Cloud FaaS availability from ``t_ms`` on."""
        r = self._touch(self._tick(t_ms))
        self._buf["cloud_up"][r:] = bool(up)
        self._cur["cloud_up"] = bool(up)

    def set_edge_up(self, t_ms: float, up: bool,
                    edge: int | None = None) -> None:
        """Edge liveness from ``t_ms`` on — False crashes the edge
        (queue flush + no admission) in the tick program."""
        self._set("edge_up", t_ms, bool(up), edge)

    def set_link_up(self, t_ms: float, up: bool,
                    edge: int | None = None) -> None:
        """Edge↔cloud link state from ``t_ms`` on — False partitions
        the edge (cloud dispatch parks, GEMS migration halts)."""
        self._set("link_up", t_ms, bool(up), edge)

    def _set(self, field: str, t_ms: float, value: float,
             edge: int | None) -> None:
        r = self._touch(self._tick(t_ms))
        sl = slice(None) if edge is None else edge
        self._buf[field][r:, sl] = value
        self._cur[field][sl] = value

    def load_dense(self, field: str, values: np.ndarray,
                   start_tick: int = 0) -> None:
        """Bulk-write a dense channel block (the batch compiler's path).

        ``values`` covers ticks ``[start_tick, start_tick + len)``;
        held channels update their hold from the last written row, so
        streaming past the block continues its final value.
        """
        values = np.asarray(values)
        if start_tick < self._base:
            raise ValueError(
                f"load_dense({field!r}) starts at tick {start_tick}, "
                f"before the emit cursor {self._base} — emitted windows "
                f"cannot be rewritten")
        self._touch(start_tick + len(values) - 1)
        r = start_tick - self._base
        self._buf[field][r:r + len(values)] = values
        if field in self._HELD:
            if field == "cloud_up":
                self._cur[field] = bool(values[-1])
            else:
                self._cur[field][...] = values[-1]

    # -- window emission ---------------------------------------------------
    def emit_window(self, n_ticks: int) -> FleetSignals:
        """Pop ticks ``[cursor, cursor + n_ticks)`` as dense signals on
        the builder's device.

        Ticks with no telemetry carry each channel's held value and no
        arrivals; the cursor advances, so these ticks are final.
        """
        self._ensure_rows(n_ticks)
        t0 = self._base
        times = np.arange(t0, t0 + n_ticks, dtype=np.float32) * self.dt
        host = dict(times=times, **{k: self._buf[k][:n_ticks]
                                    for k in FleetSignals._fields[1:]})
        # the emitted rows are never written again: the buffer is
        # replaced by copies of the rows past them just below
        window = FleetSignals(**{
            k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
            for k, v in host.items()})
        self._buf = {k: v[n_ticks:].copy() for k, v in self._buf.items()}
        self._rows -= n_ticks
        self._base += n_ticks
        self._hi = max(self._hi, self._base)
        return window


def compile_oracle(spec: ScenarioSpec) -> OracleInputs:
    """Per-edge arrival streams + traces for the discrete-event engine."""
    edge_models = [spec.edge_models(e) for e in range(spec.n_edges)]
    edge_arrivals: list[list[Arrival]] = [[] for _ in range(spec.n_edges)]

    def sink(t: float, d: int, e: int, order) -> None:
        for k in order:
            edge_arrivals[e].append(
                Arrival(time=t, model=edge_models[e][int(k)], drone=d))

    _emit(spec, sink)
    theta_fns = [_theta_fn(spec, e) for e in range(spec.n_edges)]
    bw_fns = [_bw_fn(spec, e) for e in range(spec.n_edges)]
    outages = tuple((o.start_ms, o.end_ms, o.cold_ms, o.cold_window_ms)
                    for o in spec.outages)
    edge_outages = crashes = None
    faults = spec.faults
    if faults is not None:
        # floods go through the same sink protocol as the benign stream,
        # in the same order as compile_fleet feeds them
        for t, d, e, order in fl.flood_events(
                spec.seed, faults, spec.n_edges, len(spec.model_names),
                spec.duration_ms, spec.n_drones):
            sink(t, d, e, order)
        # jamming/brownout θ overlays and bandwidth caps wrap the base
        # traces — the identical callables compile_fleet samples densely
        theta_fns = [
            (lambda t, base=base, ov=fl.theta_overlay_fn(faults, e):
             base(t) + ov(t))
            for e, base in enumerate(theta_fns)]
        bw_fns = [
            (lambda t, base=base, cap=fl.bw_cap_fn(faults, e):
             np.minimum(base(t), cap(t)))
            for e, base in enumerate(bw_fns)]
        parts = fl.partition_windows(faults, spec.n_edges)
        edge_outages = [
            tuple(sorted(outages + tuple((s, t, 0.0, 0.0)
                                         for (s, t) in parts[e])))
            for e in range(spec.n_edges)]
        crashes = fl.crash_windows(faults, spec.n_edges)
    return OracleInputs(
        spec=spec,
        edge_arrivals=edge_arrivals,
        theta_fns=theta_fns,
        bw_fns=bw_fns,
        outages=outages,
        edge_outages=edge_outages,
        crashes=crashes)


def compile_fleet(spec: ScenarioSpec, dt: float = 25.0, *,
                  device="cuda") -> FleetSignals:
    """Dense per-tick signals on ``device`` for
    :func:`repro_torch.sim.fleet.run_fleet`.

    "Compile the whole horizon" over the same
    :class:`SignalWindowBuilder` an online controller streams through:
    every arrival event feeds :meth:`~SignalWindowBuilder.add_arrival`
    (coincident same-model arrivals would silently collapse on a boolean
    mask and deflate the load versus the oracle, so each extra task
    spills to the next free (edge, model) cell — a few ``dt`` of skew
    against sub-second deadlines, but an exact task count), the dense
    channels are bulk-loaded, and the mission pops out as one
    horizon-length window.
    """
    m = len(spec.model_names)
    n_edges = spec.n_edges
    n_ticks = n_steps(spec.duration_ms, dt, "duration")
    times = np.arange(n_ticks, dtype=np.float32) * dt

    b = SignalWindowBuilder(n_edges, m, dt=dt, horizon_ticks=n_ticks,
                            device=device)

    def sink(t: float, d: int, e: int, order) -> None:
        for k in order:
            b.add_arrival(t, e, int(k))

    _emit(spec, sink)
    faults = spec.faults
    if faults is not None:
        # the identical seeded flood events the oracle compiler feeds,
        # in the identical order
        for t, d, e, order in fl.flood_events(
                spec.seed, faults, n_edges, m, spec.duration_ms,
                spec.n_drones):
            sink(t, d, e, order)

    # per-edge θ(t) and cellular bandwidth, evaluated vectorized over the
    # whole tick grid (array-native trace fns — no per-tick Python loop);
    # post-outage cold starts appear as a θ bump so the first
    # post-recovery dispatches pay the container-warmup price.
    theta = np.zeros((n_ticks, n_edges), dtype=np.float32)
    bw = np.empty((n_ticks, n_edges), dtype=np.float32)
    for e in range(n_edges):
        theta[:, e] = network.sample_trace(_theta_fn(spec, e), times)
        bw[:, e] = network.sample_trace(_bw_fn(spec, e), times)
        if faults is not None:
            # the same overlay/cap callables compile_oracle wraps around
            # its trace fns, sampled on the tick grid
            theta[:, e] += fl.theta_overlay_fn(faults, e)(times)
            bw[:, e] = np.minimum(bw[:, e],
                                  fl.bw_cap_fn(faults, e)(times))
    cloud_up = np.ones(n_ticks, dtype=bool)
    for o in spec.outages:
        down = (times >= o.start_ms) & (times < o.end_ms)
        cloud_up &= ~down
        cold = (times >= o.end_ms) & (times < o.end_ms + o.cold_window_ms)
        theta[cold, :] += o.cold_ms

    load_mult = np.broadcast_to(
        np.array([e.speed_factor for e in spec.edges], np.float32),
        (n_ticks, n_edges)).copy()

    rng = np.random.default_rng([spec.seed, 0x0dde])
    order = rng.permuted(np.tile(np.arange(m), (n_ticks, n_edges, 1)),
                         axis=2).astype(np.int32)

    # sampled execution-duration multipliers, shared with the oracle's
    # table latency models; axis -1 is (edge, cloud).  Every edge sees
    # the same [T, M] tables so a peer-offloaded task keeps its draw.
    ej, cj = compile_exec_jitter(spec, dt, n_ticks)
    exec_jit = np.broadcast_to(
        np.stack([ej, cj], axis=-1)[:, None, :, :],
        (n_ticks, n_edges, m, 2)).copy()

    if faults is not None:
        edge_up = fl.edge_up_dense(faults, times, n_edges)
        link_up = fl.link_up_dense(faults, times, n_edges)
    else:
        edge_up = np.ones((n_ticks, n_edges), dtype=bool)
        link_up = np.ones((n_ticks, n_edges), dtype=bool)

    for field, vals in (("theta", theta), ("bw", bw),
                        ("cloud_up", cloud_up), ("load_mult", load_mult),
                        ("order", order), ("exec_jit", exec_jit),
                        ("edge_up", edge_up), ("link_up", link_up)):
        b.load_dense(field, vals)
    return b.emit_window(n_ticks)


def signal_digests(signals: FleetSignals) -> dict[str, str]:
    """SHA-256 of each field's dtype, shape and bytes, from its host copy.

    Tensors on any device and numpy arrays digest alike, so signals a
    compiler built on the card can be held bitwise to a reference's.
    """
    out = {}
    for name, a in zip(FleetSignals._fields, signals):
        arr = np.ascontiguousarray(
            a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else a)
        h = hashlib.sha256(f"{arr.dtype.str}{arr.shape}".encode())
        h.update(arr.tobytes())
        out[name] = h.hexdigest()
    return out


def compile_fleet_batch(spec: ScenarioSpec, seeds: tuple[int, ...],
                        dt: float = 25.0, *, device="cuda") -> FleetSignals:
    """Stacked signals ``[R, …]`` for one scenario across ``seeds``,
    compiled on the host and moved to ``device`` once — the input of
    :func:`repro_torch.sim.fleet.run_fleet_batch`."""
    dev = resolve_device(device)
    stacked = stack_signals([compile_fleet(sp, dt, device="cpu")
                             for sp in spec.reseeded(tuple(seeds))])
    return FleetSignals(*(a.to(dev) for a in stacked))


@dataclasses.dataclass(frozen=True)
class SweepRun:
    """Index row of one run in a registry batch.

    ``lanes`` are the run's replica indices in the batch: a single lane
    normally, one lane per edge under the edge-flattened lowering (see
    :func:`compile_registry_batch`).
    """

    scenario: str
    policy: str
    seed: int
    lanes: tuple[int, ...] = (0,)


def _slice_edge(sig: FleetSignals, e: int) -> FleetSignals:
    """One edge's signals as a 1-edge mission (edge axis kept, length 1)."""
    return FleetSignals(
        times=sig.times, theta=sig.theta[:, e:e + 1],
        bw=sig.bw[:, e:e + 1], arrive=sig.arrive[:, e:e + 1],
        order=sig.order[:, e:e + 1], load_mult=sig.load_mult[:, e:e + 1],
        cloud_up=sig.cloud_up, valid=sig.valid[:, e:e + 1],
        exec_jit=sig.exec_jit[:, e:e + 1],
        edge_up=sig.edge_up[:, e:e + 1], link_up=sig.link_up[:, e:e + 1])


def _sweep_specs(scenarios, duration_ms) -> list[ScenarioSpec]:
    """Resolve a sweep's scenario list: registry names and/or ad-hoc
    :class:`ScenarioSpec` instances, all of the registry when ``None``,
    with an optional ``duration_ms`` override.  Spec names must be
    unique — they key the sweep's rows."""
    from repro_torch.scenarios.registry import get, names

    specs = [sc if isinstance(sc, ScenarioSpec) else get(sc)
             for sc in (tuple(scenarios) if scenarios is not None
                        else names())]
    if duration_ms is not None:
        specs = [dataclasses.replace(sp, duration_ms=duration_ms)
                 for sp in specs]
    seen = {sp.name for sp in specs}
    if len(seen) != len(specs):
        raise ValueError("sweep scenarios must have unique names, got "
                         f"{[sp.name for sp in specs]}")
    return specs


def compile_registry_batch(scenarios=None, policies=("DEMS",),
                           seeds=(0,), *, dt: float = 25.0,
                           duration_ms: float | None = None, device="cuda"
                           ) -> tuple[FleetBatch, list[SweepRun]]:
    """Lower scenarios × policies × seeds to **one** padded batch.

    Every scenario (each named registry entry by default; ad-hoc
    :class:`ScenarioSpec` instances are accepted too) is compiled per
    seed, padded to the batch's max (ticks, edges, models) shape with
    validity masks, and paired with its policy's
    :class:`~repro_torch.sim.fleet.PolicyParams` and its own
    ``cloud_concurrency`` pool, so the whole sweep runs as one
    :func:`repro_torch.sim.fleet.run_batch` call.

    When no requested policy is cooperative, edges never interact, so the
    batch is **edge-flattened**: each (run, edge) becomes its own 1-edge
    replica — zero edge padding, per-edge results bitwise identical to
    the multi-edge fleet — and each :class:`SweepRun` row carries its
    ``lanes``.  Returns the batch plus the run index, in replica order.
    """
    flatten = not any(_resolve_policy(p).cooperation for p in policies)
    runs, rows, lane = [], [], 0
    sig_cache: dict = {}    # policies share a (scenario, seed)'s signals
    for spec in _sweep_specs(scenarios, duration_ms):
        sc = spec.name
        for pol in policies:
            for seed in seeds:
                sp = dataclasses.replace(spec, seed=seed)
                if (sc, seed) not in sig_cache:
                    sig = compile_fleet(sp, dt, device="cpu")
                    sig_cache[sc, seed] = [
                        _slice_edge(sig, e) for e in range(sp.n_edges)
                    ] if flatten else [sig]
                sigs = sig_cache[sc, seed]
                runs.extend((sp.models, pol, s, sp.cloud_concurrency)
                            for s in sigs)
                lanes = tuple(range(lane, lane + len(sigs)))
                lane += len(sigs)
                rows.append(SweepRun(scenario=sc, policy=pol, seed=seed,
                                     lanes=lanes))
    return build_fleet_batch(runs, dt=dt, device=device), rows


def compile_registry_groups(scenarios=None, policies=("DEMS",),
                            seeds=(0,), *, dt: float = 25.0,
                            duration_ms: float | None = None, device="cuda"
                            ) -> list[tuple[FleetBatch, list[SweepRun]]]:
    """The sweep as exact-shape buckets — the shape-bucketed planner.

    Routes the sweep of :func:`compile_registry_batch` through
    :func:`repro_torch.sim.fleet.plan_buckets`: non-cooperative runs are
    edge-flattened (1-edge replicas, zero edge padding), cooperative runs
    bucket by their true multi-edge shape, and peer-offload rounds run
    only in cooperative buckets.  Within a bucket stacking is exact, so
    each bucket's ``run_batch`` rows equal the per-scenario ``run_fleet``
    loop bitwise.

    Returns ``(batch, rows)`` per bucket; each row's ``lanes`` index into
    its own bucket's batch, and the rows of all buckets partition the
    sweep.
    """
    runs, tags = [], []
    sig_cache: dict = {}
    for spec in _sweep_specs(scenarios, duration_ms):
        sc = spec.name
        for pol in policies:
            coop = _resolve_policy(pol).cooperation
            for seed in seeds:
                sp = dataclasses.replace(spec, seed=seed)
                if (sc, seed) not in sig_cache:
                    sig = compile_fleet(sp, dt, device="cpu")
                    sig_cache[sc, seed] = (
                        sig, [_slice_edge(sig, e)
                              for e in range(sp.n_edges)])
                whole, slices = sig_cache[sc, seed]
                for s in ([whole] if coop else slices):
                    runs.append((sp.models, pol, s, sp.cloud_concurrency))
                    tags.append((sc, pol, seed))
    out = []
    for batch, idxs in plan_buckets(runs, dt=dt, device=device):
        # a run's edge-flattened lanes land in one bucket (same shape,
        # same policy), in order — regroup them under their sweep row
        rows: dict = {}
        for lane, i in enumerate(idxs):
            rows.setdefault(tags[i], []).append(lane)
        out.append((batch, [SweepRun(scenario=sc, policy=pol, seed=seed,
                                     lanes=tuple(lanes))
                            for (sc, pol, seed), lanes in rows.items()]))
    return out

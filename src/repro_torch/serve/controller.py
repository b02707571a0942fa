"""Online fleet control plane over the tick program.  Port of
``repro.serve.controller``.

:class:`FleetController` is the streaming twin of the replay entry
points: telemetry (task arrivals, per-edge bandwidth and WAN-latency
readings, cloud availability) is ingested incrementally into a
:class:`repro_torch.scenarios.compile.SignalWindowBuilder`, popped as
dt-aligned :class:`~repro_torch.sim.fleet.FleetSignals` windows, and
advanced through :meth:`repro_torch.sim.fleet.FleetProgram.step_chunk` —
on the card one CUDA-graph replay per window (a graph per window
length), no host round-trips inside.  Because the tick composes exactly,
a controller fed a replay scenario's signals window by window finishes
in the **bitwise-identical** final :class:`~repro_torch.sim.fleet.
EdgeState` as one :func:`~repro_torch.sim.fleet.run_fleet` call
(``tests/test_torch_controller.py`` and
:func:`repro_torch.scenarios.runner.assert_streaming_equivalence`).

The controller also carries the serve layer's operational duties:

* per-tick decision records read from host copies of the flight
  recorder's :class:`~repro_torch.obs.trace.TickCounters` stream
  (routing, migration, steals, drops by cause) via
  :meth:`FleetController.poll`;
* a :meth:`~FleetController.metrics_snapshot` scoreboard — outcome
  totals, queue gauges, latency/slack tails from trace histograms, and
  the controller's own step-latency and ingest-lag percentiles;
* crash restart: :meth:`~FleetController.checkpoint` /
  :meth:`~FleetController.restore` round-trip the full ``EdgeState``
  (plus the tick cursor and the dedupe ring) through
  :mod:`repro_torch.train.checkpoint`, in the reference's file format,
  so a restarted controller resumes mid-mission and — given the same
  post-checkpoint telemetry — finishes with the same state as an
  uninterrupted run.

Its phases are spans of :mod:`repro_torch.obs.prof`'s table: a poll is
one request, ``ctl.poll``, and under it for each window ``ctl.emit``
(``emit_window``), ``ctl.step`` (the step and, on the card, ``ctl.wait``,
the synchronize), ``ctl.record`` (the counters to the host) and
``ctl.checkpoint``; :meth:`FleetController.submit` counts
``ctl.submitted``.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.task import ModelProfile
from repro_torch.obs.prof import count, counters, span, span_table
from repro_torch.obs.trace import TraceSpec
from repro_torch.scenarios.compile import SignalWindowBuilder
from repro_torch.sim.fleet import (CLOUD_SLOTS, EdgeState, FleetProgram,
                                   FleetSignals, Profiles, _leaves, _map,
                                   _resolve_policy)
from repro_torch.train import checkpoint as ckpt

# fleet-summed per-tick decision counters surfaced in decision records
_DECISION_FIELDS = (
    "arrivals", "admit_edge", "admit_cloud", "migrated", "cloud_dispatch",
    "pool_blocked", "gems_moved", "edge_exec", "peer_out", "peer_in",
    "drop_infeasible", "drop_unstolen", "drop_qfull", "drop_crash",
    "drop_timeout")


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy()


class FleetController:
    """Stateful online scheduler for one edge fleet on ``device``.

    Ingestion (:meth:`submit`, :meth:`observe_bandwidth`,
    :meth:`observe_theta`, :meth:`observe_load`, :meth:`observe_cloud`,
    :meth:`observe_edge_up`, :meth:`observe_link_up`) only buffers —
    nothing runs until :meth:`poll` finds at least ``window_ticks``
    complete ticks behind ``now_ms``, keeping each device call a
    fixed-shape window (one graph per window length).  :meth:`close`
    flushes the ragged remainder.

    The ingest queue is **bounded** at ``max_pending_ticks`` of buffered
    telemetry.  A submission landing past the bound is handled by
    ``shed_policy``: ``"reject"`` refuses it (returns ``-1``, counted in
    ``shed_tasks``) while ``"degrade"`` force-steps the oldest pending
    window to make room — trading telemetry completeness for admission,
    counted in ``degrade_windows``.  Either way the controller never
    deadlocks and never grows unbounded under an arrival flood.

    Passing ``task_id`` to :meth:`submit` makes ingestion **idempotent**
    over the last ``dedupe_window`` distinct ids: redelivered ids are
    dropped (counted in ``duplicate_events``), so an at-least-once
    telemetry bus replaying events after :meth:`restore` cannot
    double-schedule work.  The dedupe ring rides in the checkpoint.

    ``_capture=False`` steps the windows eagerly on the card too; only
    ``chip_smoke.py`` passes it, to time the eager controller beside the
    replayed one.
    """

    def __init__(self, models: Sequence[ModelProfile], policy, *,
                 n_edges: int, dt: float = 25.0, window_ticks: int = 8,
                 cloud_slots: int = CLOUD_SLOTS, edge_frac: float = 0.62,
                 cloud_frac: float = 0.80,
                 trace: Optional[TraceSpec] = None,
                 checkpoint_path: Optional[str] = None,
                 checkpoint_every: int = 4, order_seed: int = 0,
                 decision_log: int = 4096, latency_log: int = 512,
                 max_pending_ticks: int = 4096,
                 shed_policy: str = "reject",
                 dedupe_window: int = 4096,
                 cloud_give_up_ms: Optional[float] = None,
                 device="cuda", _capture: bool = True):
        self.device = resolve_device(device)
        self._capture = _capture
        self.models = list(models)
        self.policy_name = policy if isinstance(policy, str) else "custom"
        self._pol = _resolve_policy(policy)
        if cloud_give_up_ms is not None:
            self._pol = dataclasses.replace(
                self._pol, cloud_give_up_ms=float(cloud_give_up_ms))
        self._prof = Profiles.build(self.models, self.device)
        self._pp = self._pol.params(self.device)
        self.trace = TraceSpec(counters=True) if trace is None else trace
        self.n_edges, self.dt = int(n_edges), float(dt)
        self.window_ticks = int(window_ticks)
        self.cloud_slots = cloud_slots
        self.order_seed = order_seed
        self.prog = FleetProgram.for_policy(
            self._pol, trace=self.trace, dt=dt, edge_frac=edge_frac,
            cloud_frac=cloud_frac)
        self.state: EdgeState = self.prog.init(
            self._prof, self._pol, n_edges, cloud_slots)
        self._model_idx = {m.name: i for i, m in enumerate(self.models)}
        self.builder = self._new_builder(0)
        self.checkpoint_path = checkpoint_path
        self.checkpoint_every = int(checkpoint_every)
        self.windows_run = 0
        self.checkpoints_written = 0
        self.decisions: deque[dict] = deque(maxlen=decision_log)
        self._step_ms: deque[float] = deque(maxlen=latency_log)
        self._ingest_lag_ms: deque[float] = deque(maxlen=latency_log)
        self._submit_walltime: dict[int, float] = {}
        # running trace aggregates (histograms sum exactly across windows)
        self._slack_hist: Optional[np.ndarray] = None
        self._latency_hist: Optional[np.ndarray] = None
        self._last_gauges = dict(eq_depth=0, cq_depth=0, slots_busy=0)
        # -- robustness: bounded ingest + idempotent replay ---------------
        if shed_policy not in ("reject", "degrade"):
            raise ValueError(
                f"shed_policy must be 'reject' or 'degrade', "
                f"got {shed_policy!r}")
        if max_pending_ticks < self.window_ticks:
            raise ValueError(
                f"max_pending_ticks ({max_pending_ticks}) must cover at "
                f"least one window ({self.window_ticks} ticks)")
        self.max_pending_ticks = int(max_pending_ticks)
        self.shed_policy = shed_policy
        self.shed_tasks = 0
        self.degrade_windows = 0
        self.late_events = 0
        self.duplicate_events = 0
        # fixed-shape dedupe ring (checkpointable): last N task ids seen
        self._dedupe_ids = np.full(int(dedupe_window), -1, np.int64)
        self._dedupe_pos = 0
        self._dedupe_set: set[int] = set()

    def _new_builder(self, start_tick: int) -> SignalWindowBuilder:
        return SignalWindowBuilder(
            self.n_edges, len(self.models), dt=self.dt,
            start_tick=start_tick, order_seed=self.order_seed,
            device=self.device)

    # -- telemetry ingestion ----------------------------------------------
    def _midx(self, model: Union[int, str]) -> int:
        return self._model_idx[model] if isinstance(model, str) else int(model)

    def _remember(self, task_id: int) -> None:
        evicted = int(self._dedupe_ids[self._dedupe_pos
                                       % len(self._dedupe_ids)])
        if evicted >= 0:
            self._dedupe_set.discard(evicted)
        self._dedupe_ids[self._dedupe_pos % len(self._dedupe_ids)] = task_id
        self._dedupe_set.add(int(task_id))
        self._dedupe_pos += 1

    def submit(self, t_ms: float, edge: int, model: Union[int, str],
               task_id: Optional[int] = None) -> int:
        """A task arrival at ``edge``; returns its scheduled tick.

        ``task_id`` (a non-negative int) makes the call idempotent:
        redeliveries of an id still in the dedupe ring return ``-1``
        without scheduling anything.  A ``-1`` return also signals a
        shed arrival under the ``"reject"`` backpressure policy; late
        arrivals (behind the emit cursor) clamp forward and are counted
        in ``late_events``.
        """
        if task_id is not None:
            if int(task_id) < 0:
                raise ValueError(f"task_id must be >= 0, got {task_id}")
            if int(task_id) in self._dedupe_set:
                self.duplicate_events += 1
                return -1
        if int(t_ms / self.dt) < self.tick:
            self.late_events += 1
        while int(t_ms / self.dt) >= self.tick + self.max_pending_ticks:
            if self.shed_policy == "reject":
                self.shed_tasks += 1
                return -1
            # "degrade": force-step the oldest pending window to make
            # room — admission wins over telemetry completeness
            self.degrade_windows += 1
            self._advance(self.window_ticks)
        if task_id is not None:
            self._remember(int(task_id))
        tick = self.builder.add_arrival(t_ms, edge, self._midx(model))
        count("ctl.submitted")
        # first submission per tick stamps the wall clock for lag stats
        self._submit_walltime.setdefault(tick, time.perf_counter())
        return tick

    def observe_bandwidth(self, t_ms: float, mbps: float,
                          edge: Optional[int] = None) -> None:
        self.builder.set_bandwidth(t_ms, mbps, edge)

    def observe_theta(self, t_ms: float, theta_ms: float,
                      edge: Optional[int] = None) -> None:
        self.builder.set_theta(t_ms, theta_ms, edge)

    def observe_load(self, t_ms: float, mult: float,
                     edge: Optional[int] = None) -> None:
        self.builder.set_load(t_ms, mult, edge)

    def observe_cloud(self, t_ms: float, up: bool) -> None:
        self.builder.set_cloud_up(t_ms, up)

    def observe_edge_up(self, t_ms: float, up: bool,
                        edge: Optional[int] = None) -> None:
        """Edge liveness telemetry — ``False`` crashes the edge (queue
        flush, no admission) from ``t_ms`` until set ``True`` again."""
        self.builder.set_edge_up(t_ms, up, edge)

    def observe_link_up(self, t_ms: float, up: bool,
                        edge: Optional[int] = None) -> None:
        """Edge↔cloud link telemetry — ``False`` partitions the edge
        (cloud dispatches park, GEMS migration halts)."""
        self.builder.set_link_up(t_ms, up, edge)

    # -- stepping ----------------------------------------------------------
    @property
    def tick(self) -> int:
        """The next tick to be scheduled (the window builder's cursor)."""
        return self.builder.cursor

    @property
    def now_ms(self) -> float:
        """Simulation time already scheduled."""
        return self.tick * self.dt

    def poll(self, now_ms: float) -> list[dict]:
        """Advance over every complete ``window_ticks`` window ≤ ``now_ms``.

        Returns the new per-tick decision records (also appended to
        :attr:`decisions`).  Ticks at or after ``now_ms`` stay buffered —
        they may still receive telemetry.
        """
        out: list[dict] = []
        with span("ctl.poll"):
            while self.tick + self.window_ticks <= int(now_ms / self.dt):
                out.extend(self._advance(self.window_ticks))
        return out

    def close(self) -> list[dict]:
        """Flush buffered telemetry as one final (ragged) window."""
        n = self.builder.pending_ticks
        return self._advance(n) if n else []

    def step_signals(self, window: FleetSignals) -> list[dict]:
        """Advance over an externally compiled window (replay bridging).

        The streaming-equivalence path: feeding
        :func:`repro_torch.scenarios.compile.compile_fleet` output
        window by window through this method reproduces
        :func:`~repro_torch.sim.fleet.run_fleet` bitwise.  The internal
        builder's cursor is kept in step so :meth:`metrics_snapshot`
        reports the right time.
        """
        n = int(window.times.shape[0])
        self.builder = self._new_builder(self.tick + n)
        return self._run_window(window)

    def _advance(self, n_ticks: int) -> list[dict]:
        with span("ctl.emit"):
            window = self.builder.emit_window(n_ticks)
        return self._run_window(window)

    def _run_window(self, window: FleetSignals) -> list[dict]:
        tick0 = self.tick - int(window.times.shape[0])
        with span("ctl.step") as step:
            self.state, res = self.prog.step_chunk(
                self._prof, self._pp, self.state, window,
                _capture=self._capture)
            if self.device.type == "cuda":
                # the step's latency is the card's: wait for it
                with span("ctl.wait"):
                    torch.cuda.synchronize(self.device)
        self._step_ms.append(step.seconds * 1e3)
        wall = step.end_ns / 1e9
        with span("ctl.record"):
            records = self._record(tick0, res)
        for tk in list(self._submit_walltime):
            if tk < self.tick:
                self._ingest_lag_ms.append(
                    (wall - self._submit_walltime.pop(tk)) * 1e3)
        self.windows_run += 1
        if (self.checkpoint_path is not None and
                self.windows_run % self.checkpoint_every == 0):
            self.checkpoint()
        return records

    def _record(self, tick0: int, res) -> list[dict]:
        if res is None or res.counters is None:
            return []
        tr = type(res.counters)(*(_host(a) for a in res.counters))
        events = {f: getattr(tr, f).sum(axis=1) for f in _DECISION_FIELDS}
        hit, miss = tr.hit.sum(axis=(1, 2)), tr.miss.sum(axis=(1, 2))
        drop, stolen = tr.drop.sum(axis=(1, 2)), tr.stolen.sum(axis=(1, 2))
        records = []
        for i in range(tr.arrivals.shape[0]):
            rec = dict(tick=tick0 + i, time_ms=(tick0 + i) * self.dt,
                       hit=int(hit[i]), miss=int(miss[i]),
                       drop=int(drop[i]), stolen=int(stolen[i]))
            rec.update({f: int(v[i]) for f, v in events.items()})
            records.append(rec)
        self.decisions.extend(records)
        h = tr.slack_hist.reshape(-1, tr.slack_hist.shape[-1]).sum(0)
        self._slack_hist = h if self._slack_hist is None \
            else self._slack_hist + h
        h = tr.latency_hist.reshape(-1, tr.latency_hist.shape[-1]).sum(0)
        self._latency_hist = h if self._latency_hist is None \
            else self._latency_hist + h
        self._last_gauges = dict(
            eq_depth=int(tr.eq_depth[-1].sum()),
            cq_depth=int(tr.cq_depth[-1].sum()),
            slots_busy=int(tr.slots_busy[-1].sum()))
        return records

    # -- observability -----------------------------------------------------
    def reset_latency_stats(self) -> None:
        """Drop step-latency / ingest-lag samples (e.g. after warmup, so
        benchmark percentiles exclude the one-off window capture)."""
        self._step_ms.clear()
        self._ingest_lag_ms.clear()

    @property
    def step_latencies_ms(self) -> list[float]:
        """Wall-clock per-window step latencies (recent, bounded)."""
        return list(self._step_ms)

    @property
    def ingest_lags_ms(self) -> list[float]:
        """Wall-clock first-submit→decision lags per stepped tick."""
        return list(self._ingest_lag_ms)

    def summary(self) -> dict:
        """Mission-so-far scalar metrics (the replay ``fleet_summary``)."""
        from repro_torch.scenarios.runner import fleet_summary
        return fleet_summary(self.state)

    def metrics_snapshot(self) -> dict:
        """Live scoreboard — the :class:`~repro_torch.serve.engine.
        ServeEngine` endpoint's controller twin, cheap enough to poll.

        ``spans`` are the :func:`repro_torch.obs.prof.span_table` rows of
        the ``ctl.*`` and ``fleet.*`` spans and ``counters`` every
        counter.  Both are the process's table, shared by every
        controller and tick program in it; ``repro_torch.obs.prof.
        tracing(False)`` stops the spans (the counters still count), and
        a ``profile_trace`` of the process carries them as ranges."""
        from repro_torch.obs.metrics import hist_percentiles

        def pcts(a: Sequence[float]) -> dict:
            arr = np.asarray(a, dtype=np.float64)
            if arr.size == 0:
                return {f"p{q:g}": None for q in (50, 95, 99)}
            return {f"p{q:g}": float(np.percentile(arr, q))
                    for q in (50, 95, 99)}

        snap = dict(
            now_ms=self.now_ms, tick=self.tick, policy=self.policy_name,
            n_edges=self.n_edges, window_ticks=self.window_ticks,
            windows_run=self.windows_run,
            checkpoints_written=self.checkpoints_written,
            pending_ticks=self.builder.pending_ticks,
            max_pending_ticks=self.max_pending_ticks,
            shed_policy=self.shed_policy,
            shed_tasks=self.shed_tasks,
            degrade_windows=self.degrade_windows,
            late_events=self.late_events,
            duplicate_events=self.duplicate_events,
            step_latency_ms=pcts(self._step_ms),
            ingest_to_decision_ms=pcts(self._ingest_lag_ms),
            decisions_logged=len(self.decisions),
            **self.summary())
        snap.update(self._last_gauges)
        if self._latency_hist is not None:
            snap["latency_ms"] = hist_percentiles(self._latency_hist,
                                                  self.trace)
            snap["slack_ms"] = hist_percentiles(self._slack_hist, self.trace)
        snap["spans"] = {k: v for k, v in span_table().items()
                         if k.startswith(("ctl.", "fleet."))}
        snap["counters"] = counters()
        return snap

    # -- crash restart -----------------------------------------------------
    def _ckpt_tree(self, state: EdgeState, tick: int) -> dict:
        # the dedupe ring is part of durable state: replayed task ids
        # must still be recognized after a crash restart (idempotent
        # at-least-once ingestion); both leaves are fixed-shape
        return {"state": state, "tick": np.int64(tick),
                "dedupe_ids": self._dedupe_ids.copy(),
                "dedupe_pos": np.int64(self._dedupe_pos)}

    def checkpoint(self, path: Optional[str] = None) -> str:
        """Persist scheduler state + tick cursor; returns the path stem."""
        path = path or self.checkpoint_path
        if path is None:
            raise ValueError("no checkpoint path configured")
        with span("ctl.checkpoint"):
            ckpt.save(path, self._ckpt_tree(self.state, self.tick))
        self.checkpoints_written += 1
        return path

    def restore(self, path: Optional[str] = None) -> int:
        """Resume from a checkpoint (the port's or the JAX controller's);
        returns the restored tick cursor.

        Telemetry buffered but not yet stepped when the checkpoint was
        written is *not* part of it — upstream must replay events since
        the checkpoint tick (the at-least-once ingestion contract).
        """
        path = path or self.checkpoint_path
        if path is None:
            raise ValueError("no checkpoint path configured")
        like = self._ckpt_tree(
            self.prog.init(self._prof, self._pol, self.n_edges,
                           self.cloud_slots), 0)
        data = ckpt.load(path, like)
        saved = iter(_leaves(data["state"]))
        self.state = _map(
            lambda b: torch.from_numpy(np.ascontiguousarray(next(saved)))
            .to(b.device, b.dtype), like["state"])
        tick = int(data["tick"])
        self.builder = self._new_builder(tick)
        self._submit_walltime.clear()
        self._dedupe_ids = np.asarray(data["dedupe_ids"],
                                      np.int64).copy()
        self._dedupe_pos = int(data["dedupe_pos"])
        self._dedupe_set = {int(i) for i in self._dedupe_ids if i >= 0}
        return tick


def drive_stream(ctl: FleetController, fps: dict, duration_ms: float, *,
                 poll_every_ms: Optional[float] = None,
                 stop: Optional[Callable[[], bool]] = None) -> dict:
    """Virtual-time frame-stream driver — the controller twin of
    :func:`repro_torch.serve.engine.run_stream`.

    Submits each model at its frame rate (tasks round-robined over the
    fleet's edges), polls the controller on a fixed cadence so windows
    step as soon as their ticks complete, flushes the remainder, and
    returns the final :meth:`~FleetController.metrics_snapshot`.

    ``stop`` is checked once per poll cadence; returning ``True`` ends
    the stream early but still flushes buffered ticks and (when the
    controller has a checkpoint path) writes a final checkpoint — the
    graceful-shutdown hook ``launch/serve.py`` wires to SIGINT/SIGTERM.
    """
    poll_every = poll_every_ms or ctl.window_ticks * ctl.dt
    next_at = {n: 0.0 for n in fps}
    edge_rr = 0
    now = 0.0
    while now < duration_ms:
        if stop is not None and stop():
            break
        horizon = min(now + poll_every, duration_ms)
        for n, f in fps.items():
            while next_at[n] < horizon:
                ctl.submit(next_at[n], edge_rr % ctl.n_edges, n)
                edge_rr += 1
                next_at[n] += 1000.0 / f
        now = horizon
        ctl.poll(now)
    ctl.close()
    if ctl.checkpoint_path is not None:
        ctl.checkpoint()
    return ctl.metrics_snapshot()

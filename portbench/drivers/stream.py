"""The stream driver: the live control plane (§8.8).  Each mission is a
fresh ``FleetController`` fed the paper's stream as ``(t_ms, edge,
model)`` telemetry in a closed loop in virtual time: one cadence
(``window_ticks`` ticks) of events is submitted, then ``poll`` steps
that window and returns its decision records, and only then does the
next cadence's telemetry go in.  At the mission's end the controller is
polled on until nothing is pending (an arrival that spilled past the
horizon is stepped in one more full window).  Missions restart until the
window's seconds are spent; the last one may be cut at a poll.

The traced run wraps the controller's program in CUDA events (their
spans summed are the device's busy time over the unprofiled window) and
subtracts the controller's own step latency from each poll, then
profiles a mission restart and the first polls of the next mission for
the breakdown."""
from __future__ import annotations

import time

import numpy as np
import torch

from portbench.harness import check, probes, traffic
from portbench.harness.models import model_rows
from portbench.harness.profile import run_profiled, span
from portbench.reference import tick as ref

# the profiled steady sub-window: PRE_POLLS polls into a fresh mission,
# then PROFILE_POLLS polls
PRE_POLLS = 2
PROFILE_POLLS = 4
DECISION_FIELDS = (
    "arrivals", "admit_edge", "admit_cloud", "migrated", "cloud_dispatch",
    "pool_blocked", "gems_moved", "edge_exec", "peer_out", "peer_in",
    "drop_infeasible", "drop_unstolen", "drop_qfull", "drop_crash",
    "drop_timeout")


def _events(run, slot: int) -> list:
    cfg, mix = run.config, run.mix
    return traffic.paper_events(len(mix["models"]), cfg["n_edges"],
                                cfg["drones_per_edge"], mix["mission_ms"],
                                traffic.mission_rng(run.seed, slot))


class _Mission:
    """One controller over one mission's events."""

    def __init__(self, run, FleetController, models, events, stats,
                 traced: bool):
        cfg, mix = run.config, run.mix
        with span("mission_restart"):
            self.ctl = FleetController(
                models, mix["policy"], n_edges=cfg["n_edges"], dt=cfg["dt"],
                window_ticks=mix["window_ticks"],
                cloud_slots=cfg["cloud_slots"], edge_frac=cfg["edge_frac"],
                cloud_frac=cfg["cloud_frac"], device=run.device)
        if traced and run.device.type == "cuda":
            self.ctl.prog = probes.StepEvents(self.ctl.prog)
        self.events, self.i, self.now = events, 0, 0.0
        self.cadence = mix["window_ticks"] * cfg["dt"]
        self.horizon = mix["mission_ms"]
        self.records: list = []
        self.stats = stats

    @property
    def done(self) -> bool:
        return self.now >= self.horizon and not self.ctl.builder.pending_ticks

    def step(self) -> None:
        """One cadence: submit its telemetry, then poll."""
        ctl, ev, st = self.ctl, self.events, self.stats
        hi = self.now + self.cadence
        t0 = time.perf_counter()
        with span("submit"):
            j = self.i
            while self.i < len(ev) and ev[self.i][0] < hi:
                ctl.submit(*ev[self.i])
                self.i += 1
        st["submit_s"] += time.perf_counter() - t0
        st["submits"] += self.i - j
        before = ctl.windows_run
        t0 = time.perf_counter()
        with span("poll"):
            recs = ctl.poll(hi)
        poll_ms = (time.perf_counter() - t0) * 1e3
        st["poll_ms"].append(poll_ms)
        stepped = ctl.windows_run - before
        if stepped:
            st["ctl_host_ms"].append(
                poll_ms - sum(ctl.step_latencies_ms[-stepped:]))
        self.records += recs
        self.now = hi


def drive(run) -> dict:
    from repro_torch.obs.prof import CompileCounter
    from repro_torch.scenarios.runner import fleet_summary
    from repro_torch.serve.controller import FleetController
    mix = run.mix
    models = model_rows(mix)
    t0 = time.perf_counter()
    slots = [_events(run, k) for k in range(mix["mission_slots"])]
    run.obs["inputs_s"] = time.perf_counter() - t0
    stats = dict(submit_s=0.0, submits=0, poll_ms=[], ctl_host_ms=[])
    with CompileCounter() as cc:
        warm = _Mission(run, FleetController, models, slots[0],
                        dict(stats, poll_ms=[], ctl_host_ms=[]), False)
        for _ in range(2):
            warm.step()
        run.sync()
    run.obs["warm_s"] = time.perf_counter() - t0 - run.obs["inputs_s"]
    del warm
    run.obs.update(capture_s=cc.total_secs, captures=cc.count,
                   driver="stream")
    missions = []
    run.window_opens()
    with CompileCounter() as in_window:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < run.seconds:
            ms = _Mission(run, FleetController, models,
                          slots[len(missions) % len(slots)], stats,
                          run.trace)
            missions.append(ms)
            while not ms.done and time.perf_counter() - t0 < run.seconds:
                ms.step()
        run.sync()
        run.obs["window_s"] = time.perf_counter() - t0
    run.obs["captures_in_window"] = in_window.count
    ticks = sum(m.ctl.tick for m in missions)
    run.obs.update(
        mission_s=ticks * run.config["dt"] / 1e3, missions=len(missions),
        polls=len(stats["poll_ms"]), **stats)
    if run.trace and run.device.type == "cuda":
        pairs = [p for m in missions for p in m.ctl.prog.pairs]
        run.obs["tick_device_ms"] = probes.per_tick_ms(pairs)
        run.obs["event_busy_s"] = probes.busy_s(pairs)
        nxt = _Mission(run, FleetController, models,
                       slots[len(missions) % len(slots)],
                       dict(stats, poll_ms=[], ctl_host_ms=[]), False)
        for _ in range(PRE_POLLS):
            nxt.step()

        def polls():
            for _ in range(PROFILE_POLLS):
                nxt.step()
        run.obs["profile"] = run_profiled(polls)
        run.obs["profile_ticks"] = PROFILE_POLLS * mix["window_ticks"]
    pick = int(np.random.default_rng([run.seed % 2**64, 0x5a17]).integers(
        len(missions)))
    m = missions[pick]
    sample = dict(events=slots[pick % len(slots)], models=models,
                  ticks=m.ctl.tick, records=m.records,
                  state=check.named_leaves(m.ctl.state),
                  summary=fleet_summary(m.ctl.state),
                  windows=sum(x.ctl.windows_run for x in missions))
    return dict(sample=sample)


def records_of(counters, dt: float) -> list:
    """Per-tick decision records of stacked counters, as the controller
    reads them (fleet sums of each field, outcome sums over models)."""
    tr = type(counters)(*(a.cpu().numpy() for a in counters))
    out = []
    for i in range(tr.arrivals.shape[0]):
        rec = dict(tick=i, time_ms=i * dt,
                   hit=int(tr.hit[i].sum()), miss=int(tr.miss[i].sum()),
                   drop=int(tr.drop[i].sum()),
                   stolen=int(tr.stolen[i].sum()))
        rec.update({f: int(getattr(tr, f)[i].sum())
                    for f in DECISION_FIELDS})
        out.append(rec)
    return out


def reference(run, sample: dict, quantize=None) -> dict:
    """The sampled mission's signals as a SignalWindowBuilder makes them of
    its events, run again in the reference (traced) on the host: its
    final state's leaves, summary and decision records.  ``quantize``
    makes it the control."""
    cfg, mix = run.config, run.mix
    host = traffic.stream_signals(sample["events"], len(mix["models"]),
                                  cfg["n_edges"], cfg["dt"],
                                  sample["ticks"])
    sig = ref.FleetSignals(*(torch.from_numpy(host[k])
                             for k in traffic.SIGNAL_FIELDS))
    final, counters = ref.run_mission(
        sample["models"], mix["policy"], sig, dt=cfg["dt"],
        edge_frac=cfg["edge_frac"], cloud_frac=cfg["cloud_frac"],
        cloud_slots=cfg["cloud_slots"], counters=True, quantize=quantize)
    return dict(state=check.named_leaves(final),
                summary=ref.fleet_summary(final),
                records=records_of(counters, cfg["dt"]))


def verify(run, sample: dict):
    """Numbers of the program's answers off the reference's, the windows
    stepped in the window, and 1 if the sampled mission's are wrong."""
    t0 = time.perf_counter()
    want = reference(run, sample)
    run.obs["reference_s"] = time.perf_counter() - t0
    numbers = check.state_numbers(sample["state"], want["state"])
    numbers.update(check.summary_numbers(sample["summary"], want["summary"]))
    numbers.update(check.records_numbers(sample["records"], want["records"]))
    return numbers, sample["windows"], int(any(numbers.values()))

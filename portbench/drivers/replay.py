"""The replay driver: an offline what-if evaluation.  Missions of the
mix's length run back to back through the program's entry,
``run_fleet``, each on one of the run's mission slots (signals drawn
from the seed in set-up and placed on the device), until the window's
seconds are spent; the window ends with the last mission and a sync.

The traced run drives the same missions window by window through
``FleetProgram.step_chunk``, as ``run_fleet`` does inside, with the
benchmark's spans and CUDA events around each window (their spans
summed are the device's busy time over the unprofiled window), then
profiles a mission restart and the first windows of the next mission
for the breakdown."""
from __future__ import annotations

import time

import numpy as np
import torch

from portbench.harness import check, probes, traffic
from portbench.harness.models import model_rows
from portbench.harness.profile import run_profiled, span
from portbench.reference import tick as ref

# the profiled steady sub-window: after a restart and PRE_WINDOWS windows
# and a sync, PROFILE_WINDOWS windows of one mission and the sync that
# drains them
PRE_WINDOWS = 4
PROFILE_WINDOWS = 3
# window_host_ms reads each mission's first windows, which the host
# enqueues before the device's queue holds enough to block it (about 11
# at 28 edges on an H100)
HOST_WINDOWS = 8
# set-up replays this many windows after the capture, so that what the
# first replays set up lazily is done before the window
WARM_REPLAYS = 16


def _mission_signals(run, slot: int) -> dict:
    cfg, mix = run.config, run.mix
    return traffic.steady_signals(
        len(mix["models"]), cfg["n_edges"], cfg["drones_per_edge"],
        mix["mission_ms"], cfg["dt"], mix.get("theta"),
        traffic.mission_rng(run.seed, slot))


def _on(F, host: dict, device):
    return F.FleetSignals(*(torch.from_numpy(host[k]).to(device)
                            for k in traffic.SIGNAL_FIELDS))


def drive(run) -> dict:
    from repro_torch.kernels import sched_ops
    from repro_torch.obs.prof import CompileCounter
    from repro_torch.scenarios.runner import fleet_summary
    from repro_torch.sim import fleet as F
    cfg, mix, dev = run.config, run.mix, run.device
    models = model_rows(mix)
    policy = mix["policy"]
    kw = dict(dt=cfg["dt"], edge_frac=cfg["edge_frac"],
              cloud_frac=cfg["cloud_frac"], cloud_slots=cfg["cloud_slots"])
    t0 = time.perf_counter()
    hosts = [_mission_signals(run, k) for k in range(mix["mission_slots"])]
    sigs = [_on(F, h, dev) for h in hosts]
    run.sync()
    run.obs["inputs_s"] = time.perf_counter() - t0
    n_ticks, n_edges = hosts[0]["arrive"].shape[:2]
    w = F.RUN_WINDOW_TICKS
    warm = min(n_ticks, (1 + WARM_REPLAYS) * w + n_ticks % w)
    with CompileCounter() as cc, probes.ArgextShapes(sched_ops) as shapes:
        F.run_fleet(models, policy, F.slice_signals(sigs[0], 0, warm),
                    device=dev, **kw)
        run.sync()
    run.obs["warm_s"] = time.perf_counter() - t0 - run.obs["inputs_s"]
    run.obs.update(capture_s=cc.total_secs, captures=cc.count,
                   argext_shapes=shapes.shapes, driver="replay",
                   graph_nodes=_graph_nodes(F))
    finals = []
    run.window_opens()
    with CompileCounter() as in_window:
        if run.trace:
            _traced(run, F, models, policy, sigs, finals, w)
        else:
            t0 = time.perf_counter()
            ends = []
            while True:
                finals.append(F.run_fleet(models, policy,
                                          sigs[len(finals) % len(sigs)],
                                          device=dev, **kw))
                run.sync()
                ends.append(time.perf_counter() - t0)
                if ends[-1] >= run.seconds:
                    break
            run.obs["window_s"] = ends[-1]
            run.obs["mission_s_each"] = list(np.diff([0.0] + ends))
    run.obs["captures_in_window"] = in_window.count
    run.obs["edge_ticks"] = len(finals) * n_ticks * n_edges
    run.obs["missions"] = len(finals)
    pick = int(np.random.default_rng([run.seed % 2**64, 0x5a17]).integers(
        len(finals)))
    got = finals[pick]
    sample = dict(slot=pick % len(sigs), host=hosts[pick % len(sigs)],
                  models=models, state=check.named_leaves(got),
                  summary=fleet_summary(got), attempted=len(finals))
    return dict(sample=sample)


def _graph_nodes(F) -> tuple:
    """(nodes, ticks) over every graph the program cache holds."""
    nodes = ticks = 0
    for prog in list(F._PROGRAM_REGISTRY):
        for g in prog.graphs.values():
            nodes += g.nodes
            ticks += int(g.inputs[3].times.shape[-1])
    return nodes, ticks


def _traced(run, F, models, policy, sigs, finals, w) -> None:
    cfg, dev = run.config, run.device
    pol = F.FleetPolicy.from_name(policy)
    prog = F.FleetProgram.for_policy(pol, dt=cfg["dt"],
                                     edge_frac=cfg["edge_frac"],
                                     cloud_frac=cfg["cloud_frac"])
    host_ms, pairs = [], []
    cuda = dev.type == "cuda"

    def restart(sig):
        with span("mission_restart"):
            prof = F.Profiles.build(models, dev)
            pp = pol.params(dev)
            state = prog.init(prof, pol, sig.arrive.shape[1],
                              cfg["cloud_slots"])
        return [prof, pp, state]

    def mission(sig, carry=None, los=None):
        carry = restart(sig) if carry is None else carry
        prof, pp, state = carry
        n = int(sig.times.shape[0])
        for k, lo in enumerate(range(0, n, w) if los is None else los):
            win = F.slice_signals(sig, lo, min(lo + w, n))
            if cuda:
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
            t0 = time.perf_counter()
            with span("step_chunk"):
                state, _ = prog.step_chunk(prof, pp, state, win)
            if los is None and k < HOST_WINDOWS:
                host_ms.append((time.perf_counter() - t0) * 1e3)
            if cuda:
                b.record()
                pairs.append((a, b, int(win.times.shape[0])))
        carry[2] = state
        return state

    t0 = time.perf_counter()
    while True:
        finals.append(mission(sigs[len(finals) % len(sigs)]))
        run.sync()
        if time.perf_counter() - t0 >= run.seconds:
            break
    run.obs["window_s"] = time.perf_counter() - t0
    run.obs["window_host_ms"] = host_ms
    run.obs["tick_device_ms"] = probes.per_tick_ms(pairs) if cuda else []
    if cuda:
        run.obs["event_busy_s"] = probes.busy_s(pairs)
        nxt = sigs[len(finals) % len(sigs)]
        carry = restart(nxt)
        mission(nxt, carry, [lo * w for lo in range(PRE_WINDOWS)])
        los = [lo * w for lo in range(PRE_WINDOWS,
                                      PRE_WINDOWS + PROFILE_WINDOWS)]
        run.obs["profile"] = run_profiled(lambda: mission(nxt, carry, los))
        run.obs["profile_ticks"] = PROFILE_WINDOWS * w


def reference(run, sample: dict, quantize=None) -> dict:
    """The sampled mission again in the reference, on the host: its final
    state's leaves and summary.  ``quantize`` makes it the control."""
    cfg, mix = run.config, run.mix
    host = sample["host"]
    sig = ref.FleetSignals(*(torch.from_numpy(host[k])
                             for k in traffic.SIGNAL_FIELDS))
    final, _ = ref.run_mission(
        sample["models"], mix["policy"], sig, dt=cfg["dt"],
        edge_frac=cfg["edge_frac"], cloud_frac=cfg["cloud_frac"],
        cloud_slots=cfg["cloud_slots"], quantize=quantize)
    return dict(state=check.named_leaves(final),
                summary=ref.fleet_summary(final))


def verify(run, sample: dict):
    """Numbers of the program's answers off the reference's, the answers
    attempted in the window, and those found wrong."""
    t0 = time.perf_counter()
    want = reference(run, sample)
    run.obs["reference_s"] = time.perf_counter() - t0
    numbers = check.state_numbers(sample["state"], want["state"])
    numbers.update(check.summary_numbers(sample["summary"], want["summary"]))
    return numbers, sample["attempted"], int(any(numbers.values()))

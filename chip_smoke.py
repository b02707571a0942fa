#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives the port (``src/repro_torch``) through its user entry points —
``simulate_fleet`` / ``run_fleet`` / ``FleetProgram`` — at the paper's
§8.6 fleet scale (28 edges, 84 drones) and at a 1024-edge metropolis
fleet, with the hand-written ``sm_90a`` masked arg-extremum kernel built
from ``src/repro_torch/kernels/csrc`` at first use.  Phases, each printed
on its own line and each failing the script (non-zero exit) on error:

1. device: card name, ``nvidia-smi`` name and power limit, kernel build;
2. kernel vs plain PyTorch version on the card, exact on idx and value;
3. small parity: the 2-edge golden runs on the card and on the host,
   every final-state leaf equal, summaries equal to the golden JAX ones;
4. paper-scale fleet (the main path; kernel launch counts are read over
   this phase): DEMS-A, GEMS and DEMS-COOP, 28 edges × 60 s each (DEMS-A
   under the §8.5 θ trapezium compressed 5× into 60 s), each summary
   equal to its golden JAX entry;
5. metropolis fleet: DEMS-COOP on 1024 edges, two runs bitwise equal;
6. sync check: ticks under ``torch.cuda.set_sync_debug_mode("error")``;
7. profile: CUDA launches per tick, the kernel's time per launch, and the
   nearest plain PyTorch composition's time.

The expected numbers come from ``tests/golden/torch_port_summaries.json``
(JAX summaries written by ``tests/golden/regen_torch_port_summaries.py``);
the script imports nothing of the JAX package.  Its last two lines are
the ``kernels`` JSON record and ``{"ok": true, "device": {...}}``.
"""
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")
GOLDEN = os.path.join(ROOT, "tests", "golden", "torch_port_summaries.json")
METRO_EDGES = 1024
METRO_MS = 60_000.0
# phase 5's horizon shrinks (never below MIN_METRO_MS) when the phases
# before it ran so slowly that the whole script, with RESERVE_S left for
# phases 6-7, would pass this budget (half the 1200 s the script may take)
BUDGET_S = 540.0
RESERVE_S = 60.0
MIN_METRO_MS = 10_000.0
SYNC_TICKS = 50
# the profiler's post-processing takes seconds per traced tick (thousands
# of kernels each), so the profile covers a short steady window
PROFILE_TICKS = 20
HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet, at 700 W
F32_OPS_PER_S = 67e12            # f32 outside the tensor cores, same sheet


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(f"[{time.perf_counter() - T_START:7.1f} s] {msg}", flush=True)


def leaves(tree):
    if isinstance(tree, tuple):
        for v in tree:
            yield from leaves(v)
    else:
        yield tree


def states_equal(a, b) -> bool:
    import torch
    return all(torch.equal(x.cpu(), y.cpu())
               for x, y in zip(leaves(a), leaves(b)))


def _events_ms(run, calls: int) -> float:
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def eager_ms(fn, iters: int = 200, warmup: int = 20) -> float:
    """Time per call of ``fn`` issued eagerly, in ms (CUDA events around
    ``iters`` calls): what the tick pays, bound by the host at these
    sizes."""
    for _ in range(warmup):
        fn()

    def run():
        for _ in range(iters):
            fn()
    return _events_ms(run, iters)


def graph_ms(fn, iters: int = 200, replays: int = 10) -> float:
    """Device time per call of ``fn``, in ms: ``iters`` calls captured in
    one CUDA graph and replayed, so the host does not pace the card."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()

    def run():
        for _ in range(replays):
            graph.replay()
    return _events_ms(run, iters * replays)


T_START = time.perf_counter()


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    if not (os.path.isdir(os.path.join(SRC, "repro_torch"))
            and os.path.isfile(GOLDEN)):
        fail("run from a checkout of the repository: src/repro_torch and "
             "the golden summaries are missing")
    sys.path.insert(0, SRC)
    import numpy as np

    from repro_torch.core import task
    from repro_torch.kernels import _build, ref, sched_ops
    from repro_torch.scenarios.runner import fleet_summary
    from repro_torch.sim import fleet as F
    from repro_torch.sim import network

    golden = json.load(open(GOLDEN))
    dev = torch.device("cuda")

    def models_of(spec):
        if spec in ("PASSIVE", "ACTIVE"):
            names = task.PASSIVE if spec == "PASSIVE" else task.ACTIVE
            return [task.TABLE1[n] for n in names]
        wl, alpha = spec.split("@")
        return task.table2(wl, float(alpha))

    def signals_of(run, device, n_edges=None, duration_ms=None):
        th = run["theta"]
        return F.default_signals(
            len(models_of(run["models"])),
            n_edges=n_edges or run["n_edges"],
            drones_per_edge=golden["drones_per_edge"],
            duration_ms=duration_ms or run["duration_ms"], dt=golden["dt"],
            theta_fn=None if th is None else network.trapezium(
                ramp_up=tuple(th["ramp_up"]),
                ramp_down=tuple(th["ramp_down"])),
            seed=golden["seed"], device=device)

    def run_on(run, sig, device):
        return F.run_fleet(models_of(run["models"]), run["policy"], sig,
                           dt=golden["dt"], edge_frac=golden["edge_frac"],
                           cloud_frac=golden["cloud_frac"],
                           cloud_slots=golden["cloud_slots"], device=device)

    # ---- phase 1: device and build --------------------------------------
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    smi_line = smi[0] if smi else "nvidia-smi: no output"
    say(f"phase1 device: {name}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; nvidia-smi name, power limit:")
    print(smi_line, flush=True)     # as nvidia-smi gives it, on its own
    t0 = time.perf_counter()
    builds = _build.build_all([sched_ops.KERNEL])
    say(f"phase1 build: {time.perf_counter() - t0:.3f} s "
        f"(nvcc {builds[sched_ops.KERNEL]['seconds']:.3f} s); ptxas: "
        + builds[sched_ops.KERNEL]["ptxas"].replace("\n", " | "))

    # ---- phase 2: kernel vs plain on the card ---------------------------
    rng = np.random.default_rng(20241230)
    ranks = np.asarray([0.57, 0.43, 0.35, -0.012], np.float32)
    cases = []
    for e in (1, 28, 1024):       # steal_select: ranks + 1e12 steal-only
        s = ranks[rng.integers(0, 4, (e, 64))] + np.where(
            rng.random((e, 64)) < 0.3, 1e12, 0.0)
        cases.append((True, s, rng.random((e, 64)) < 0.5))
        sl = rng.normal(0, 400.0, (e, 32))            # export_select
        sl[rng.random((e, 32)) < 0.4] = sched_ops.POS
        cases.append((False, sl, rng.random((e, 32)) < 0.3))
    for e in (2, 28, 1024):       # peer_offload: loads, POS-filled edges
        ld = np.abs(rng.normal(500.0, 300.0, (1, e)))
        ld[rng.random((1, e)) < 0.2] = sched_ops.POS
        cases.append((False, ld, np.ones((1, e), bool)))
        cases.append((False, ld, rng.random((1, e)) < 0.5))
    for is_max in (True, False):  # all-masked rows
        cases.append((is_max, rng.normal(size=(5, 64)),
                      np.zeros((5, 64), bool)))
    for n in (1, 2, 3, 5, 31, 32, 33, 63, 64, 65, 127, 128, 200, 511, 1024,
              2047, 2048):
        for b in (1, 7, 33):
            for is_max in (True, False):
                s = rng.normal(size=(b, n))
                if (n + b) % 2:
                    s = np.round(s)                   # ties
                m = rng.random((b, n)) < rng.choice([0.05, 0.5, 1.0])
                cases.append((is_max, s, m))
    max_err = 0.0
    for i, (is_max, s, m) in enumerate(cases):
        st = torch.from_numpy(np.asarray(s, np.float32))
        mt = torch.from_numpy(np.asarray(m))
        want_i, want_v = ref.ref_masked_argext(st, mt, is_max=is_max)
        got_i, got_v = sched_ops.masked_argext(st.to(dev), mt.to(dev),
                                               is_max=is_max)
        torch.cuda.synchronize()
        got_i, got_v = got_i.cpu(), got_v.cpu()
        if not (torch.equal(got_i, want_i) and torch.equal(got_v, want_v)):
            fail(f"masked_argext case {i} shape {tuple(st.shape)} "
                 f"is_max={is_max}: kernel differs from the plain version")
        max_err = max(max_err, float((got_v.double()
                                      - want_v.double()).abs().max()))
    say(f"phase2 kernels: masked_argext {len(cases)} cases equal to the "
        f"plain version (max_abs_err {max_err})")

    # timing at the main path's hottest shape: steal_select over (28, 64)
    e, n = 28, 64
    s = torch.from_numpy((ranks[rng.integers(0, 4, (e, n))] + np.where(
        rng.random((e, n)) < 0.3, 1e12, 0.0)).astype(np.float32)).to(dev)
    m = torch.from_numpy(rng.random((e, n)) < 0.5).to(dev)
    fns = {"kernel": lambda: sched_ops.cuda_masked_argext(s, m, is_max=True),
           "plain": lambda: ref.ref_masked_argext(s, m, is_max=True),
           "torch.max(where)": lambda: torch.max(
               torch.where(m, s, sched_ops.NEG), dim=-1)}
    dev_ms = {k: graph_ms(f) for k, f in fns.items()}
    call_ms = {k: eager_ms(f) for k, f in fns.items()}
    k_ms, plain_ms, compo_ms = dev_ms.values()
    # least time for the work: each score and mask byte read once, idx and
    # value written once; a select and a compare per entry in f32
    bytes_ms = (e * n * (4 + 1) + e * (4 + 4)) / HBM_BYTES_PER_S * 1e3
    ops_ms = 2 * e * n / F32_OPS_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
    # other main-path shapes: (1, 32) export, (1, 28) peer, (1024, 64)
    shape_ms = {}
    for (b, nn, mx) in ((1, 32, False), (1, 28, False), (1024, 64, True)):
        ss = torch.randn(b, nn, device=dev)
        mm = torch.rand(b, nn, device=dev) < 0.5
        shape_ms[f"{b}x{nn}"] = graph_ms(
            lambda: sched_ops.cuda_masked_argext(ss, mm, is_max=mx))
    say(f"phase2 timing (28x64), device ms per call (graph replay): "
        f"{json.dumps(dev_ms)}; issued eagerly, ms per call: "
        f"{json.dumps(call_ms)}; bound {bound_ms:.7f} ms ({bound_by}: bytes "
        f"{bytes_ms:.7f} ms, operations {ops_ms:.7f} ms); kernel at other "
        f"shapes, device ms: {json.dumps(shape_ms)}")

    # ---- phase 3: small parity, card vs host vs golden ------------------
    for run in (r for r in golden["runs"] if r["phase"] == 3):
        finals, secs = {}, {}
        for where, d in (("card", "cuda"), ("host", "cpu")):
            t0 = time.perf_counter()
            finals[where] = run_on(run, signals_of(run, d), d)
            torch.cuda.synchronize()
            secs[where] = time.perf_counter() - t0
        if not states_equal(finals["card"], finals["host"]):
            fail(f"{run['name']}: card and host final states differ")
        summ = fleet_summary(finals["card"])
        if summ != run["summary"]:
            fail(f"{run['name']}: summary {summ} != golden "
                 f"{run['summary']}")
        say(f"phase3 {run['name']}: card == host (every leaf), summary == "
            f"golden; card {secs['card']:.2f} s, host {secs['host']:.2f} s")

    # ---- phase 4: paper-scale fleet (the main path) ---------------------
    sched_ops.reset_count()
    paper = {}
    for run in (r for r in golden["runs"] if r["phase"] == 4):
        sig = signals_of(run, "cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        final = run_on(run, sig, "cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        summ = fleet_summary(final)
        if summ != run["summary"]:
            fail(f"{run['name']}: summary {summ} != golden "
                 f"{run['summary']}")
        ticks = int(sig.times.shape[0])
        paper[run["name"]] = dict(wall_s=wall, ticks_per_s=ticks / wall,
                                  edge_ticks_per_s=ticks * run["n_edges"]
                                  / wall)
        say(f"phase4 {run['name']}: summary == golden {json.dumps(summ)}; "
            f"{ticks} ticks × {run['n_edges']} edges in {wall:.2f} s = "
            f"{ticks / wall:.2f} ticks/s, "
            f"{ticks * run['n_edges'] / wall:.1f} edge-ticks/s")
    launches = sched_ops.launch_count
    if launches <= 0:
        fail("phase 4 ran no masked_argext launch")
    say(f"phase4 launches: masked_argext {launches}")

    # ---- phase 5: metropolis fleet -------------------------------------
    coop = next(r for r in golden["runs"] if r["name"] == "paper-dems-coop")
    # launch-bound: a 1024-edge tick costs about what a 28-edge one does;
    # fit two runs, whole seconds of horizon, into what the budget leaves
    tick_s = paper["paper-dems-coop"]["wall_s"] * golden["dt"] / coop[
        "duration_ms"]
    left = BUDGET_S - RESERVE_S - (time.perf_counter() - T_START)
    fit_ms = 1000.0 * int(left / (2.0 * tick_s) * golden["dt"] / 1000.0)
    metro_ms = min(METRO_MS, max(MIN_METRO_MS, fit_ms))
    metro = []
    for _ in range(2):
        sig = signals_of(coop, "cuda", n_edges=METRO_EDGES,
                         duration_ms=metro_ms)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        final = run_on(coop, sig, "cuda")
        torch.cuda.synchronize()
        metro.append((final, time.perf_counter() - t0,
                      torch.cuda.max_memory_allocated()))
    if not states_equal(metro[0][0], metro[1][0]):
        fail("metropolis runs are not deterministic")
    summ = fleet_summary(metro[0][0])
    if not (summ["stolen"] > 0 and summ["peer_offloaded"] > 0):
        fail(f"metropolis run did not steal and peer-offload: {summ}")
    ticks = int(metro_ms / golden["dt"])
    wall = min(w for _, w, _ in metro)
    say(f"phase5 metropolis DEMS-COOP {METRO_EDGES} edges × "
        f"{metro_ms / 1e3:.0f} s: two runs bitwise equal; "
        f"{json.dumps(summ)}; {ticks / wall:.2f} ticks/s, "
        f"{ticks * METRO_EDGES / wall:.1f} edge-ticks/s (best of 2: "
        f"{metro[0][1]:.2f} s, {metro[1][1]:.2f} s); max memory allocated "
        f"{metro[0][2]} B")

    # ---- phase 6: the tick never waits on the host ----------------------
    models = models_of(coop["models"])
    prof = F.Profiles.build(models, dev)
    pol = F.FleetPolicy.from_name(coop["policy"])
    pp = pol.params(dev)
    prog = F.FleetProgram.for_policy(pol, dt=golden["dt"])
    sig = signals_of(coop, "cuda", duration_ms=(SYNC_TICKS + PROFILE_TICKS
                                                + 20) * golden["dt"])
    state = prog.init(prof, pol, coop["n_edges"], golden["cloud_slots"])
    state, _ = prog.step_chunk(prof, pp, state, F.slice_signals(sig, 0, 10))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, _ = prog.step_chunk(prof, pp, state,
                                   F.slice_signals(sig, 10, 10 + SYNC_TICKS))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    say(f"phase6 sync: {SYNC_TICKS} DEMS-COOP ticks at {coop['n_edges']} "
        f"edges ran under set_sync_debug_mode('error')")

    # ---- phase 7: profile ----------------------------------------------
    from torch.profiler import ProfilerActivity, profile
    lo = 10 + SYNC_TICKS
    before = sched_ops.launch_count
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof_run:
        t0 = time.perf_counter()
        state, _ = prog.step_chunk(prof, pp, state,
                                   F.slice_signals(sig, lo,
                                                   lo + PROFILE_TICKS))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    tick_launches = sched_ops.launch_count - before
    kernels = [ev for ev in prof_run.events()
               if ev.device_type == torch.autograd.DeviceType.CUDA]
    n_dev = len(kernels)
    busy_us = sum(ev.time_range.elapsed_us() for ev in kernels)
    ours = [ev for ev in kernels if "masked_argext" in ev.name]
    ours_us = sum(ev.time_range.elapsed_us() for ev in ours) / max(
        len(ours), 1)
    if n_dev and not ours:
        fail("profile shows no masked_argext kernel in the tick")
    say(f"phase7 profile ({PROFILE_TICKS} DEMS-COOP ticks, "
        f"{coop['n_edges']} edges): {n_dev / PROFILE_TICKS:.1f} device "
        f"kernels per tick, masked_argext {tick_launches / PROFILE_TICKS:.1f}"
        f" launches per tick at {ours_us:.3f} us per launch; device busy "
        f"{busy_us / 1e3:.2f} ms of {wall * 1e3:.2f} ms wall "
        f"({busy_us / 1e6 / wall:.3f}); torch.max(where) on (28, 64): "
        f"{compo_ms * 1e3:.3f} us")

    print(json.dumps({"kernels": [{
        "name": "masked_argext", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/masked_argext.cu",
        "replaces": "src/repro/kernels/sched_ops.py:41",
        "launches": launches, "max_abs_err": max_err, "ms": k_ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

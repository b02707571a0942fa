"""The port's fleet tick beside another checkout's, in one call.

Times the untraced tick (and this tree's traced one) of phase 4's
heaviest run, DEMS-COOP at 28 edges × 3 drones on the ACTIVE models,
through ``FleetProgram.step_chunk`` (on the card a CUDA-graph replay
where the tree captures one; a tree that does also times its eager path,
``_capture=False``), and counts the PyTorch operations a tick dispatches
(every ATen call, views included, and the views alone):

    python3 tools/tick_ab.py --other DIR            # on a card
    python3 tools/tick_ab.py --other DIR --device cpu --ticks 20 --windows 1

``DIR`` holds another checkout (its ``src/repro_torch``).  Each tree runs
in a process of its own, in the order other, this, this, other, so that
a drift of the host's speed shows as a gap between the two runs of one
tree.  The result is one JSON object on the last line: per run, ticks/s
of each timed window (host wall time ending in a device synchronize)
and the operation counts, which come from a CPU replay of ``--count``
ticks in the same process (the dispatch is the device's but for the
selection kernel, whose CPU path is its plain version in both trees).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_EDGES = 28
DRONES = 3
CLOUD_SLOTS = 16
DT = 25.0
WARM_TICKS = 20


def _program(F, traced: bool):
    from repro_torch.core import task
    models = [task.TABLE1[n] for n in task.ACTIVE]
    pol = F.FleetPolicy.from_name("DEMS-COOP")
    kw = {}
    if traced:
        from repro_torch.obs.trace import TraceSpec
        kw["trace"] = TraceSpec.full()
    return models, pol, F.FleetProgram.for_policy(pol, dt=DT, **kw)


def _setup(F, device, traced: bool, ticks: int):
    models, pol, prog = _program(F, traced)
    prof = F.Profiles.build(models, device)
    pp = pol.params(device)
    sig = F.default_signals(len(models), n_edges=N_EDGES,
                            drones_per_edge=DRONES,
                            duration_ms=(WARM_TICKS + ticks) * DT, dt=DT,
                            seed=0, device=device)
    state = prog.init(prof, pol, N_EDGES, CLOUD_SLOTS)
    return prog, prof, pp, sig, state


def count_ops(F, traced: bool, ticks: int) -> dict:
    """ATen calls a tick on the CPU, all and views, over ``ticks`` ticks
    after the warm-up window."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.all = self.views = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.all += 1
            self.views += bool(getattr(func, "is_view", False))
            return func(*args, **(kwargs or {}))

    prog, prof, pp, sig, state = _setup(F, "cpu", traced, ticks)
    state, _ = prog.step_chunk(prof, pp, state,
                               F.slice_signals(sig, 0, WARM_TICKS))
    mode = Count()
    with mode:
        prog.step_chunk(prof, pp, state,
                        F.slice_signals(sig, WARM_TICKS, WARM_TICKS + ticks))
    del torch
    return dict(ops_per_tick=mode.all / ticks,
                views_per_tick=mode.views / ticks,
                non_view_per_tick=(mode.all - mode.views) / ticks)


def can_capture(F) -> bool:
    """Whether the tree's ``step_chunk`` takes ``_capture``."""
    import inspect
    return "_capture" in inspect.signature(
        F.FleetProgram.step_chunk).parameters


def time_ticks(F, device: str, traced: bool, ticks: int,
               windows: int, eager: bool = False) -> list:
    """Ticks/s of each of ``windows`` windows of ``ticks`` ticks, after an
    untimed one of the same width (a new window shape's first window is
    the warm-up and capture of its graph); ``eager`` passes
    ``_capture=False``."""
    import torch

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    kw = {"_capture": False} if eager else {}
    prog, prof, pp, sig, state = _setup(F, device, traced,
                                        ticks * (windows + 1))
    state, _ = prog.step_chunk(prof, pp, state,
                               F.slice_signals(sig, 0, WARM_TICKS), **kw)
    state, _ = prog.step_chunk(
        prof, pp, state, F.slice_signals(sig, WARM_TICKS,
                                         WARM_TICKS + ticks), **kw)
    rates = []
    for w in range(1, windows + 1):
        lo = WARM_TICKS + w * ticks
        sync()
        t0 = time.perf_counter()
        state, _ = prog.step_chunk(prof, pp, state,
                                   F.slice_signals(sig, lo, lo + ticks),
                                   **kw)
        sync()
        rates.append(ticks / (time.perf_counter() - t0))
    return rates


def worker(args) -> dict:
    sys.path.insert(0, os.path.join(args.tree, "src"))
    import repro_torch
    from repro_torch.sim import fleet as F
    here = os.path.realpath(os.path.dirname(repro_torch.__file__))
    if not here.startswith(os.path.realpath(args.tree) + os.sep):
        raise SystemExit(f"imported repro_torch from {here}, not from "
                         f"{args.tree}")
    import torch
    out = dict(tree=args.tree)
    out["untraced_ticks_per_s"] = time_ticks(F, args.device, False,
                                             args.ticks, args.windows)
    if can_capture(F):
        out["eager_ticks_per_s"] = time_ticks(F, args.device, False,
                                              args.ticks, args.windows,
                                              eager=True)
    out["untraced_ops"] = count_ops(F, False, args.count)
    if args.traced:
        out["traced_ticks_per_s"] = time_ticks(F, args.device, True,
                                               args.ticks, args.windows)
        out["traced_ops"] = count_ops(F, True, args.count)
    if args.device == "cuda":
        out["device"] = torch.cuda.get_device_name(0)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", help="another checkout to time beside this")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ticks", type=int, default=100,
                    help="ticks a timed window")
    ap.add_argument("--windows", type=int, default=3)
    ap.add_argument("--count", type=int, default=10,
                    help="ticks of the CPU operation count")
    ap.add_argument("--tree", help=argparse.SUPPRESS)
    ap.add_argument("--traced", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.tree:
        print(json.dumps(worker(args)), flush=True)
        return 0
    if args.device == "cuda":
        import torch
        if not torch.cuda.is_available():
            print("tick_ab: no CUDA device", file=sys.stderr)
            return 2
    other = os.path.abspath(args.other) if args.other else None
    order = [other, ROOT, ROOT, other] if other else [ROOT]
    runs = []
    for tree in order:
        cmd = [sys.executable, os.path.abspath(__file__), "--tree", tree,
               "--device", args.device, "--ticks", str(args.ticks),
               "--windows", str(args.windows), "--count", str(args.count)]
        if tree == ROOT:
            cmd.append("--traced")
        res = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=1800)
        if res.returncode != 0:
            sys.stderr.write(res.stderr)
            return res.returncode
        run = json.loads(res.stdout.strip().splitlines()[-1])
        run["which"] = "this" if tree == ROOT else "other"
        runs.append(run)
        print(json.dumps(run), flush=True)
    if args.device == "cuda":
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
        print(smi, flush=True)
    print(json.dumps(dict(edges=N_EDGES, policy="DEMS-COOP", runs=runs)))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Readings the limits of ``correct`` are set from, on the card.

    python3 portbench/calibrate.py --workload <name> --seeds 12 --control 3

For each of ``--seeds`` seeds, one short run of the cell at its own
size (set-up, then a window of one mission: every seed's program answers
at the cell's load) and the check against the plain reference: the
*lower* readings.  For the first ``--control`` seeds, the control: the
reference again with every float input and float state leaf rounded to
bfloat16 after each tick (the nearest precision below the float32 the
configurations state), put in the program's place and checked alike:
the *upper* readings.  The references run in a pool of host processes,
one thread each, while the card runs the next seed.  One JSON line a
seed and a summary line (``lower``: the largest program reading of each
number; ``upper``: the smallest control reading).  The benchmark's own
runs never run this.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import multiprocessing  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

SEED0 = 7_100_000_000


def bf16(a):
    import torch
    return a.to(torch.bfloat16).to(a.dtype)


def _check(job):
    """In a worker: the program's numbers, or the control's."""
    import torch
    torch.set_num_threads(1)
    from portbench.harness import check, registry
    kind, run, mix_driver, sample = job
    drv = registry.driver(mix_driver)
    t0 = time.perf_counter()
    if kind == "control":
        ctl = drv.reference(run, sample, quantize=bf16)
        sample = dict(sample, **ctl)
    numbers, _, _ = drv.verify(run, sample)
    return dict(kind=kind, seed=run.seed, numbers=numbers,
                correct=check.is_correct(check.limits(numbers)),
                seconds=time.perf_counter() - t0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=SEED0)
    ap.add_argument("--seconds", type=float, default=0.01,
                    help="the window; a replay's holds one mission at least")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--workers", type=int, default=7)
    args = ap.parse_args(argv)
    import torch
    from portbench.harness import core
    torch.set_num_threads(1)
    seeds = [args.first_seed + 7919 * i for i in range(args.seeds)]
    ctx = multiprocessing.get_context("spawn")
    pending = []
    with ctx.Pool(args.workers) as pool:
        for i, seed in enumerate(seeds):
            run, drv, sample = core.measure(args.workload, seed, args.seconds,
                                            False,
                                            device=args.device)
            run.obs.pop("profile", None)
            job = (run, run.mix["driver"], sample)
            kinds = ("program", "control") if i < args.control \
                else ("program",)
            for kind in kinds:
                pending.append(pool.apply_async(_check, ((kind,) + job,)))
        rows = [p.get(timeout=3600) for p in pending]
    for r in rows:
        print(json.dumps(r), flush=True)
    out = {}
    for kind, pick in (("program", max), ("control", min)):
        got = [r["numbers"] for r in rows if r["kind"] == kind]
        if got:
            out["lower" if kind == "program" else "upper"] = {
                k: pick(g[k] for g in got) for k in got[0]}
    out.update(workload=args.workload, seeds=len(seeds),
               program_correct=sum(r["correct"] for r in rows
                                   if r["kind"] == "program"),
               control_correct=sum(r["correct"] for r in rows
                                   if r["kind"] == "control"),
               seconds=time.perf_counter() - T_START)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

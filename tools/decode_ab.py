"""The port's served decode step, replayed beside eager, and beside
another checkout's, in one call.

Times the decode step of phase 7's path (granite-3-2b at its published
size, bf16, ``attn_impl="kernel"``: B 8 from a 512-token prompt,
greedy), each step on the host's clock ending in a device synchronize,
after ``--warm`` untimed steps: first eagerly (``Model.decode_step`` at
an int position), then, where the tree has it, as a ``DecodeProgram``
from the same prefilled cache (the warm step and the capture untimed,
then replays at a device position, the first replay held bitwise to an
eager step at the same position).  On a card one replay runs under
``torch.profiler``: its device kernels by name (count and µs), so the
``decode_attention`` kernel's time a launch can be read off a replay,
and the replay's device span read with CUDA events.

    python3 tools/decode_ab.py                        # this tree, a card
    python3 tools/decode_ab.py --other DIR            # beside another
    python3 tools/decode_ab.py --device cpu --layers 2 --steps 4

``DIR`` holds another checkout (its ``src/repro_torch``).  Each tree runs
in a process of its own, in the order other, this, this, other, so that
a drift of the host's speed shows as a gap between the two runs of one
tree.  The result is one JSON object on the last line: per run the
eager and replayed step times in ms, sorted, their p50s, the graph's
nodes and capture seconds, the replay's kernels, and the ATen calls
(all, and the views among them) that one more eager step dispatches.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def count_ops(fn) -> dict:
    """The ATen calls that ``fn()`` dispatches, all and views."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.all = self.views = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.all += 1
            self.views += bool(getattr(func, "is_view", False))
            return func(*args, **(kwargs or {}))

    with Count() as c:
        fn()
    return {"all": c.all, "views": c.views}


def replay_kernels(graph) -> dict:
    """One replay of ``graph`` under ``torch.profiler``: its device
    kernels by name, {name: [count, µs]}, and their total µs."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as pr:
        graph.replay()
        torch.cuda.synchronize()
    by_name = {}
    for e in pr.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            row = by_name.setdefault(e.name, [0, 0.0])
            row[0] += 1
            row[1] += e.time_range.elapsed_us()
    return dict(by_name=by_name,
                busy_us=sum(us for _, us in by_name.values()))


def worker(args) -> dict:
    sys.path.insert(0, os.path.join(args.tree, "src"))
    import torch
    from repro_torch.configs.registry import ARCHS
    from repro_torch.models import model as M
    Model = M.Model
    dev = args.device
    cfg = dataclasses.replace(ARCHS[args.arch], attn_impl="kernel")
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    model = Model(cfg, dev)
    params = model.init(gen)
    prompt = torch.randint(0, cfg.vocab, (args.batch, args.prompt),
                           generator=gen, device=dev)

    def sync():
        if dev == "cuda":
            torch.cuda.synchronize()

    times = []
    n = args.warm + args.steps
    max_seq = args.prompt + n + 2
    with torch.no_grad():
        last, cache = model.prefill(params, {"tokens": prompt}, max_seq)
        first = last[:, -1].argmax(-1, keepdim=True)
        prefilled = {k: v.clone() for k, v in cache.items()}
        tok = first
        for t in range(n):
            sync()
            t0 = time.perf_counter()
            logits, cache = model.decode_step(params, cache, tok,
                                              args.prompt + t)
            tok = logits[:, -1].argmax(-1, keepdim=True)
            sync()
            if t >= args.warm:
                times.append((time.perf_counter() - t0) * 1e3)
        ops = count_ops(lambda: model.decode_step(params, cache, tok,
                                                  args.prompt + n))
    times.sort()
    out = dict(tree=args.tree, arch=cfg.name, layers=cfg.n_layers,
               batch=args.batch, prompt=args.prompt,
               p50_ms=times[len(times) // 2], ops=ops, ms=times)
    if hasattr(M, "DecodeProgram"):
        out.update(replayed(args, M, model, params, prefilled, first, sync))
    if dev == "cuda":
        out["device"] = torch.cuda.get_device_name(0)
    return out


def replayed(args, M, model, params, prefilled: dict, tok, sync) -> dict:
    """The same steps through a ``DecodeProgram`` whose cache starts
    from the prefilled one: the warm step and the capture, then
    ``--warm`` untimed and ``--steps`` timed replays; the first replay
    held bitwise to an eager step at the same position."""
    import torch
    program = M.DecodeProgram(model, params, prefilled)
    pos = torch.full((), args.prompt, dtype=torch.int32,
                     device=tok.device)
    times, checked = [], False
    n = args.warm + args.steps + 1
    with torch.no_grad():
        for t in range(n):
            want = None
            if t == 1:
                twin = {k: v.clone() for k, v in program.cache.items()}
                want = model.decode_step(params, twin, tok,
                                         args.prompt + t)[0]
            sync()
            t0 = time.perf_counter()
            logits = program(tok, pos)
            sync()
            if want is not None:
                if not torch.equal(logits, want):
                    raise SystemExit("decode_ab: a replay differs from the "
                                     "eager step at its position")
                checked = True
            if t > args.warm:
                times.append((time.perf_counter() - t0) * 1e3)
            pos.add_(1)
            tok = logits[:, -1].argmax(-1, keepdim=True)
    times.sort()
    out = dict(replay_p50_ms=times[len(times) // 2], replay_ms=times,
               replay_checked=checked, nodes=program.nodes,
               capture_s=program.capture_s, replays=program.replays)
    if program.graph is not None:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        sync()
        start.record()
        program.graph.replay()
        end.record()
        sync()
        out["replay_span_ms"] = start.elapsed_time(end)
        out["replay_kernels"] = replay_kernels(program.graph)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", help="another checkout to time beside this")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth (0: the published depth)")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt", type=int, default=512)
    ap.add_argument("--warm", type=int, default=8)
    ap.add_argument("--steps", type=int, default=64)
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--tree", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.tree:
        print(json.dumps(worker(args)), flush=True)
        return 0
    if args.device == "cuda":
        import torch
        if not torch.cuda.is_available():
            print("decode_ab: no CUDA device", file=sys.stderr)
            return 2
    other = os.path.abspath(args.other) if args.other else None
    order = [other, ROOT, ROOT, other] if other else [ROOT]
    runs = []
    for tree in order:
        cmd = [sys.executable, os.path.abspath(__file__), "--tree", tree]
        for key in ("device", "arch", "layers", "batch", "prompt", "warm",
                    "steps", "seed"):
            cmd += [f"--{key}", str(getattr(args, key))]
        res = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=1800)
        if res.returncode != 0:
            sys.stderr.write(res.stderr)
            return res.returncode
        run = json.loads(res.stdout.strip().splitlines()[-1])
        run["which"] = "this" if tree == ROOT else "other"
        runs.append(run)
        print(json.dumps({k: v for k, v in run.items()
                          if k not in ("ms", "replay_ms", "replay_kernels")}),
              flush=True)
    if args.device == "cuda":
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
        print(smi, flush=True)
    print(json.dumps(dict(runs=runs)))
    return 0


if __name__ == "__main__":
    sys.exit(main())

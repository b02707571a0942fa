"""The port's served decode step beside another checkout's, in one call.

Times the eager decode step of phase 7's path (granite-3-2b at its
published size, bf16, ``attn_impl="kernel"``: B 8 from a 512-token
prompt, greedy), each step on the host's clock ending in a device
synchronize, after ``--warm`` untimed steps:

    python3 tools/decode_ab.py --other DIR            # on a card
    python3 tools/decode_ab.py --other DIR --device cpu --layers 2 --steps 4

``DIR`` holds another checkout (its ``src/repro_torch``).  Each tree runs
in a process of its own, in the order other, this, this, other, so that
a drift of the host's speed shows as a gap between the two runs of one
tree.  The result is one JSON object on the last line: per run the
step times in ms, sorted, their p50, and the ATen calls (all, and the
views among them) that one more step dispatches.
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


def worker(args) -> dict:
    sys.path.insert(0, os.path.join(args.tree, "src"))
    import torch
    from repro_torch.configs.registry import ARCHS
    from repro_torch.models.model import Model
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
    with torch.no_grad():
        last, cache = model.prefill(params, {"tokens": prompt},
                                    args.prompt + n + 1)
        tok = last[:, -1].argmax(-1, keepdim=True)
        for t in range(args.warm + args.steps):
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
    if dev == "cuda":
        out["device"] = torch.cuda.get_device_name(0)
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
        print(json.dumps({k: v for k, v in run.items() if k != "ms"}),
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

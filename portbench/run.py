"""The port's benchmark: one run of one cell.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Loads the cell named in ``BENCHMARK.json`` (its configuration, traffic
mix and driver, found by name under ``portbench/``), sets up and warms
every shape the cell uses, measures for ``--seconds``, checks what the
timed path produced against the plain reference, and prints one JSON
line last: ``correct``, ``attempted``, ``failed``, ``metrics`` (the end-to-end
metrics, or with ``--trace 1`` the per-layer ones), ``device``, with
``--trace 1`` ``breakdown``, ``settle`` (set-up's wait for the card's
slow mode, :mod:`portbench.harness.settle`), and ``checks``, each number
compared beside its limit.  It runs only on a CUDA card, and fails if the JAX package,
JAX or Flax is loaded in its process.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
CACHE = ROOT / ".portbench_cache"


def _environment() -> None:
    """Import paths, and every build and kernel cache inside the checkout
    at a fixed path (the kernels' own ``.so`` cache is the program's,
    ``src/repro_torch/kernels/_build/``, inside the checkout too)."""
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(CACHE / sub)
    os.environ["USE_FLAX"] = "0"


def _power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()
    import torch
    imports_s = time.perf_counter() - T_START

    from portbench.harness import core, registry
    cell = registry.cell(registry.benchmark(), args.workload)
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < cell["chips"]:
        print(f"portbench: {cell['chips']} CUDA card(s) wanted, {cards} "
              "present; no result", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    res = core.run_cell(args.workload, args.seed, args.seconds,
                        bool(args.trace), device="cuda", t_start=T_START)
    obs = res.pop("obs")
    found = core.forbidden_modules()
    if found:
        print(f"portbench: forbidden modules loaded: {found}; no result",
              file=sys.stderr)
        return 3
    device = dict(platform="gpu", kind=torch.cuda.get_device_name(0),
                  count=cell["chips"],
                  memory_peak_bytes=int(obs["memory_peak_bytes"]),
                  power_limit=_power_limit())
    prof = obs.get("profile")
    if args.trace and prof is not None:
        device.update(busy_s=prof["busy_s"], window_s=prof["window_s"])
    checks = res.pop("checks")
    settled = res.pop("settle", None)
    res["device"] = device
    if settled is not None:
        res["settle"] = settled
    res["checks"] = checks
    notes = dict(imports_s=imports_s)
    notes.update({k: obs[k] for k in (
        "setup_s", "inputs_s", "warm_s", "window_s", "missions", "polls",
        "captures", "captures_in_window", "capture_s", "reference_s",
        "mission_s_each", "event_busy_s", "settle") if k in obs})
    if prof is not None:
        notes.update({f"profile_{k}": prof[k] for k in (
            "window_s", "busy_s", "sum_s", "span_s", "gaps_s", "n_device")})
    print(f"portbench: {args.workload} seed {args.seed}: "
          f"{json.dumps(notes)}", file=sys.stderr)
    if obs.get("settle") and not obs["settle"]["settled"]:
        print("portbench: warning: the card was still in its slow mode "
              "when the window opened", file=sys.stderr)
    if obs.get("captures_in_window"):
        print("portbench: warning: graphs were captured inside the measured "
              "window", file=sys.stderr)
    for k, c in checks.items():
        print(f"check {k}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

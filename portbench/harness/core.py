"""One run of one cell: set-up, the measured window, the readings and
the check, as ``run.py`` drives it on the card (and the tests on the
host at a tiny size)."""
from __future__ import annotations

import dataclasses
import gc
import os
import random
import sys
import time

import numpy as np
import torch

from portbench.harness import check, registry, settle

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# the reference's intra-op threads on the host (its answers do not depend
# on the count; the card machine's host runs a 28-edge tick in about
# 21 ms on 8 threads and 27 ms on one)
REFERENCE_THREADS = 8


@dataclasses.dataclass
class Run:
    """What a driver is handed: the cell and its files, the seed, the
    window's seconds, whether this is the traced run, the device, the
    process's start on the host clock, and ``obs``, the observations the
    metric readers read."""

    cell: dict
    config: dict
    mix: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t_start: float
    obs: dict = dataclasses.field(default_factory=dict)
    probe: object = None

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def window_opens(self) -> None:
        """Set-up ends here: every shape is warm.  On the card the window
        then waits until the slow mode a capture can leave has passed
        (:mod:`portbench.harness.settle`), which ``setup_s`` leaves
        out."""
        self.sync()
        self.obs["setup_s"] = time.perf_counter() - self.t_start
        if self.probe is not None:
            self.obs["settle"] = self.probe.wait_fast()


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is the JAX package, JAX or
    Flax (the part before the first dot, compared whole)."""
    return sorted({name for name in list(sys.modules)
                   if name.split(".", 1)[0] in FORBIDDEN})


def seed_everything(seed: int) -> None:
    random.seed(seed)
    np.random.seed(seed % 2**32)
    torch.manual_seed(seed % 2**63)


def measure(cell_name: str, seed: int, seconds: float, trace: bool, *,
            device="cuda", t_start: float | None = None,
            bench: dict | None = None, config: dict | None = None,
            mix: dict | None = None, base=registry.HERE):
    """Set up, warm up and drive the window of one run of ``cell_name``.
    Returns ``(run, driver, sample)``: the sample is what the check
    compares, the program's state already freed.  ``config`` and ``mix``
    replace the files' contents (the tests' tiny sizes); ``base`` is the
    folder the files are found in."""
    t_start = time.perf_counter() if t_start is None else t_start
    bench = registry.benchmark() if bench is None else bench
    cell = registry.cell(bench, cell_name)
    config = registry.config(cell["config"], base) if config is None \
        else config
    mix = registry.traffic(cell["traffic"], base) if mix is None else mix
    run = Run(cell=cell, config=config, mix=mix, seed=int(seed),
              seconds=float(seconds), trace=bool(trace),
              device=torch.device(device), t_start=t_start)
    seed_everything(run.seed)
    drv = registry.driver(mix["driver"], base)
    if run.device.type == "cuda":
        run.probe = settle.Probe(run.device)
        torch.cuda.reset_peak_memory_stats(run.device)
    outcome = drv.drive(run)
    run.sync()
    run.obs["memory_peak_bytes"] = (
        torch.cuda.max_memory_allocated(run.device)
        if run.device.type == "cuda" else 0)
    # the program's state goes before the reference runs
    sample = outcome.pop("sample")
    outcome.clear()
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    return run, drv, sample


def run_cell(cell_name: str, seed: int, seconds: float, trace: bool, *,
             bench: dict | None = None, base=registry.HERE, **kw) -> dict:
    """Run ``cell_name`` once (:func:`measure`, then the check and the
    readers) and return the result line's object without ``device``,
    with ``obs``."""
    bench = registry.benchmark() if bench is None else bench
    run, drv, sample = measure(cell_name, seed, seconds, trace,
                               bench=bench, base=base, **kw)
    torch.set_num_threads(min(REFERENCE_THREADS, os.cpu_count() or 1))
    numbers, attempted, failed = drv.verify(run, sample)
    checks = check.limits(numbers)
    metrics = {}
    for m in registry.metrics_for(bench, cell_name, run.trace):
        value = registry.metric(m["name"], base).read(run.obs)
        if value is not None:
            metrics[m["name"]] = dict(value=float(value), unit=m["unit"])
    result = dict(correct=check.is_correct(checks) and failed == 0,
                  attempted=int(attempted), failed=int(failed),
                  metrics=metrics)
    prof = run.obs.get("profile")
    if run.trace and prof is not None:
        result["breakdown"] = dict(device_ops=prof["device_ops"],
                                   idle_gaps=prof["idle_gaps"])
    if "settle" in run.obs:
        result["settle"] = run.obs["settle"]
    result["checks"] = checks
    result["obs"] = run.obs
    return result

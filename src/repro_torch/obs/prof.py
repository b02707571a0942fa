"""Profiling hooks: ``torch.profiler`` capture and capture accounting.
Port of ``repro.obs.prof``.

Two concerns, both about the tick *program*, not the scheduler:

* :func:`profile_trace` — a context manager around ``torch.profiler``
  that writes a Chrome trace (readable in Perfetto) into a log directory
  (a no-op with a warning where the profiler refuses to start).
* :class:`CompileCounter` / :func:`fleet_compile_stats` — capture
  accounting.  The fleet tick is policy-generic: every policy is runtime
  ``PolicyParams`` data, so one set of statics of
  :func:`repro_torch.sim.fleet._fleet_program` records one shape key per
  input shape, however many policies run through it.  On the card each
  shape key is one CUDA graph, captured once; on the host the keys are
  recorded alike, so the counts are the same on both devices.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import warnings

import torch


@contextlib.contextmanager
def profile_trace(logdir: str):
    """Profile the block with ``torch.profiler`` (host, and the card's
    kernels where there is one) and write ``logdir/trace.json``, a Chrome
    trace that Perfetto (``ui.perfetto.dev``) opens.  Yields ``True``; a
    profiler that refuses to start makes the block run unprofiled, with
    a :class:`RuntimeWarning`, and yields ``False``."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    try:
        prof.__enter__()
    except BaseException as e:  # the backend may raise anything
        warnings.warn(f"torch.profiler unavailable ({e!r}); "
                      "profile_trace is a no-op", RuntimeWarning)
        yield False
        return
    try:
        yield True
    finally:
        prof.__exit__(None, None, None)
        os.makedirs(logdir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class CompileCounter:
    """Count the tick program's graph captures (and their host seconds,
    instantiation included) in a scope.

    >>> with CompileCounter() as cc:
    ...     run_fleet(...)
    >>> cc.count, cc.total_secs

    A replay, and any run on the host, captures nothing.
    """

    def __init__(self) -> None:
        self.count = 0
        self.total_secs = 0.0
        self._start = (0, 0.0)

    def __enter__(self) -> "CompileCounter":
        from repro_torch.sim import fleet
        self._start = tuple(fleet._CAPTURES)
        return self

    def __exit__(self, *exc) -> None:
        from repro_torch.sim import fleet
        self.count = fleet._CAPTURES[0] - self._start[0]
        self.total_secs = fleet._CAPTURES[1] - self._start[1]


@dataclasses.dataclass
class FleetCompileStats:
    """Snapshot of the policy-generic tick program cache."""

    programs: int        # distinct (dt, fracs, tspec, …) programs
    traces: int          # shape keys across all of them
    max_traces_per_program: int
    capacity: int = 0    # bounded program-cache size (LRU eviction past it)
    evictions: int = 0   # programs evicted since the last reset

    @property
    def policy_generic(self) -> bool:
        """True iff no program recorded a second shape key.

        A valid verdict only when every program saw a single input shape
        (e.g. after :func:`reset_fleet_programs`, one workload, many
        policies); shape changes legitimately add keys.  For shape-varied
        runs compare :attr:`traces` deltas instead.
        """
        return self.max_traces_per_program <= 1


def fleet_compile_stats() -> FleetCompileStats:
    """Read the live ``_fleet_program`` cache: programs × shape keys.

    Growth *without* a new input shape means some runtime input (usually
    a policy field) leaked into the statics.
    """
    from repro_torch.sim import fleet

    sizes = [len(p.shape_keys) for p in fleet._PROGRAM_REGISTRY]
    return FleetCompileStats(
        programs=len(sizes), traces=sum(sizes),
        max_traces_per_program=max(sizes, default=0),
        capacity=fleet.FLEET_PROGRAM_CACHE_CAPACITY,
        evictions=fleet._PROGRAM_EVICTIONS)


def reset_fleet_programs() -> None:
    """Drop every cached tick program and its graphs (test isolation)."""
    from repro_torch.sim import fleet

    fleet._fleet_program.cache_clear()
    fleet._PROGRAM_REGISTRY.clear()
    fleet._PROGRAM_EVICTIONS = 0

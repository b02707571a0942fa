"""Profiling hooks: the span and counter table, ``torch.profiler``
capture and capture accounting.  Port of ``repro.obs.prof``, which has
no spans.

Three concerns, all about the *program*, not the scheduler:

* :func:`span` / :func:`count` — the process's span and counter table.
  A span is a timed phase of the program (name, span id, parent span id,
  request id, start and end on ``time.perf_counter_ns``); the controller
  (``ctl.*``), the tick program (``fleet.*``) and the captured programs
  (``graph.*``) open them at their layer boundaries.  Parents are tracked
  per thread.  A span opened with no open parent starts a request, whose
  id is its own span id, and every span under it carries that id (one
  ``FleetController.poll``, one ``run_fleet``).  Readers:
  :func:`span_table` (per name: count, total, median, p95, max; the
  medians over a ring of the latest :data:`RING` durations, the counts
  and totals over every span), :func:`span_records` (the latest
  :data:`RECORDS` whole spans, enough for a traced run's tree) and
  :func:`counters`.  The table is on by default; :func:`tracing`
  ``(False)`` stops spans from being recorded (their timestamps are still
  taken: the controller's step latency is its ``ctl.step`` span), while
  counters always count, since launch accounting
  (:func:`repro_torch.kernels.sched_ops.launch_counts`) rests on them.
  While a ``torch.profiler`` runs, each span is also a
  ``record_function`` range of its name, so :func:`profile_trace`'s trace
  carries the program's phases; :func:`to_profiler_ns` puts a span's
  times on the clock of the profiler's records.
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
import itertools
import os
import threading
import time
import warnings
from collections import deque
from time import perf_counter_ns
from typing import NamedTuple, Optional

import numpy as np
import torch

# the latest durations a name keeps for its median and p95, and the
# latest whole span records the table keeps
RING = 4096
RECORDS = 65536

_autograd_profiler = torch.autograd.profiler
# (perf_counter_ns, time_ns) taken together: the profiler's records carry
# Unix-epoch nanoseconds, and the two clocks keep a fixed offset
_ANCHOR = (perf_counter_ns(), time.time_ns())


class SpanRecord(NamedTuple):
    """One finished span; ``parent`` is 0 for a request's first span."""
    name: str
    id: int
    parent: int
    request: int
    start_ns: int
    end_ns: int


class _Local(threading.local):
    top: Optional["span"] = None


class _Table:
    def __init__(self) -> None:
        self.on = True
        self.lock = threading.Lock()
        self.rows: dict = {}         # name -> [count, total_ns, max_ns, ring]
        self.records: deque = deque(maxlen=RECORDS)
        self.counters: dict = {}
        self.ids = itertools.count(1)
        self.local = _Local()


_TABLE = _Table()


class span:
    """``with span(name):`` times the block as one span of the table (see
    the module docstring); ``start_ns``, ``end_ns`` and :attr:`seconds`
    are readable after the block, also with the table off."""

    __slots__ = ("name", "id", "parent", "request", "start_ns", "end_ns",
                 "_rf")

    def __init__(self, name: str) -> None:
        self.name = name
        self.id = 0
        self._rf = None

    def __enter__(self) -> "span":
        t = _TABLE
        if t.on:
            self.id = next(t.ids)
            self.parent = parent = t.local.top
            self.request = parent.request if parent is not None else self.id
            t.local.top = self
            if _autograd_profiler._is_profiler_enabled:
                self._rf = torch.profiler.record_function(self.name)
                self._rf.__enter__()
        self.start_ns = perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        self.end_ns = end = perf_counter_ns()
        if not self.id:
            return
        t = _TABLE
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
            self._rf = None
        parent = self.parent
        t.local.top = parent
        d = end - self.start_ns
        t.records.append((self.name, self.id,
                          parent.id if parent is not None else 0,
                          self.request, self.start_ns, end))
        with t.lock:
            row = t.rows.get(self.name)
            if row is None:
                row = t.rows[self.name] = [0, 0, 0, deque(maxlen=RING)]
            row[0] += 1
            row[1] += d
            if d > row[2]:
                row[2] = d
            row[3].append(d)

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` (counted with the table off too)."""
    t = _TABLE
    with t.lock:
        t.counters[name] = t.counters.get(name, 0) + n


def counters() -> dict:
    """A copy of every counter: name -> count."""
    with _TABLE.lock:
        return dict(_TABLE.counters)


def tracing(on: bool) -> bool:
    """Turn span recording on or off for the process; returns the setting
    it replaces.  Off, a span records nothing and opens no profiler
    range, so :class:`CompileCounter`, which reads spans, counts
    nothing."""
    was, _TABLE.on = _TABLE.on, bool(on)
    return was


def span_table(*names: str) -> dict:
    """Per span name (those given, or all): ``count``, ``total_s`` and
    ``max_s`` over every span recorded, ``median_s`` and ``p95_s`` over
    the latest :data:`RING` durations."""
    with _TABLE.lock:
        rows = {k: (r[0], r[1], r[2], list(r[3]))
                for k, r in _TABLE.rows.items() if not names or k in names}
    out = {}
    for k, (n, total, mx, ring) in rows.items():
        med, p95 = np.percentile(np.asarray(ring, np.float64), (50, 95))
        out[k] = dict(count=n, total_s=total / 1e9,
                      median_s=float(med) / 1e9, p95_s=float(p95) / 1e9,
                      max_s=mx / 1e9)
    return out


def span_records() -> list:
    """The latest :data:`RECORDS` finished spans, oldest first."""
    return [SpanRecord(*r) for r in list(_TABLE.records)]


def to_profiler_ns(t_ns: int) -> int:
    """A ``perf_counter_ns`` time (a span's start or end) on the clock of
    ``torch.profiler``'s records (Unix-epoch nanoseconds)."""
    return t_ns - _ANCHOR[0] + _ANCHOR[1]


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
    instantiation included) in a scope: the ``fleet.capture`` spans, and
    the ``fleet.capture`` and ``fleet.instantiate`` totals (none while
    :func:`tracing` is off).

    >>> with CompileCounter() as cc:
    ...     run_fleet(...)
    >>> cc.count, cc.total_secs

    A replay, and any run on the host, captures nothing.
    """

    NAMES = ("fleet.capture", "fleet.instantiate")

    def __init__(self) -> None:
        self.count = 0
        self.total_secs = 0.0
        self._start = (0, 0.0)

    def _read(self) -> tuple:
        rows = span_table(*self.NAMES)
        cap = rows.get(self.NAMES[0], {})
        return (cap.get("count", 0),
                sum(r["total_s"] for r in rows.values()))

    def __enter__(self) -> "CompileCounter":
        self._start = self._read()
        return self

    def __exit__(self, *exc) -> None:
        n, secs = self._read()
        self.count = n - self._start[0]
        self.total_secs = secs - self._start[1]


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

"""A short profiled sub-window and what the per-layer metrics read of it.

``torch.profiler`` traces the card's operations (kernels, copies and
memsets: every record on the device) and the benchmark's own host spans,
opened with :func:`span` around the calls into the program (``submit``,
``poll``, ``step_chunk``, ``mission_restart``).  From the trace:

* the union of the device intervals (busy seconds) and the traced
  window's host-clock length;
* the device operations that took most time, summed by name;
* the longest idle gaps, each labelled by the benchmark span open at its
  midpoint (``host`` where none was) and the innermost host record open
  there (an ATen operation or a CUDA runtime call), as ``span/record``;
* the durations of the records whose name holds a given kernel name.
"""
from __future__ import annotations

import contextlib
import time

import torch

SPANS = ("submit", "poll", "step_chunk", "mission_restart")
TOP = 10


@contextlib.contextmanager
def span(name: str):
    """A benchmark host span; a ``record_function`` range when traced."""
    with torch.profiler.record_function(name):
        yield


def _raw_events(pr) -> list:
    """``(name, on_device, start_us, end_us)`` of every record.  A span's
    annotation on the device's timeline is not a device operation: it is
    kept as a host record."""
    cuda = torch.autograd.DeviceType.CUDA
    try:
        evs = pr.profiler.kineto_results.events()
        return [(e.name(), e.device_type() == cuda
                 and not e.is_user_annotation() and e.name() not in SPANS,
                 e.start_ns() / 1e3, e.end_ns() / 1e3) for e in evs]
    except AttributeError:
        return [(e.name, e.device_type == cuda and e.name not in SPANS,
                 e.time_range.start, e.time_range.end) for e in pr.events()]


def run_profiled(fn) -> dict:
    """Run ``fn`` under the profiler between two synchronisations and
    read the trace (see :func:`read`)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as pr:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    return read(_raw_events(pr), window_s)


def read(events: list, window_s: float) -> dict:
    """What the readers need of a trace's ``(name, on_device, start_us,
    end_us)`` records and the window's host-clock seconds."""
    dev = sorted((s, e, n) for n, d, s, e in events if d and e > s)
    spans = sorted((s, e, n) for n, d, s, e in events
                   if not d and n in SPANS)
    host = sorted((s, e, n) for n, d, s, e in events
                  if not d and n not in SPANS)
    merged = []
    for s, e, _ in dev:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    busy_us = sum(e - s for s, e in merged)
    gaps = [(merged[i + 1][0] - merged[i][1], merged[i][1],
             merged[i + 1][0]) for i in range(len(merged) - 1)]
    gaps.sort(reverse=True)

    def label(lo, hi):
        mid = (lo + hi) / 2
        # the innermost span and host record open at the midpoint
        outer = [(s, n) for s, e, n in spans if s <= mid <= e]
        inner = [(s, n) for s, e, n in host if s <= mid <= e]
        return (max(outer)[1] if outer else "host") + \
            ("/" + max(inner)[1] if inner else "")

    by_name: dict = {}
    for s, e, n in dev:
        by_name[n] = by_name.get(n, 0.0) + (e - s) / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return dict(
        window_s=window_s, busy_s=busy_us / 1e6, n_device=len(dev),
        sum_s=sum(e - s for s, e, _ in dev) / 1e6,
        span_s=(max(e for _, e, _ in dev) - dev[0][0]) / 1e6 if dev else 0.0,
        gaps_s=sum(g for g, _, _ in gaps) / 1e6,
        device_ops=[[n, v] for n, v in top],
        idle_gaps=[[label(lo, hi), g / 1e6] for g, lo, hi in gaps[:TOP]],
        durations_us=lambda name: [e - s for s, e, n in dev if name in n])

"""Probes around the calls into the program, from the benchmark's side.

* :class:`ArgextShapes` logs the ``(rows, entries)`` of every call of
  the selection kernel's launcher while it is open.  Open during a
  graph's capture it logs exactly the calls the graph replays (a
  replay launches nothing through the launcher).
* :class:`StepEvents` wraps a ``FleetProgram`` and records a pair of CUDA
  events around each ``step_chunk`` (for a controller, whose program is
  an attribute it calls).
"""
from __future__ import annotations

import torch


class ArgextShapes:
    def __init__(self, sched_ops):
        self.mod = sched_ops
        self.shapes: list = []
        self._orig = None

    def __enter__(self):
        self._orig = orig = getattr(self.mod, "cuda_masked_argext", None)
        if orig is None:
            return self

        def logged(scores, mask, **kw):
            self.shapes.append(tuple(scores.shape))
            return orig(scores, mask, **kw)

        self.mod.cuda_masked_argext = logged
        return self

    def __exit__(self, *exc):
        if self._orig is not None:
            self.mod.cuda_masked_argext = self._orig


class StepEvents:
    """A stand-in for a ``FleetProgram`` that times each ``step_chunk``
    by CUDA events; every other attribute is the program's."""

    def __init__(self, prog):
        self._prog = prog
        self.pairs: list = []        # (start event, end event, ticks)

    def __getattr__(self, name):
        return getattr(self._prog, name)

    def step_chunk(self, prof, pp, state, signals, **kw):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = self._prog.step_chunk(prof, pp, state, signals, **kw)
        b.record()
        self.pairs.append((a, b, int(signals.times.shape[-1])))
        return out


def per_tick_ms(pairs: list) -> list:
    """Each event pair's span over its ticks, in ms (after a sync)."""
    return [a.elapsed_time(b) / n for a, b, n in pairs if n]


def busy_s(pairs: list) -> float:
    """The event pairs' spans summed, in seconds (after a sync): the
    device time of the calls they bracket, which follow one another on
    one stream."""
    return sum(a.elapsed_time(b) for a, b, _ in pairs) / 1e3

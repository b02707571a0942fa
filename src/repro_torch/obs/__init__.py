"""Observability of the port: the flight recorder and its host metrics.

* :mod:`repro_torch.obs.trace` — the decision-trace schema
  (:class:`TraceSpec`, :class:`TickCounters`) tapped out of the fleet
  tick by :mod:`repro_torch.sim.fleet`;
* :mod:`repro_torch.obs.metrics` — host-side aggregation: QoS/QoE time
  series, per-task-type success frequencies (the paper's QoE metric),
  p50/p95/p99 deadline-slack and completion-latency percentiles, the
  per-tick conservation ledger, and JSON/CSV/Perfetto export;
* :mod:`repro_torch.obs.prof` — the program's span and counter table
  (``ctl.*``, ``fleet.*``, ``graph.*`` spans; launch and replay
  counters), one table for the whole process, on by default and turned
  off by ``prof.tracing(False)`` (counters keep counting); its
  ``profile_trace`` writes a Perfetto trace that now carries the
  program's spans as ranges; capture accounting (``CompileCounter``).
"""
from repro_torch.obs.trace import (EVENT_FIELDS, TickCounters, TraceSpec,
                                   hist_counts, resolve_spec, zero_counters)

__all__ = [
    "EVENT_FIELDS", "TickCounters", "TraceSpec", "hist_counts",
    "resolve_spec", "zero_counters",
]

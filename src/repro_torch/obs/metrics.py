"""Host-side aggregation of flight-recorder traces (a copy of
``repro.obs.metrics``).

Everything here consumes the :class:`TickCounters` stream of the port's
fleet tick (:mod:`repro_torch.sim.fleet` with
``trace=TraceSpec(counters=True)``) as plain NumPy in the ``[T, E, …]``
layout — the shape :func:`~repro_torch.sim.fleet.run_fleet` returns and
the shape :func:`~repro_torch.scenarios.runner.run_registry_sweep`
re-stacks each row's ``"trace"`` into.  Leaves may be tensors on any
device; each is copied to the host once.  For ``[R, T, E, …]`` batch
streams, pick a replica first with :func:`select_replica`.

The three product surfaces:

* :func:`time_series` — fleet-summed per-tick QoS/QoE and decision
  series;
* :func:`tail_metrics` — per-task-type success frequencies (QoE),
  deadline-hit rate, the windowed p95/p99 deadline-hit tail
  (:func:`deadline_hit_tail`), and p50/p95/p99 deadline-slack /
  completion-latency percentiles read out of the histograms
  (:func:`hist_percentiles`);
* :func:`conservation_ledger` / :func:`check_conservation` — the
  per-tick accounting identity ``arrived = settled + in-flight``
  (fleet-summed: peer offload moves tasks *between* edges).

Exports: :func:`to_json`, :func:`to_csv` (one row per tick) and
:func:`to_perfetto` (Chrome/Perfetto trace-event counter stream).
"""
from __future__ import annotations

import csv
import io
import json
from typing import Mapping, Sequence

import numpy as np
import torch

from repro_torch.obs.trace import TickCounters, TraceSpec

PERCENTILES = (50.0, 95.0, 99.0)


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _np(counters: TickCounters) -> TickCounters:
    return TickCounters(*(_host(x) for x in counters))


def select_replica(counters: TickCounters, r: int) -> TickCounters:
    """Slice one replica out of a batch-path ``[R, T, E, …]`` stream."""
    return TickCounters(*(_host(x)[r] for x in counters))


def bin_edges(spec: TraceSpec) -> np.ndarray:
    """The ``hist_bins + 1`` bucket boundaries in ms (last = +inf)."""
    w = spec.hist_max_ms / spec.hist_bins
    edges = np.arange(spec.hist_bins + 1, dtype=np.float64) * w
    edges[-1] = np.inf
    return edges


def hist_percentiles(hist: np.ndarray, spec: TraceSpec,
                     qs: Sequence[float] = PERCENTILES) -> dict[str, float]:
    """Percentiles from a fixed-bin histogram, interpolated within bins.

    ``hist`` is any ``[…, B]`` stack of per-tick histograms; all leading
    axes are summed first.  Counts are exact; values are linear
    interpolations inside the hit bucket, so the error is bounded by one
    bin width (the last bucket also absorbs overflow, so values cap at
    ``hist_max_ms``).  Empty histograms give ``nan``.
    """
    h = _host(hist).astype(np.float64)
    h = h.reshape(-1, h.shape[-1]).sum(0)
    total = h.sum()
    out: dict[str, float] = {}
    if total == 0:
        return {f"p{q:g}": float("nan") for q in qs}
    cum = np.cumsum(h)
    w = spec.hist_max_ms / spec.hist_bins
    for q in qs:
        target = q / 100.0 * total
        k = int(np.searchsorted(cum, target, side="left"))
        k = min(k, len(h) - 1)
        below = cum[k] - h[k]
        frac = (target - below) / h[k] if h[k] else 0.0
        out[f"p{q:g}"] = (k + frac) * w
    return out


def time_series(counters: TickCounters) -> dict[str, np.ndarray]:
    """Fleet-summed per-tick series (length T) from a ``[T, E, …]`` stream.

    Per-model leaves and histograms are summed over their trailing axis
    too, so every value is a scalar per tick; ``valid`` becomes the
    count of live edges that tick.
    """
    c = _np(counters)
    out: dict[str, np.ndarray] = {}
    for name, leaf in c._asdict().items():
        a = np.asarray(leaf)
        reduced = a.reshape(a.shape[0], -1).sum(1)
        out[name] = reduced.astype(np.int64) if a.dtype != np.float32 \
            else reduced.astype(np.float64)
    out["settled"] = out["hit"] + out["miss"] + out["drop"]
    out["in_flight"] = out["eq_depth"] + out["cq_depth"]
    return out


def conservation_ledger(counters: TickCounters) -> dict[str, np.ndarray]:
    """Cumulative ledger: ``arrived = settled + in_flight`` per tick.

    Fleet-summed — peer offload moves a task between edges without
    settling it, so the identity holds fleet-wide (and per edge only in
    non-cooperative runs).  ``residual`` should be identically zero.
    """
    ts = time_series(counters)
    arrived = np.cumsum(ts["arrivals"])
    settled = np.cumsum(ts["settled"])
    in_flight = ts["in_flight"]
    return dict(arrived=arrived, settled=settled, in_flight=in_flight,
                residual=arrived - settled - in_flight)


def check_conservation(counters: TickCounters) -> None:
    """Raise ``AssertionError`` with the first offending tick on leak."""
    resid = conservation_ledger(counters)["residual"]
    bad = np.nonzero(resid)[0]
    if bad.size:
        t = int(bad[0])
        raise AssertionError(
            f"task conservation violated from tick {t}: residual "
            f"{int(resid[t])} (arrived != settled + in-flight)")


def deadline_hit_tail(counters: TickCounters, *,
                      window_ms: float = 1_000.0,
                      dt_ms: float = 25.0) -> dict[str, float]:
    """Tail-QoS scoreboard: windowed deadline-hit rate percentiles.

    The per-tick fleet-summed hit/miss/drop series is aggregated into
    ``window_ms`` buckets; each bucket's hit rate ``hit / settled`` is
    one observation, and the *lower* tail of that distribution is the
    service-level number a fleet operator cares about — "in the worst
    1 % of seconds, what fraction of frames still met their deadline?".
    Reported as ``mean`` plus ``p95``/``p99`` (the 5th/1st percentile of
    per-window hit rates, i.e. the rate the fleet beats 95 %/99 % of the
    time).  Windows where nothing settled are skipped; an all-idle run
    gives ``nan``.
    """
    ts = time_series(counters)
    per = max(int(round(window_ms / dt_ms)), 1)
    n = len(ts["hit"])
    rates = []
    for s in range(0, n, per):
        hit = float(ts["hit"][s:s + per].sum())
        settled = float(ts["settled"][s:s + per].sum())
        if settled > 0:
            rates.append(hit / settled)
    if not rates:
        nan = float("nan")
        return dict(mean=nan, p95=nan, p99=nan, windows=0)
    r = np.asarray(rates, dtype=np.float64)
    return dict(mean=float(r.mean()),
                p95=float(np.percentile(r, 5.0)),
                p99=float(np.percentile(r, 1.0)),
                windows=int(r.size))


def qoe_frequencies(counters: TickCounters,
                    model_names: Sequence[str] | None = None
                    ) -> dict[str, float]:
    """Per-task-type success frequency hit/(hit+miss+drop) — the QoE metric.

    Padded model lanes (batch sweeps pad M to the registry maximum)
    never settle a task and are omitted.
    """
    c = _np(counters)
    hit = c.hit.reshape(-1, c.hit.shape[-1]).sum(0)
    settled = hit + c.miss.reshape(-1, c.miss.shape[-1]).sum(0) \
        + c.drop.reshape(-1, c.drop.shape[-1]).sum(0)
    out = {}
    for m in range(hit.shape[0]):
        if settled[m] == 0:
            continue
        name = model_names[m] if model_names and m < len(model_names) \
            else f"model{m}"
        out[name] = float(hit[m] / settled[m])
    return out


def tail_metrics(counters: TickCounters, spec: TraceSpec,
                 model_names: Sequence[str] | None = None) -> dict:
    """The distributional scoreboard for one traced run.

    Returns deadline-hit/miss/drop totals and rate, the windowed
    tail-QoS scoreboard (:func:`deadline_hit_tail`), per-task-type QoE
    success frequencies, and p50/p95/p99 deadline-slack and
    completion-latency percentiles (successful tasks; ms, bin-width
    resolution).
    """
    c = _np(counters)
    hit = int(c.hit.sum())
    miss = int(c.miss.sum())
    drop = int(c.drop.sum())
    settled = max(hit + miss + drop, 1)
    return dict(
        hit=hit, miss=miss, drop=drop,
        hit_rate=hit / settled,
        deadline_hit=deadline_hit_tail(counters),
        qoe_frequency=qoe_frequencies(counters, model_names),
        slack_ms=hist_percentiles(c.slack_hist, spec),
        latency_ms=hist_percentiles(c.latency_hist, spec),
        drops_by_cause=dict(
            infeasible=int(c.drop_infeasible.sum()),
            unstolen=int(c.drop_unstolen.sum()),
            queue_full=int(c.drop_qfull.sum()),
            crash=int(c.drop_crash.sum()),
            timeout=int(c.drop_timeout.sum())),
        qos_utility=float(c.qos.sum()),
        qoe_utility=float(c.qoe.sum()))


def to_json(counters: TickCounters, spec: TraceSpec,
            model_names: Sequence[str] | None = None, *,
            indent: int | None = None) -> str:
    """Full dump: tail metrics + ledger + per-tick series as JSON."""
    ts = {k: v.tolist() for k, v in time_series(counters).items()}
    ledger = {k: v.tolist()
              for k, v in conservation_ledger(counters).items()}
    doc = dict(spec=dict(hist_bins=spec.hist_bins,
                         hist_max_ms=spec.hist_max_ms),
               tail=tail_metrics(counters, spec, model_names),
               ledger=ledger, series=ts)
    return json.dumps(doc, indent=indent)


def to_csv(counters: TickCounters) -> str:
    """One row per tick of the fleet-summed series (spreadsheet food)."""
    ts = time_series(counters)
    cols = list(ts)
    buf = io.StringIO()
    w = csv.writer(buf)
    w.writerow(["tick", *cols])
    for t in range(len(ts["arrivals"])):
        w.writerow([t, *(ts[c][t] for c in cols)])
    return buf.getvalue()


def to_perfetto(counters: TickCounters, *, dt_ms: float = 25.0,
                stride: int = 1,
                process_name: str = "fleet") -> str:
    """Chrome/Perfetto trace-event JSON: one counter track per series.

    Every fleet-summed series becomes a phase-``"C"`` counter event at
    its tick's timestamp (µs).  ``stride`` downsamples long runs; load
    the result in ``ui.perfetto.dev`` or ``chrome://tracing``.
    """
    ts = time_series(counters)
    events: list[dict] = [dict(
        name="process_name", ph="M", pid=1,
        args=dict(name=process_name))]
    tracks = {
        "queues": ("eq_depth", "cq_depth", "slots_busy"),
        "outcomes": ("hit", "miss", "drop"),
        "routing": ("arrivals", "admit_edge", "admit_cloud",
                    "cloud_dispatch", "pool_blocked"),
        "rebalance": ("migrated", "gems_moved", "stolen",
                      "peer_out", "peer_in"),
        "utility": ("qos", "qoe"),
    }
    n = len(ts["arrivals"])
    for t in range(0, n, max(stride, 1)):
        us = t * dt_ms * 1_000.0
        for track, fields in tracks.items():
            events.append(dict(
                name=track, ph="C", pid=1, ts=us,
                args={f: float(ts[f][t]) for f in fields}))
    return json.dumps(dict(traceEvents=events,
                           displayTimeUnit="ms"))


def summarize_rows(rows: Sequence[Mapping], spec: TraceSpec) -> list[dict]:
    """Tail metrics for each traced :func:`run_registry_sweep` row."""
    out = []
    for row in rows:
        tr = row.get("trace")
        if tr is None or tr.counters is None:
            continue
        out.append(dict(scenario=row["scenario"], policy=row["policy"],
                        seed=row["seed"],
                        **tail_metrics(tr.counters, spec)))
    return out


# TickCounters leaves with a trailing model axis, and the histograms
PER_MODEL_FIELDS = ("hit", "miss", "drop", "stolen")
HIST_FIELDS = ("slack_hist", "latency_hist")


def stream_sums(counters: TickCounters) -> dict[str, float]:
    """The sum of each ``TickCounters`` stream over all its cells (ints
    exactly; the f32 utility streams summed in float64)."""
    c = _np(counters)
    return {name: (float(a.sum(dtype=np.float64)) if a.dtype == np.float32
                   else int(a.sum(dtype=np.int64)))
            for name, a in c._asdict().items()}


def stream_digests(counters: TickCounters, n_edges: int | None = None,
                   n_models: int | None = None) -> dict[str, str]:
    """SHA-256 of each integer and boolean ``[T, E, …]`` stream but the
    histograms (dtype, shape and bytes), its edge axis cut to
    ``n_edges`` and its model axis to ``n_models`` first, so that a row
    of a padded batch digests as the same run's exact-shape row does."""
    import hashlib

    out = {}
    for name, a in _np(counters)._asdict().items():
        if a.dtype == np.float32 or name in HIST_FIELDS:
            continue
        a = a[:, :n_edges]
        if name in PER_MODEL_FIELDS:
            a = a[..., :n_models]
        a = np.ascontiguousarray(a)
        h = hashlib.sha256(f"{a.dtype.str}{a.shape}".encode())
        h.update(a.tobytes())
        out[name] = h.hexdigest()
    return out

"""Regenerate the PyTorch port's golden traced sweep from the JAX
reference, on the CPU.

    PYTHONPATH=src python tests/golden/regen_torch_port_sweep.py
    PYTHONPATH=src python tests/golden/regen_torch_port_sweep.py --check

``chip_smoke.py`` phase 20 drives the same work through the port on the
card and holds it to this file, which it reads without importing the JAX
package:

* ``rows`` — ``run_registry_sweep`` over all 14 registry scenarios (each
  at its registry width, the horizon cut to ``duration_ms``) × the
  ``policies`` × seed 0, traced with ``TraceSpec.full()``: each row's
  ``fleet_summary``, its ``tail_metrics``, the sum of every counter
  stream (``repro_torch.obs.metrics.stream_sums``) and the SHA-256 of
  every integer stream but the histograms (``stream_digests``, cut to
  the run's own edges and models);
* ``seed_batch`` — ``run_fleet_batch`` of the paper's §8.6 fleet (28
  edges × 3 drones, Table-1 ACTIVE models) over ``seeds``, DEMS-COOP,
  traced, at the same horizon: the same numbers for every lane.

A row's ``exact_hist`` is False where its signals scale a duration by a
factor other than 1.0 (``exec_jit`` or ``load_mult``): there XLA's fused
multiply-add may move a slack or latency to the adjacent bin, so the
histogram percentiles are held to one bin width there.
``tests/test_torch_batch.py`` holds a subset of the rows on the CPU.
``--check`` recomputes everything and fails (exit 1) if it differs,
without rewriting the file.
"""
import json
import math
import pathlib
import sys

PATH = pathlib.Path(__file__).parent / "torch_port_sweep.json"
COMMON = dict(dt=25.0, duration_ms=10_000.0,
              policies=["DEMS", "GEMS-A", "DEMS-COOP", "SJF-E+C"],
              seeds=[0], hist_bins=32, hist_max_ms=4_000.0)
SEED_BATCH = dict(models="ACTIVE", policy="DEMS-COOP", n_edges=28,
                  drones_per_edge=3, seeds=[0, 1, 2, 3], cloud_slots=16,
                  edge_frac=0.62, cloud_frac=0.80)


def _finite(x):
    """JSON-safe floats: NaN (an empty histogram) becomes None."""
    if isinstance(x, dict):
        return {k: _finite(v) for k, v in x.items()}
    if isinstance(x, float) and math.isnan(x):
        return None
    return x


def trace_entry(counters, spec, n_edges: int, n_models: int) -> dict:
    """What a golden holds of one traced run (JAX counters as numpy)."""
    from repro.obs.metrics import tail_metrics
    from repro_torch.obs.metrics import stream_digests, stream_sums
    return dict(tail=_finite(tail_metrics(counters, spec)),
                sums=stream_sums(counters),
                digests=stream_digests(counters, n_edges, n_models))


def _rows() -> list:
    import numpy as np

    from repro.obs.trace import TraceSpec
    from repro.scenarios import get, names, run_registry_sweep
    from repro.scenarios.compile import compile_fleet
    spec = TraceSpec.full(hist_bins=COMMON["hist_bins"],
                          hist_max_ms=COMMON["hist_max_ms"])
    rows = run_registry_sweep(None, tuple(COMMON["policies"]),
                              tuple(COMMON["seeds"]), dt=COMMON["dt"],
                              duration_ms=COMMON["duration_ms"], trace=spec)
    exact = {}
    for name in names():
        sig = compile_fleet(get(name, duration_ms=COMMON["duration_ms"]),
                            COMMON["dt"])
        exact[name] = bool(np.all(np.asarray(sig.exec_jit) == 1.0)
                           and np.all(np.asarray(sig.load_mult) == 1.0))
    out = []
    for row in rows:
        sc = get(row["scenario"])
        out.append(dict(
            scenario=row["scenario"], policy=row["policy"],
            seed=row["seed"], n_edges=sc.n_edges,
            n_models=len(sc.model_names), exact_hist=exact[row["scenario"]],
            summary={k: v for k, v in row.items()
                     if k not in ("scenario", "policy", "seed", "trace")},
            **trace_entry(row["trace"].counters, spec, sc.n_edges,
                          len(sc.model_names))))
        print(row["scenario"], row["policy"], out[-1]["summary"], flush=True)
    return out


def _seed_batch() -> dict:
    import jax

    from repro.core.task import ACTIVE, TABLE1
    from repro.obs.metrics import select_replica
    from repro.obs.trace import TraceSpec
    from repro.scenarios.runner import fleet_summary_batch
    from repro.sim.fleet_jax import (default_signals, run_fleet_batch,
                                     stack_signals)
    b = SEED_BATCH
    models = [TABLE1[n] for n in ACTIVE]
    spec = TraceSpec.full(hist_bins=COMMON["hist_bins"],
                          hist_max_ms=COMMON["hist_max_ms"])
    sig = stack_signals([default_signals(
        len(models), n_edges=b["n_edges"],
        drones_per_edge=b["drones_per_edge"],
        duration_ms=COMMON["duration_ms"], dt=COMMON["dt"], seed=s)
        for s in b["seeds"]])
    res = jax.device_get(run_fleet_batch(
        models, b["policy"], sig, dt=COMMON["dt"],
        edge_frac=b["edge_frac"], cloud_frac=b["cloud_frac"],
        cloud_slots=b["cloud_slots"], trace=spec))
    lanes = []
    for r, summ in enumerate(fleet_summary_batch(res.final)):
        lanes.append(dict(seed=b["seeds"][r], summary=summ, **trace_entry(
            select_replica(res.counters, r), spec, b["n_edges"],
            len(models))))
        print("seed batch lane", r, summ, flush=True)
    return dict(b, lanes=lanes)


def _compute() -> dict:
    return dict(COMMON, rows=_rows(), seed_batch=_seed_batch())


def main() -> None:
    fresh = json.loads(json.dumps(_compute()))
    if "--check" in sys.argv[1:]:
        golden = json.loads(PATH.read_text())
        if golden != fresh:
            print("golden file is stale — rerun without --check and commit")
            sys.exit(1)
        print("golden file is fresh:", PATH)
        return
    PATH.write_text(json.dumps(fresh, indent=1, sort_keys=True) + "\n")
    print("wrote", PATH)


if __name__ == "__main__":
    main()

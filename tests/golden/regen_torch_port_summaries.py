"""Regenerate the PyTorch port's golden fleet summaries from the JAX
reference.

    PYTHONPATH=src python tests/golden/regen_torch_port_summaries.py
    PYTHONPATH=src python tests/golden/regen_torch_port_summaries.py --check

Every run here is one that ``chip_smoke.py`` drives through the port on
the card: the small 2-edge runs (phase 3: DEMS-A, GEMS, DEMS-COOP and
SOTA2) and the paper-scale 28-edge fleet of §8.6 (phase 4).  The file carries each run's definition beside
its JAX ``fleet_summary``, so ``chip_smoke.py`` reads the workloads and
their expected numbers from it and never imports the JAX package;
``tests/test_torch_golden.py`` re-runs the small entries through JAX and
the CPU port so the file cannot rot.  ``--check`` recomputes every entry
and fails (exit 1) if any summary differs, without rewriting the file.
"""
import json
import pathlib
import sys

PATH = pathlib.Path(__file__).parent / "torch_port_summaries.json"
COMMON = dict(dt=25.0, seed=0, drones_per_edge=3, edge_frac=0.62,
              cloud_frac=0.80, cloud_slots=16)
# θ that moves inside a 30 s run, and the paper's §8.5 trapezium (rise
# over 60-90 s, fall over 210-240 s of 300 s) compressed 10× into 30 s:
# the eager port is launch-bound on the card (PERF.md), so a 300 s run
# alone would take most of chip_smoke.py's time limit, and three 60 s
# runs took a third of it
MOVING = dict(ramp_up=[5_000.0, 10_000.0], ramp_down=[20_000.0, 25_000.0])
PAPER = dict(ramp_up=[6_000.0, 9_000.0], ramp_down=[21_000.0, 24_000.0])
RUNS = [
    dict(name="small-dems-a", phase=3, policy="DEMS-A", models="PASSIVE",
         n_edges=2, duration_ms=30_000.0, theta=MOVING),
    dict(name="small-gems", phase=3, policy="GEMS", models="WL1@0.9",
         n_edges=2, duration_ms=30_000.0, theta=MOVING),
    dict(name="small-dems-coop", phase=3, policy="DEMS-COOP",
         models="ACTIVE", n_edges=2, duration_ms=30_000.0, theta=MOVING),
    # SOTA2 (Dedas): the only policy whose decisions read act_improves'
    # mean-completion comparison
    dict(name="small-sota2", phase=3, policy="SOTA2", models="PASSIVE",
         n_edges=2, duration_ms=30_000.0, theta=MOVING),
    dict(name="paper-dems-a", phase=4, policy="DEMS-A", models="PASSIVE",
         n_edges=28, duration_ms=30_000.0, theta=PAPER),
    dict(name="paper-gems", phase=4, policy="GEMS", models="WL1@0.9",
         n_edges=28, duration_ms=30_000.0, theta=None),
    dict(name="paper-dems-coop", phase=4, policy="DEMS-COOP",
         models="ACTIVE", n_edges=28, duration_ms=30_000.0, theta=None),
]


def models_of(spec: str):
    """``PASSIVE`` / ``ACTIVE`` Table-1 sets or ``WLn@alpha`` (Table 2)."""
    from repro.core.task import ACTIVE, PASSIVE, TABLE1, table2
    if spec in ("PASSIVE", "ACTIVE"):
        names = PASSIVE if spec == "PASSIVE" else ACTIVE
        return [TABLE1[n] for n in names]
    wl, alpha = spec.split("@")
    return table2(wl, float(alpha))


def jax_summary(run: dict) -> dict:
    from repro.scenarios.runner import fleet_summary
    from repro.sim.fleet_jax import simulate_fleet
    from repro.sim.network import trapezium
    th = run["theta"]
    final = simulate_fleet(
        models_of(run["models"]), run["policy"], n_edges=run["n_edges"],
        drones_per_edge=COMMON["drones_per_edge"],
        duration_ms=run["duration_ms"], dt=COMMON["dt"],
        edge_frac=COMMON["edge_frac"], cloud_frac=COMMON["cloud_frac"],
        cloud_slots=COMMON["cloud_slots"], seed=COMMON["seed"],
        theta_fn=None if th is None else trapezium(
            ramp_up=tuple(th["ramp_up"]), ramp_down=tuple(th["ramp_down"])))
    return fleet_summary(final)


def _compute() -> dict:
    runs = []
    for run in RUNS:
        runs.append(dict(run, summary=jax_summary(run)))
        print(run["name"], runs[-1]["summary"], flush=True)
    return dict(COMMON, runs=runs)


def main() -> None:
    fresh = _compute()
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

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

Phase 19's registry scenarios (``SCENARIO_RUNS``, under the file's
``scenario_runs`` key) are each a registry name, a policy, a horizon and
an optional fault schedule written as JSON (``FaultSpec`` field → list
of the fault's keyword arguments).  Each entry carries the SHA-256 of
every ``FleetSignals`` field the JAX ``compile_fleet`` produced (dtype,
shape and bytes, as ``repro_torch.scenarios.compile.signal_digests``
takes them), the JAX ``fleet_summary`` of ``run_scenario_fleet``, and
the merged numbers of the JAX ``run_scenario_oracle``.
"""
import dataclasses
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


# the scenarios whose signals carry a factor other than 1.0 (edge speed
# factors, stochastic durations), each for 8 s under DEMS, GEMS-A and
# DEMS-COOP; then the short partition (a link partition and an edge crash
# both fire) and brownout specs of tests/test_torch_scenarios.py
SCENARIO_RUNS = [
    dict(name=f"{scenario}-{policy.lower()}", phase=19, scenario=scenario,
         policy=policy, duration_ms=8_000.0, faults=None)
    for scenario in ("hetero-edges", "duration-jitter", "heavy-tail")
    for policy in ("DEMS", "GEMS-A", "DEMS-COOP")] + [
    dict(name="partition-dems-coop", phase=19, scenario="partition",
         policy="DEMS-COOP", duration_ms=10_000.0, faults=dict(
             partitions=[dict(start_ms=2_000.0, end_ms=6_000.0,
                              edges=[0])],
             crashes=[dict(edge=1, start_ms=4_000.0, end_ms=7_000.0)])),
    dict(name="brownout-gems-a", phase=19, scenario="brownout",
         policy="GEMS-A", duration_ms=15_000.0, faults=dict(
             brownouts=[dict(start_ms=2_000.0, end_ms=12_000.0,
                             theta_ms=350.0, ramp_ms=3_000.0)])),
]
ORACLE_FIELDS = ("generated", "completed", "qos_utility", "qoe_utility",
                 "stolen", "migrated")


def spec_of(run: dict, registry, faults):
    """A phase-19 entry's ``ScenarioSpec`` from either package's
    ``scenarios.registry`` and ``faults`` modules."""
    spec = registry.get(run["scenario"], duration_ms=run["duration_ms"])
    if run["faults"] is None:
        return spec
    kinds = dict(crashes=faults.EdgeCrash, partitions=faults.Partition,
                 jamming=faults.Jamming, brownouts=faults.Brownout,
                 floods=faults.Flood)
    return dataclasses.replace(spec, faults=faults.FaultSpec(**{
        field: tuple(kinds[field](**{k: tuple(v) if isinstance(v, list)
                                     else v for k, v in f.items()})
                     for f in fs)
        for field, fs in run["faults"].items()}))


def jax_scenario_entry(run: dict) -> dict:
    from repro import faults
    from repro.scenarios import registry
    from repro.scenarios.compile import compile_fleet
    from repro.scenarios.runner import (fleet_summary, run_scenario_fleet,
                                        run_scenario_oracle)
    from repro_torch.scenarios.compile import signal_digests
    spec = spec_of(run, registry, faults)
    merged = run_scenario_oracle(spec, run["policy"]).merged
    return dict(
        run, digests=signal_digests(compile_fleet(spec, COMMON["dt"])),
        summary=fleet_summary(run_scenario_fleet(spec, run["policy"],
                                                 dt=COMMON["dt"])),
        oracle={k: getattr(merged, k) for k in ORACLE_FIELDS})


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
    scenario_runs = []
    for run in SCENARIO_RUNS:
        scenario_runs.append(jax_scenario_entry(run))
        print(run["name"], scenario_runs[-1]["summary"],
              scenario_runs[-1]["oracle"], flush=True)
    return dict(COMMON, runs=runs, scenario_runs=scenario_runs)


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

"""The port's golden files: the JAX ``fleet_summary`` of every fleet run
``chip_smoke.py`` drives on the card (``tests/golden/
torch_port_summaries.json``, written by ``regen_torch_port_summaries.py``),
and the JAX model numbers it holds the full-width granite, zamba2,
qwen3-moe and whisper models and the trainer to (``torch_port_model.json``,
``torch_port_zamba2.json``, ``torch_port_qwen3moe.json``,
``torch_port_whisper.json``, ``torch_port_train.json``, written by
``regen_torch_port_model.py``; each file must hold what its generator
defines).

The small 2-edge entries are re-run here through JAX and through the CPU
port: both must reproduce the file exactly, and the port's final state
must equal the JAX one — these are the slice's main workloads (DEMS-A,
GEMS on WL1 at α = 0.9, DEMS-COOP) and SOTA2, the one policy that reads
the mean-completion comparison, with a θ(t) that moves inside 30 s.

Phase 19's registry-scenario entries are rebuilt by ``chip_smoke.py``'s
own ``scenario_spec`` and compiled by the port on the CPU: every field's
digest must equal the JAX compiler's in the file, and the port's oracle
must give the file's JAX oracle numbers; one entry's summary is re-run
through both fleets (``tests/test_torch_scenarios.py`` holds the rest of
these scenarios' fleet runs to JAX at 20 s).
"""
import importlib.util
import json
import pathlib

import pytest

torch = pytest.importorskip("torch")

from _torch_parity import assert_states_match  # noqa: E402
from repro import faults as JF  # noqa: E402
from repro.scenarios import registry as JR  # noqa: E402
from repro.scenarios import runner as JRun  # noqa: E402
from repro.scenarios.runner import fleet_summary as jax_fleet_summary  # noqa: E402,E501
from repro.sim import fleet_jax as FJ  # noqa: E402
from repro.sim import network as JN  # noqa: E402
from repro_torch import faults as TF  # noqa: E402
from repro_torch.core import task as TT  # noqa: E402
from repro_torch.scenarios import registry as TR  # noqa: E402
from repro_torch.scenarios import runner as TRun  # noqa: E402
from repro_torch.scenarios.compile import (compile_fleet,  # noqa: E402
                                           signal_digests)
from repro_torch.scenarios.runner import fleet_summary  # noqa: E402
from repro_torch.sim import fleet as F  # noqa: E402
from repro_torch.sim import network as TN  # noqa: E402

GOLDEN_DIR = pathlib.Path(__file__).parent / "golden"
GOLDEN = json.loads((GOLDEN_DIR / "torch_port_summaries.json").read_text())
SMALL = [r for r in GOLDEN["runs"] if r["phase"] == 3]
SCENARIOS = GOLDEN["scenario_runs"]


def _regen_module(name="regen_torch_port_summaries"):
    spec = importlib.util.spec_from_file_location(
        name, GOLDEN_DIR / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _chip_smoke():
    """``chip_smoke.py`` as a module (its top level defines only
    constants and functions; ``main`` runs under ``__main__``)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", GOLDEN_DIR.parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _port_models(spec: str):
    if spec in ("PASSIVE", "ACTIVE"):
        names = TT.PASSIVE if spec == "PASSIVE" else TT.ACTIVE
        return [TT.TABLE1[n] for n in names]
    wl, alpha = spec.split("@")
    return TT.table2(wl, float(alpha))


def _kwargs(run, trapezium):
    th = run["theta"]
    return dict(
        n_edges=run["n_edges"], drones_per_edge=GOLDEN["drones_per_edge"],
        duration_ms=run["duration_ms"], dt=GOLDEN["dt"],
        edge_frac=GOLDEN["edge_frac"], cloud_frac=GOLDEN["cloud_frac"],
        cloud_slots=GOLDEN["cloud_slots"], seed=GOLDEN["seed"],
        theta_fn=None if th is None else trapezium(
            ramp_up=tuple(th["ramp_up"]), ramp_down=tuple(th["ramp_down"])))


def test_golden_file_matches_its_generator():
    """The file holds exactly the runs its generator defines: the four
    2-edge workloads and the 28-edge paper-scale fleet."""
    regen = _regen_module()
    assert [{k: v for k, v in r.items() if k != "summary"}
            for r in GOLDEN["runs"]] == regen.RUNS
    assert {k: GOLDEN[k] for k in regen.COMMON} == regen.COMMON
    assert {r["n_edges"] for r in GOLDEN["runs"] if r["phase"] == 4} == {28}
    assert len(SMALL) == 4


def test_scenario_golden_matches_its_generator():
    """Phase 19's entries are the generator's definitions, each with a
    digest of every signal field, a fleet summary and the oracle's
    numbers; and the generator's spec builder agrees with the one
    ``chip_smoke.py`` uses."""
    regen = _regen_module()
    extra = {"digests", "summary", "oracle"}
    assert [{k: v for k, v in r.items() if k not in extra}
            for r in SCENARIOS] == regen.SCENARIO_RUNS
    assert len(SCENARIOS) == 11
    chip = _chip_smoke()
    for run in SCENARIOS:
        assert set(run["digests"]) == set(F.FleetSignals._fields)
        assert set(run["summary"]) == set(SMALL[0]["summary"])
        assert set(run["oracle"]) == set(regen.ORACLE_FIELDS)
        assert chip.scenario_spec(run) == regen.spec_of(run, TR, TF)
        assert chip.summary_mismatch(run["summary"], run["summary"]) == []
    assert chip.summary_mismatch(
        dict(SMALL[0]["summary"], stolen=-1), SMALL[0]["summary"]) != []


@pytest.mark.parametrize("run", SCENARIOS, ids=[r["name"] for r in SCENARIOS])
def test_scenario_digests_and_oracle_through_port(run):
    """What phase 19 checks on the card, here on the CPU: the port's
    compiler reproduces the JAX compiler's digests, and the port's oracle
    the JAX oracle's numbers."""
    spec = _chip_smoke().scenario_spec(run)
    sig = compile_fleet(spec, GOLDEN["dt"], device="cpu")
    assert signal_digests(sig) == run["digests"]
    merged = TRun.run_scenario_oracle(spec, run["policy"]).merged
    assert {k: getattr(merged, k) for k in run["oracle"]} == run["oracle"]
    # within the horizon a fault fires, or a factor other than 1.0 acts
    fired = (~sig.link_up).any() | (~sig.edge_up).any() | (sig.theta > 0).any()
    factor = (sig.exec_jit != 1).any() | (sig.load_mult != 1).any()
    assert bool(fired if run["faults"] is not None else factor)


def test_scenario_summary_through_both_packages():
    """One phase-19 entry through both fleets: the JAX fleet and oracle
    reproduce the file, and the port's fleet on the CPU is held to it as
    phase 19 holds the card."""
    regen = _regen_module()
    run = next(r for r in SCENARIOS if r["name"] == "heavy-tail-gems-a")
    j_spec = regen.spec_of(run, JR, JF)
    assert jax_fleet_summary(JRun.run_scenario_fleet(
        j_spec, run["policy"], dt=GOLDEN["dt"])) == run["summary"]
    merged = JRun.run_scenario_oracle(j_spec, run["policy"]).merged
    assert {k: getattr(merged, k) for k in run["oracle"]} == run["oracle"]
    got = fleet_summary(TRun.run_scenario_fleet(
        regen.spec_of(run, TR, TF), run["policy"], dt=GOLDEN["dt"],
        device="cpu"))
    assert _chip_smoke().summary_mismatch(got, run["summary"]) == []
    assert got["stolen"] > 0


@pytest.mark.parametrize("run", SMALL, ids=[r["name"] for r in SMALL])
def test_small_run_jax_and_port_reproduce_golden(run):
    regen = _regen_module()
    want = FJ.simulate_fleet(regen.models_of(run["models"]), run["policy"],
                             **_kwargs(run, JN.trapezium))
    got = F.simulate_fleet(_port_models(run["models"]), run["policy"],
                           device="cpu", **_kwargs(run, TN.trapezium))
    assert jax_fleet_summary(want) == run["summary"]
    assert fleet_summary(got) == run["summary"]
    assert_states_match(got, want)
    # every stealing workload reaches the selection kernel through real
    # decisions (SOTA2 does not steal)
    if run["policy"] != "SOTA2":
        assert run["summary"]["stolen"] > 0
    if run["policy"].endswith("-COOP"):
        assert run["summary"]["peer_offloaded"] > 0


MODEL_GOLDENS = ["torch_port_model.json", "torch_port_zamba2.json",
                 "torch_port_qwen3moe.json", "torch_port_whisper.json"]


@pytest.mark.parametrize("fname", MODEL_GOLDENS)
def test_model_golden_file_matches_its_generator(fname):
    """The model golden file holds the entry its generator defines (the
    spec's fields, tokens of its shape, a forward row per batch row and
    position, the prefill's top-k, and a greedy decode chain that feeds
    each step the previous step's top-1), and its config builds a port
    model on the route the entry names (the JAX ``"pallas"`` is the
    port's ``"kernel"``; whisper's golden is JAX ``"ref"``, whose
    ``"pallas"`` route cannot take 1,500 frames)."""
    from repro_torch.models.model import Model
    regen = _regen_module("regen_torch_port_model")
    assert set(regen.GOLDENS) == set(MODEL_GOLDENS)
    spec = regen.GOLDENS[fname]
    gold = json.loads((GOLDEN_DIR / fname).read_text())
    assert set(gold) == set(spec) | {"tokens", "forward", "prefill",
                                     "decode"}
    assert {k: gold[k] for k in spec} == spec
    cfg = regen.config(spec)
    assert spec["attn_impl"] == ("ref" if cfg.family == "encdec"
                                 else "pallas")
    assert cfg.attn_impl == {"pallas": "kernel", "ref": "ref"}[
        spec["attn_impl"]] and cfg.n_layers == spec["n_layers"]
    Model(cfg, "cpu").param_shapes()
    tokens = gold["tokens"]
    assert len(tokens) == spec["batch"]
    assert all(len(row) == spec["seq"] and max(row) < cfg.vocab
               for row in tokens)
    assert [(e["b"], e["pos"]) for e in gold["forward"]] == [
        (b, p) for b in range(spec["batch"]) for p in spec["positions"]]
    assert all(len(e["ids"]) == spec["top"] for e in gold["forward"])
    assert len(gold["prefill"]) == spec["batch"]
    assert len(gold["decode"]) == spec["decode_steps"]
    fed = [e["ids"][0] for e in gold["prefill"]]
    for step in gold["decode"]:
        assert step["fed"] == fed
        fed = step["top1"]


def test_train_golden_file_matches_its_generator():
    """The training golden holds the entry its generator defines: a loss
    a step, step 0's gradient norm, and the f64 sum and sum of squares of
    every final parameter leaf of the port's parameter tree, on the
    ``"ref"`` route."""
    import math

    from repro_torch.models.model import Model
    regen = _regen_module("regen_torch_port_model")
    assert set(regen.TRAIN_GOLDENS) == {"torch_port_train.json"}
    spec = regen.TRAIN_GOLDENS["torch_port_train.json"]
    gold = json.loads((GOLDEN_DIR / "torch_port_train.json").read_text())
    assert set(gold) == set(spec) | {"losses", "grad_norm", "param_sums"}
    assert {k: gold[k] for k in spec} == spec
    cfg = regen.config(spec)
    assert cfg.attn_impl == "ref" and spec["attn_impl"] == "ref"
    assert len(gold["losses"]) == spec["steps"] and gold["grad_norm"] > 0
    shapes = Model(cfg, "cpu").param_shapes()
    paths = sorted(f"{g}.{n}" if isinstance(v, dict) else g
                   for g, v in shapes.items()
                   for n in (v if isinstance(v, dict) else [None]))
    assert sorted(gold["param_sums"]) == paths
    for path, entry in gold["param_sums"].items():
        group, _, name = path.partition(".")
        shape = shapes[group][name] if name else shapes[group]
        assert entry["numel"] == math.prod(shape) and entry["sumsq"] > 0

"""The port's golden files: the JAX ``fleet_summary`` of every fleet run
``chip_smoke.py`` drives on the card (``tests/golden/
torch_port_summaries.json``, written by ``regen_torch_port_summaries.py``),
and the JAX model numbers it holds the full-width granite, zamba2 and
qwen3-moe models to (``torch_port_model.json``, ``torch_port_zamba2.json``,
``torch_port_qwen3moe.json``, written by ``regen_torch_port_model.py``;
each file must hold what its generator defines).

The small 2-edge entries are re-run here through JAX and through the CPU
port: both must reproduce the file exactly, and the port's final state
must equal the JAX one — these are the slice's main workloads (DEMS-A,
GEMS on WL1 at α = 0.9, DEMS-COOP) and SOTA2, the one policy that reads
the mean-completion comparison, with a θ(t) that moves inside 30 s.
"""
import importlib.util
import json
import pathlib

import pytest

torch = pytest.importorskip("torch")

from _torch_parity import assert_states_match  # noqa: E402
from repro.scenarios.runner import fleet_summary as jax_fleet_summary  # noqa: E402,E501
from repro.sim import fleet_jax as FJ  # noqa: E402
from repro.sim import network as JN  # noqa: E402
from repro_torch.core import task as TT  # noqa: E402
from repro_torch.scenarios.runner import fleet_summary  # noqa: E402
from repro_torch.sim import fleet as F  # noqa: E402
from repro_torch.sim import network as TN  # noqa: E402

GOLDEN_DIR = pathlib.Path(__file__).parent / "golden"
GOLDEN = json.loads((GOLDEN_DIR / "torch_port_summaries.json").read_text())
SMALL = [r for r in GOLDEN["runs"] if r["phase"] == 3]


def _regen_module(name="regen_torch_port_summaries"):
    spec = importlib.util.spec_from_file_location(
        name, GOLDEN_DIR / f"{name}.py")
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


@pytest.mark.parametrize("fname", ["torch_port_model.json",
                                   "torch_port_zamba2.json",
                                   "torch_port_qwen3moe.json"])
def test_model_golden_file_matches_its_generator(fname):
    """The model golden file holds the entry its generator defines (the
    spec's fields, tokens of its shape, a forward row per batch row and
    position, the prefill's top-k, and a greedy decode chain that feeds
    each step the previous step's top-1), and its config builds a port
    model with the kernel route."""
    from repro_torch.models.model import Model
    regen = _regen_module("regen_torch_port_model")
    assert set(regen.GOLDENS) == {"torch_port_model.json",
                                  "torch_port_zamba2.json",
                                  "torch_port_qwen3moe.json"}
    spec = regen.GOLDENS[fname]
    gold = json.loads((GOLDEN_DIR / fname).read_text())
    assert set(gold) == set(spec) | {"tokens", "forward", "prefill",
                                     "decode"}
    assert {k: gold[k] for k in spec} == spec
    cfg = regen.config(spec)
    assert cfg.attn_impl == "kernel" and cfg.n_layers == spec["n_layers"]
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

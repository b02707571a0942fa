"""The plain reference against the JAX package's fleet summaries, which
the repository keeps as ``tests/golden/torch_port_summaries.json``: every
run there (2 edges and the paper's 28, DEMS-A, GEMS, DEMS-COOP and SOTA2,
θ steady or a trapezium) worked out again by ``portbench/reference`` on
the host from the benchmark's own copy of the steady-signal generator.
The golden numbers came from the JAX package, so this holds the
reference to the semantics the port was ported from, apart from the
port's own code."""
import json
import pathlib

import numpy as np
import pytest
import torch

from portbench.harness import traffic
from portbench.harness.models import ModelRow
from portbench.reference import tick as ref

from repro_torch.core import task

GOLDEN = json.loads((pathlib.Path(__file__).resolve().parents[2] / "tests"
                     / "golden" / "torch_port_summaries.json").read_text())
FIELDS = ("name", "beta", "deadline", "t_edge", "t_cloud", "cost_edge",
          "cost_cloud", "qoe_beta", "qoe_alpha", "qoe_window")


def _models(spec: str) -> list:
    """``PASSIVE`` / ``ACTIVE`` Table-1 sets or ``WLn@alpha`` (Table 2),
    as the benchmark's model rows."""
    if spec in ("PASSIVE", "ACTIVE"):
        rows = [task.TABLE1[n] for n in getattr(task, spec)]
    else:
        wl, alpha = spec.split("@")
        rows = task.table2(wl, float(alpha))
    return [ModelRow(**{k: getattr(m, k) for k in FIELDS}) for m in rows]


@pytest.mark.parametrize("run", GOLDEN["runs"], ids=lambda r: r["name"])
def test_reference_reproduces_golden_summary(run):
    models = _models(run["models"])
    th = run["theta"]
    theta = None if th is None else dict(low=0.0, high=400.0, **th)
    host = traffic.steady_signals(
        len(models), run["n_edges"], GOLDEN["drones_per_edge"],
        run["duration_ms"], GOLDEN["dt"], theta,
        np.random.default_rng(GOLDEN["seed"]))
    sig = ref.FleetSignals(*(torch.from_numpy(host[k])
                             for k in traffic.SIGNAL_FIELDS))
    old = torch.get_num_threads()
    torch.set_num_threads(min(4, old))
    try:
        final, _ = ref.run_mission(
            models, run["policy"], sig, dt=GOLDEN["dt"],
            edge_frac=GOLDEN["edge_frac"], cloud_frac=GOLDEN["cloud_frac"],
            cloud_slots=GOLDEN["cloud_slots"])
    finally:
        torch.set_num_threads(old)
    assert ref.fleet_summary(final) == run["summary"]

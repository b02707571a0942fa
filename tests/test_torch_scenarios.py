"""Registry scenarios through the port's own compiler: each case builds
its spec in both packages, holds the port's ``compile_fleet`` bitwise to
the JAX one, then runs the port's ``run_scenario_fleet`` (its own
signals) against the JAX ``run_fleet`` on the JAX signals.

* ``cloud-crunch`` — a two-slot finite cloud pool under a 4× burst (the
  queue-wait estimate, the slot gate and the parked-dispatch path);
* ``brownout`` — the chaos engine's θ brownout (moved inside a short
  horizon: ramp up, plateau, ramp down) on ACTIVE models with live QoE
  windows, under GEMS-A;
* ``partition`` — its windows moved inside a short horizon, so a link
  partition (``link_up``) and an edge crash (``edge_up``) both fire, with
  peer offload on;
* ``hetero-edges`` (edge speed factors, so ``load_mult`` ≠ 1),
  ``duration-jitter`` and ``heavy-tail`` (stochastic per-(tick, model)
  execution durations, so ``exec_jit`` ≠ 1), each for 20 s under DEMS,
  GEMS-A and DEMS-COOP: products of a duration and a factor that is not
  1 are where XLA's fused multiply-add and the port's separate rounding
  can part, so a counter flipped by an ulp shows here.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import (assert_signals_equal,  # noqa: E402
                           assert_states_match)
from repro import faults as JF  # noqa: E402
from repro.scenarios import compile as JC  # noqa: E402
from repro.scenarios import registry as JR  # noqa: E402
from repro.sim import fleet_jax as FJ  # noqa: E402
from repro_torch import faults as TF  # noqa: E402
from repro_torch.scenarios import compile as TC  # noqa: E402
from repro_torch.scenarios import registry as TR  # noqa: E402
from repro_torch.scenarios.runner import run_scenario_fleet  # noqa: E402


def _partition_short(reg, fl):
    spec = reg.get("partition", duration_ms=10_000.0)
    return dataclasses.replace(spec, faults=fl.FaultSpec(
        partitions=(fl.Partition(start_ms=2_000.0, end_ms=6_000.0,
                                 edges=(0,)),),
        crashes=(fl.EdgeCrash(edge=1, start_ms=4_000.0, end_ms=7_000.0),)))


def _brownout_short(reg, fl):
    spec = reg.get("brownout", duration_ms=15_000.0)
    return dataclasses.replace(spec, faults=fl.FaultSpec(brownouts=(
        fl.Brownout(start_ms=2_000.0, end_ms=12_000.0, theta_ms=350.0,
                    ramp_ms=3_000.0),)))


# name → (spec maker from (registry, faults) modules, policy, the signal
# that must differ from 1.0 somewhere in the horizon, or None)
CASES = {
    "cloud-crunch": (lambda reg, fl: reg.get("cloud-crunch",
                                             duration_ms=12_000.0),
                     "DEMS", None),
    "brownout": (_brownout_short, "GEMS-A", None),
    "partition": (_partition_short, "DEMS-COOP", None),
}
for _scenario, _factor in (("hetero-edges", "load_mult"),
                           ("duration-jitter", "exec_jit"),
                           ("heavy-tail", "exec_jit")):
    for _policy in ("DEMS", "GEMS-A", "DEMS-COOP"):
        CASES[f"{_scenario}-{_policy}"] = (
            lambda reg, fl, s=_scenario: reg.get(s, duration_ms=20_000.0),
            _policy, _factor)


@pytest.mark.parametrize("name", list(CASES))
def test_scenario_matches_jax(name):
    make, policy, factor = CASES[name]
    j_spec, t_spec = make(JR, JF), make(TR, TF)
    sig = JC.compile_fleet(j_spec, 25.0)
    assert_signals_equal(TC.compile_fleet(t_spec, 25.0, device="cpu"), sig)
    want = FJ.run_fleet(j_spec.models, policy, sig,
                        cloud_slots=j_spec.cloud_concurrency)
    got = run_scenario_fleet(t_spec, policy, device="cpu")
    if factor is not None:
        assert (np.asarray(getattr(sig, factor)) != 1.0).any(), factor
    assert_states_match(got, want)
    if name == "partition":
        assert not bool(sig.link_up.all()) and not bool(sig.edge_up.all())

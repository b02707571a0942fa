"""Registry scenarios through the port: ``repro.scenarios.compile.
compile_fleet`` → numpy → ``repro_torch.convert.from_numpy``, held to the
JAX ``run_fleet`` on the same signals.

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

from _torch_parity import assert_states_match, run_pair  # noqa: E402
from repro.faults.spec import (Brownout, EdgeCrash, FaultSpec,  # noqa: E402
                               Partition)
from repro.scenarios import get  # noqa: E402
from repro.scenarios.compile import compile_fleet  # noqa: E402


def _partition_short():
    spec = get("partition", duration_ms=10_000.0)
    return dataclasses.replace(spec, faults=FaultSpec(
        partitions=(Partition(start_ms=2_000.0, end_ms=6_000.0,
                              edges=(0,)),),
        crashes=(EdgeCrash(edge=1, start_ms=4_000.0, end_ms=7_000.0),)))


def _brownout_short():
    spec = get("brownout", duration_ms=15_000.0)
    return dataclasses.replace(spec, faults=FaultSpec(brownouts=(
        Brownout(start_ms=2_000.0, end_ms=12_000.0, theta_ms=350.0,
                 ramp_ms=3_000.0),)))


# name → (spec maker, policy, the signal that must differ from 1.0
# somewhere in the horizon, or None)
CASES = {
    "cloud-crunch": (lambda: get("cloud-crunch", duration_ms=12_000.0),
                     "DEMS", None),
    "brownout": (_brownout_short, "GEMS-A", None),
    "partition": (_partition_short, "DEMS-COOP", None),
}
for _scenario, _factor in (("hetero-edges", "load_mult"),
                           ("duration-jitter", "exec_jit"),
                           ("heavy-tail", "exec_jit")):
    for _policy in ("DEMS", "GEMS-A", "DEMS-COOP"):
        CASES[f"{_scenario}-{_policy}"] = (
            lambda s=_scenario: get(s, duration_ms=20_000.0), _policy,
            _factor)


@pytest.mark.parametrize("name", list(CASES))
def test_scenario_matches_jax(name):
    make, policy, factor = CASES[name]
    spec = make()
    sig = compile_fleet(spec, 25.0)
    got, want = run_pair(spec.models, policy, sig,
                         cloud_slots=spec.cloud_concurrency)
    if factor is not None:
        assert (np.asarray(getattr(sig, factor)) != 1.0).any(), factor
    assert_states_match(got, want)
    if name == "partition":
        assert not bool(sig.link_up.all()) and not bool(sig.edge_up.all())

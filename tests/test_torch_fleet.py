"""The port's fleet tick program against ``repro.sim.fleet_jax``.

Signals, the copied tables and the numpy boundary must equal the
reference's; every registry policy must end in the same final
``EdgeState`` as the JAX ``run_fleet`` on the same signals (integer
leaves exactly, float leaves to rtol 1e-6 / atol 1e-4, exact expected).
The three main workloads run at 2 edges × 30 s in
``test_torch_golden.py``; the other policies run shorter here.
"""
import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import assert_states_match, run_pair  # noqa: E402
from repro.core import schedulers as JS  # noqa: E402
from repro.core import task as JT  # noqa: E402
from repro.sim import fleet_jax as FJ  # noqa: E402
from repro.sim import network as JN  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import schedulers as TS  # noqa: E402
from repro_torch.core import task as TT  # noqa: E402
from repro_torch.sim import fleet as F  # noqa: E402
from repro_torch.sim import network as TN  # noqa: E402

SHORT_MS = 6_000.0
SHORT_RAMPS = dict(ramp_up=(1_000.0, 2_500.0),        # θ moves within it
                   ramp_down=(4_000.0, 5_500.0))
PASSIVE = [JT.TABLE1[n] for n in JT.PASSIVE]
WL1 = JT.table2("WL1", 0.9)


def test_copied_tables_equal_the_reference():
    for name, m in JT.TABLE1.items():
        assert dataclasses.asdict(TT.TABLE1[name]) == dataclasses.asdict(m)
    assert (TT.PASSIVE, TT.ACTIVE) == (JT.PASSIVE, JT.ACTIVE)
    for wl in ("WL1", "WL2"):
        assert [dataclasses.asdict(m) for m in TT.table2(wl, 0.7)] == \
            [dataclasses.asdict(m) for m in JT.table2(wl, 0.7)]
    assert TS._POLICIES == JS._POLICIES
    assert F._FLEET_POLICIES == FJ._FLEET_POLICIES
    for name in F._FLEET_POLICIES:
        for pol in (name, name + "-COOP"):
            ours = dataclasses.asdict(F.FleetPolicy.from_name(pol))
            assert ours == dataclasses.asdict(FJ.FleetPolicy.from_name(pol))
    t = np.arange(0, 300_000, 25, dtype=np.float32)
    np.testing.assert_array_equal(TN.trapezium()(t), JN.trapezium()(t))


def test_default_signals_bitwise_equal():
    kw = dict(n_edges=3, drones_per_edge=2, duration_ms=5_000.0, seed=3)
    want = jax.tree.map(np.asarray, FJ.default_signals(
        4, theta_fn=JN.trapezium(**SHORT_RAMPS), **kw))
    got = convert.to_numpy(F.default_signals(
        4, theta_fn=TN.trapezium(**SHORT_RAMPS), device="cpu", **kw))
    for name, g, w in zip(F.FleetSignals._fields, got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_array_equal(g, w, err_msg=name)


def test_bandwidth_penalty_matches_reference():
    bw = np.asarray([0.0, 0.3, 2.0, 7.5, 20.0, 33.3, 100.0], np.float32)
    got = TN.bandwidth_penalty_ms(torch.from_numpy(bw)).numpy()
    want = np.asarray(JN.bandwidth_penalty_ms(jax.numpy.asarray(bw)))
    np.testing.assert_array_equal(got, want)
    assert got[4] == 0.0                     # exactly zero at nominal


def test_convert_round_trip_and_dtypes():
    prof = FJ.Profiles.build(PASSIVE)
    state = jax.tree.map(np.asarray, FJ.FleetProgram().init(prof, "DEMS", 2))
    ours = convert.from_numpy(F.EdgeState, state, "cpu")
    assert isinstance(ours.eq, F.js.EdgeQueue)
    back = convert.to_numpy(ours)
    for (g, w) in zip(jax.tree.leaves(back), jax.tree.leaves(state)):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    params = convert.from_numpy(
        F.PolicyParams,
        jax.tree.map(np.asarray, FJ.FleetPolicy.from_name("GEMS").params()),
        "cpu")
    assert params.edge_prio.dtype == torch.int32 and bool(params.gems)
    with pytest.raises(TypeError, match="dtype"):
        convert.from_numpy(F.Profiles, F.Profiles(*[np.zeros(2)] * 11),
                           "cpu")


def test_port_state_init_matches_reference():
    prof = F.Profiles.build(TT.table2("WL1", 0.9), "cpu")
    ours = F.FleetProgram().init(prof, "GEMS", 3, cloud_slots=4,
                                 total_slots=6)
    want = FJ.FleetProgram().init(FJ.Profiles.build(WL1), "GEMS", 3,
                                  cloud_slots=4, total_slots=6)
    assert_states_match(ours, want)


def test_entry_points_refuse_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        F.default_signals(4, n_edges=1, duration_ms=100.0)
    with pytest.raises(RuntimeError, match="CUDA"):
        F.Profiles.build(PASSIVE)


@pytest.mark.parametrize("policy", ["EDF", "HPF", "CLD", "SJF-E+C", "SOTA1",
                                    "SOTA2", "DEM", "GEMS-B", "GEMS-A"])
def test_policy_matches_jax_on_short_run(policy):
    models = WL1 if policy.startswith("GEMS") else PASSIVE
    sig = FJ.default_signals(len(models), n_edges=2, duration_ms=SHORT_MS,
                             theta_fn=JN.trapezium(**SHORT_RAMPS))
    got, want = run_pair(models, policy, sig)
    assert_states_match(got, want)


def test_chunked_replay_is_bitwise_identical():
    models = [TT.TABLE1[n] for n in TT.ACTIVE]
    sig = F.default_signals(len(models), n_edges=3, duration_ms=2_000.0,
                            device="cpu")
    whole = F.run_fleet(models, "DEMS-COOP", sig, device="cpu")
    chunked = F.run_fleet(models, "DEMS-COOP", sig, chunk_ticks=7,
                          device="cpu")
    for a, b in zip(jax.tree.leaves(convert.to_numpy(whole)),
                    jax.tree.leaves(convert.to_numpy(chunked))):
        np.testing.assert_array_equal(a, b)

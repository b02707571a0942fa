"""The port's event simulator against the JAX package's on the same
seeds: ``repro_torch.sim.{engine,workloads,network}`` and the lockstep
``FleetOracle``.

Both packages build their own arrivals from the same seeds; the streams
must be equal, and then every policy must settle every task the same
way: each ``ModelStats`` field, and each task's model, arrival time,
outcome (which also says where it ran), finish time and flags, exactly.
The simulators are host code (Python + numpy), so nothing here has a
tolerance.
"""
import dataclasses

import numpy as np
import pytest

from repro.core import schedulers as JS
from repro.core import task as JT
from repro.scenarios import registry as JR
from repro.scenarios import runner as JRun
from repro.sim import engine as JE
from repro.sim import network as JN
from repro.sim import workloads as JW
from repro_torch.core import schedulers as TS
from repro_torch.core import task as TT
from repro_torch.scenarios import registry as TR
from repro_torch.scenarios import runner as TRun
from repro_torch.sim import engine as TE
from repro_torch.sim import network as TN
from repro_torch.sim import workloads as TW

DURATION = 60_000.0
# name → a maker of the workload from either package's ``workloads``
WORKLOADS = {
    "3D-P": lambda w: w.standard("3D-P", DURATION),
    "4D-A": lambda w: w.standard("4D-A", DURATION),
}
for _wl in ("WL1", "WL2"):
    for _alpha in (0.9, 1.0):
        WORKLOADS[f"{_wl}@{_alpha}"] = (
            lambda w, wl=_wl, alpha=_alpha: w.gems_workload(
                wl, alpha, duration_ms=DURATION))


def _profile(m):
    return dataclasses.astuple(m)


def _arrivals(arrivals):
    return [(a.time, _profile(a.model), a.drone) for a in arrivals]


def _task(t):
    return (t.uid, t.model.name, t.created, t.drone,
            None if t.outcome is None else t.outcome.value, t.finished,
            t.stolen, t.migrated, t.gems_rescheduled, t.steal_only,
            t.deadline_ext)


def _results(r):
    return (r.policy, r.duration, r.edge_busy,
            {n: dataclasses.astuple(s) for n, s in r.per_model.items()})


def _run_both(policy, j_arr, t_arr, duration, *, j_kw=None, t_kw=None,
              seed=0):
    """Run one policy on both packages; assert every count and task equal."""
    j_kw, t_kw = j_kw or {}, t_kw or {}
    j_res = JE.run_policy(JS.make_policy(policy), j_arr, duration,
                          seed=seed, **j_kw)
    t_res = TE.run_policy(TS.make_policy(policy), t_arr, duration,
                          seed=seed, **t_kw)
    assert _results(t_res) == _results(j_res)
    j_sim = JE.Simulator(JS.make_policy(policy), j_arr, duration, seed=seed,
                         **j_kw)
    t_sim = TE.Simulator(TS.make_policy(policy), t_arr, duration, seed=seed,
                         **t_kw)
    j_sim.run()
    t_sim.run()
    assert [_task(t) for t in t_sim.tasks] == [_task(t) for t in j_sim.tasks]
    return j_res


@pytest.mark.parametrize("workload", list(WORKLOADS))
def test_workload_streams_match(workload):
    make = WORKLOADS[workload]
    assert _arrivals(make(TW)) == _arrivals(make(JW))


@pytest.mark.parametrize("workload", list(WORKLOADS))
@pytest.mark.parametrize("policy", JS.ALL_POLICIES)
def test_run_policy_matches_jax(policy, workload):
    make = WORKLOADS[workload]
    j_arr, t_arr = make(JW), make(TW)
    assert _arrivals(t_arr) == _arrivals(j_arr)
    res = _run_both(policy, j_arr, t_arr, DURATION)
    assert res.generated == len(j_arr)


def test_policy_tables_match():
    assert TS.ALL_POLICIES == JS.ALL_POLICIES
    assert TW.STANDARD_WORKLOADS == JW.STANDARD_WORKLOADS


def _shaping(pkg):
    """θ(t) as §8.5's trapezium compressed into 60 s, and a deep-fading
    cellular trace (``bw-fade``'s walk) on the cloud link."""
    return dict(
        latency_at=pkg.trapezium(ramp_up=(12_000.0, 18_000.0),
                                 ramp_down=(42_000.0, 48_000.0)),
        bandwidth_at=pkg.cellular_bandwidth_trace(
            seed=11, duration_ms=DURATION, lo=0.3, hi=6.0, start=2.0))


def test_dems_a_under_shaped_cloud_matches_jax():
    """DEMS-A's estimator chases a moving θ and a fading link."""
    j_arr, t_arr = JW.standard("3D-P", DURATION), TW.standard("3D-P",
                                                              DURATION)
    res = _run_both(
        "DEMS-A", j_arr, t_arr, DURATION,
        j_kw=dict(cloud_model=JN.CloudLatencyModel(**_shaping(JN))),
        t_kw=dict(cloud_model=TN.CloudLatencyModel(**_shaping(TN))))
    assert res.completed > 0 and res.stolen > 0


@pytest.mark.parametrize("policy", ["GEMS-A", "DEMS", "SOTA1"])
def test_outages_crashes_and_give_up_match_jax(policy):
    """Cloud outages (both tuple forms, with cold starts), edge crash
    windows, a bounded cloud patience and transient edge stalls."""
    def kw(pkg):
        return dict(
            edge_model=pkg.EdgeLatencyModel(spike_p=0.05),
            cloud_outages=((10_000.0, 14_000.0),
                           (30_000.0, 33_000.0, 700.0, 4_000.0)),
            outage_cold_ms=400.0,
            edge_down_windows=((20_000.0, 23_000.0), (40_000.0, 41_000.0)),
            cloud_give_up_ms=1_500.0, cloud_concurrency=4)
    j_arr = JW.gems_workload("WL1", 0.9, duration_ms=DURATION)
    t_arr = TW.gems_workload("WL1", 0.9, duration_ms=DURATION)
    res = _run_both(policy, j_arr, t_arr, DURATION, j_kw=kw(JN), t_kw=kw(TN),
                    seed=3)
    assert res.completed > 0


def test_latency_samplers_match_bitwise():
    """One seeded generator each, the same draws in the same order."""
    grid = np.arange(0.0, DURATION, 250.0)
    table = np.random.default_rng(5).lognormal(
        0.0, 0.2, size=(int(DURATION / 25.0), 4)).astype(np.float32)
    names = ("HV", "DEV", "MD", "BP")

    def draws(pkg):
        rng = np.random.default_rng(1234)
        em = pkg.EdgeLatencyModel(spike_p=0.2)
        cm = pkg.CloudLatencyModel(**_shaping(pkg))
        te = pkg.TableEdgeLatencyModel(table=table, names=names)
        tc = pkg.TableCloudLatencyModel(table=table, names=names,
                                        **_shaping(pkg))
        out = []
        for i, now in enumerate(grid):
            name = names[i % 4]
            out += [em.sample(rng, 174.0, now=now, model=name),
                    cm.sample(rng, 398.0, now, model=name),
                    cm.shaped_delta(now),
                    te.sample(rng, 174.0, now=now, model=name),
                    tc.sample(rng, 398.0, now, model=name),
                    te.sample(rng, 174.0, now=now)]
        return np.asarray(out, np.float64)

    np.testing.assert_array_equal(draws(TN), draws(JN))


@pytest.mark.parametrize("kw", [
    dict(), dict(seed=11, lo=0.3, hi=6.0, start=2.0),
    dict(seed=3, duration_ms=30_000.0, step_ms=500.0)])
def test_bandwidth_walk_and_traces_match_bitwise(kw):
    grid = np.arange(0.0, 700_000.0, 125.0)       # past the wrap-around
    jb, tb = JN.cellular_bandwidth_trace(**kw), TN.cellular_bandwidth_trace(
        **kw)
    np.testing.assert_array_equal(tb(grid), jb(grid))
    assert [tb(float(t)) for t in grid[::97]] == [jb(float(t))
                                                 for t in grid[::97]]
    for make in (lambda p: p.trapezium(),
                 lambda p: p.trapezium(ramp_up=(5.0, 5.0),
                                       ramp_down=(9.0, 9.0)),
                 lambda p: p.constant(3.5)):
        np.testing.assert_array_equal(make(TN)(grid), make(JN)(grid))
    # the penalty's two branches: Python floats and arrays, and numpy
    # float32 scalars (which keep their dtype)
    for bw in (0.0, 7.3, 20.0, 55.0, np.float32(3.7), np.float64(3.7),
               jb(grid).astype(np.float32)):
        got = TN.host_bandwidth_penalty_ms(bw)
        want = JN.bandwidth_penalty_ms(bw)
        assert type(got) is type(want)
        np.testing.assert_array_equal(got, want)


def test_fleet_oracle_overloaded_edge_matches_jax():
    """Edge 0 drowning, edge 1 idle: the exchange moves the same tasks."""
    def run(pkg_e, pkg_s, pkg_n, models, ModelArrival):
        em = pkg_n.EdgeLatencyModel(mean_frac=0.62, sd_frac=0.0,
                                    lo_frac=0.62, hi_frac=0.62)
        flood = [ModelArrival(time=float(i * 5),
                              model=models[i % len(models)], drone=0)
                 for i in range(120)]
        idle = [ModelArrival(time=10_000.0, model=models[0], drone=1)]
        sims = [pkg_e.Simulator(pkg_s.make_policy("DEMS"), arr, 30_000.0,
                                seed=e, edge_model=em)
                for e, arr in enumerate((flood, idle))]
        orc = pkg_e.FleetOracle(sims, 30_000.0, dt=25.0, slack_ms=400.0,
                                max_transfers=2)
        results = orc.run()
        return (orc.peer_moved, [_results(r) for r in results],
                [[_task(t) for t in s.tasks] for s in sims])

    want = run(JE, JS, JN, [JT.TABLE1[n] for n in JT.PASSIVE], JE.Arrival)
    got = run(TE, TS, TN, [TT.TABLE1[n] for n in TT.PASSIVE], TE.Arrival)
    assert want[0] > 0
    assert got == want


def _oracle_with_moves(runner_mod, engine_mod, spec, policy, monkeypatch):
    """``run_scenario_oracle`` plus the lockstep oracle's ``peer_moved``."""
    moved = []
    run = engine_mod.FleetOracle.run

    def recording_run(self):
        out = run(self)
        moved.append(self.peer_moved)
        return out

    monkeypatch.setattr(engine_mod.FleetOracle, "run", recording_run)
    res = runner_mod.run_scenario_oracle(spec, policy)
    return res, moved


@pytest.mark.parametrize("policy", ["DEMS-COOP", "GEMS-A-COOP", "DEMS-A"])
def test_scenario_oracle_duration_jitter_matches_jax(policy, monkeypatch):
    """The table-backed samplers and, for ``*-COOP``, the lockstep
    exchange on the stochastic two-edge scenario."""
    want, j_moved = _oracle_with_moves(
        JRun, JE, JR.get("duration-jitter", duration_ms=DURATION), policy,
        monkeypatch)
    got, t_moved = _oracle_with_moves(
        TRun, TE, TR.get("duration-jitter", duration_ms=DURATION), policy,
        monkeypatch)
    assert [_results(r) for r in got.per_edge] == [_results(r)
                                                   for r in want.per_edge]
    assert _results(got.merged) == _results(want.merged)
    # the lockstep oracle runs exactly for ``*-COOP``, with the slack and
    # round bound of the port's own FleetPolicy
    assert t_moved == j_moved
    assert len(t_moved) == policy.endswith("-COOP")


def _invariant_workload(seed: int, pkg_task, pkg_engine):
    """A workload of the kind ``test_property_invariants`` draws (1-4
    random profiles, 1-3 drones, 30 segments), from a fixed seed."""
    rng = np.random.default_rng(seed)
    profiles = []
    for i in range(int(rng.integers(1, 5))):
        te = int(rng.integers(50, 801))
        profiles.append(pkg_task.ModelProfile(
            name=f"M{i}", beta=float(rng.integers(20, 301)),
            deadline=float(rng.integers(300, 1501)), t_edge=float(te),
            t_cloud=float(te * rng.uniform(0.5, 3.0)),
            cost_edge=float(rng.integers(1, 9)),
            cost_cloud=float(rng.integers(5, 321)),
            qoe_beta=50.0, qoe_alpha=0.8, qoe_window=10_000.0))
    n_drones = int(rng.integers(1, 4))
    return [pkg_engine.Arrival(time=s * 1000.0 + d * 137.0, model=p, drone=d)
            for d in range(n_drones) for s in range(30) for p in profiles]


@pytest.mark.parametrize("seed", range(6))
def test_invariant_workloads_edf_and_dems_match_jax(seed):
    j_arr = _invariant_workload(seed, JT, JE)
    t_arr = _invariant_workload(seed, TT, TE)
    assert _arrivals(t_arr) == _arrivals(j_arr)
    for policy in ("EDF", "DEMS"):
        _run_both(policy, j_arr, t_arr, 30_000.0, seed=seed % 4)


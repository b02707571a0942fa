"""The port's scenario and fault compilation against the JAX package's:
``repro_torch.scenarios.{spec,registry,mobility,compile}`` and
``repro_torch.faults``.

Compilation is host numpy drawing seeded streams, so every comparison
here is exact: ``compile_fleet`` field by field (dtype, shape and every
bit) for all 14 registry scenarios at their full 300 s horizon, the
duration-jitter tables, ``compile_oracle``'s per-edge inputs, the
streaming builder's windows, the flood and telemetry-chaos streams, and
the same ``ValueError`` for every malformed spec.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import assert_signals_equal  # noqa: E402
from repro import faults as JF  # noqa: E402
from repro.scenarios import compile as JC  # noqa: E402
from repro.scenarios import registry as JR  # noqa: E402
from repro.scenarios import spec as JSpec  # noqa: E402
from repro_torch import faults as TF  # noqa: E402
from repro_torch.scenarios import compile as TC  # noqa: E402
from repro_torch.scenarios import registry as TR  # noqa: E402
from repro_torch.scenarios import spec as TSpec  # noqa: E402
from repro_torch.sim import fleet as F  # noqa: E402

NAMES = JR.names()
DT = 25.0
JITTERED = ("duration-jitter", "heavy-tail")


def test_registry_names_match():
    assert TR.names() == NAMES
    assert len(NAMES) == 14


@pytest.mark.parametrize("name", NAMES)
def test_compile_fleet_matches_jax_at_full_horizon(name):
    j_spec, t_spec = JR.get(name), TR.get(name)
    assert t_spec.duration_ms == j_spec.duration_ms == 300_000.0
    got = TC.compile_fleet(t_spec, DT, device="cpu")
    assert_signals_equal(got, JC.compile_fleet(j_spec, DT))
    assert all(a.device.type == "cpu" for a in got)
    # the dtypes the tick program takes from default_signals
    ref = F.default_signals(len(t_spec.model_names), n_edges=1,
                            duration_ms=100.0, device="cpu")
    assert [a.dtype for a in got] == [a.dtype for a in ref]


@pytest.mark.parametrize("name", ("baseline",) + JITTERED)
def test_compile_exec_jitter_matches_jax(name):
    j_spec, t_spec = JR.get(name), TR.get(name)
    for got, want in zip(TC.compile_exec_jitter(t_spec, DT),
                         JC.compile_exec_jitter(j_spec, DT)):
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    # a zero-variance jitter is the deterministic lane, bit for bit
    zero = dict(edge_sigma=0.0, cloud_sigma=0.0)
    t_zero = dataclasses.replace(
        t_spec, jitter=TSpec.DurationJitter(**zero))
    for tab in TC.compile_exec_jitter(t_zero, DT, n_ticks=40):
        np.testing.assert_array_equal(tab, np.ones((40, 4), np.float32))


def _arrival_rows(edge_arrivals):
    return [[(a.time, dataclasses.astuple(a.model), a.drone) for a in arr]
            for arr in edge_arrivals]


@pytest.mark.parametrize("name", NAMES)
def test_compile_oracle_matches_jax(name):
    j_spec, t_spec = JR.get(name), TR.get(name)
    got, want = TC.compile_oracle(t_spec), JC.compile_oracle(j_spec)
    assert _arrival_rows(got.edge_arrivals) == _arrival_rows(
        want.edge_arrivals)
    assert got.outages == want.outages
    assert got.edge_outages == want.edge_outages
    assert got.crashes == want.crashes
    grid = np.arange(0.0, j_spec.duration_ms, DT)
    for fns in ("theta_fns", "bw_fns"):
        for g, w in zip(getattr(got, fns), getattr(want, fns)):
            np.testing.assert_array_equal(g(grid), w(grid))
            for t in grid[::1999]:
                assert g(float(t)) == w(float(t))


def _feed(builder, events) -> None:
    for kind, *args in events:
        getattr(builder, kind)(*args)


def _stream_events(rng, lo_ms: float, hi_ms: float, n_edges: int,
                   n_models: int) -> list:
    """Arrivals (same-cell pile-ups included) and channel updates over
    ``[lo_ms, hi_ms)``, some of them older than the emit cursor."""
    events = []
    for _ in range(60):
        t = float(rng.uniform(lo_ms - 300.0, hi_ms))
        events.append(("add_arrival", t, int(rng.integers(n_edges)),
                       int(rng.integers(n_models))))
    for _ in range(6):
        t = float(rng.uniform(lo_ms, hi_ms))
        e = None if rng.random() < 0.3 else int(rng.integers(n_edges))
        events += [("set_theta", t, float(rng.uniform(0, 400)), e),
                   ("set_bandwidth", t, float(rng.uniform(0.5, 40)), e),
                   ("set_load", t, float(rng.uniform(0.7, 1.6)), e),
                   ("set_edge_up", t, bool(rng.random() < 0.7), e),
                   ("set_link_up", t, bool(rng.random() < 0.7), e),
                   ("set_cloud_up", t, bool(rng.random() < 0.8))]
    events.append(("add_arrival", lo_ms - 500.0, 0, 0))  # late telemetry
    return events


def test_streaming_windows_match_jax():
    n_edges, n_models, window = 3, 4, 16
    j_b = JC.SignalWindowBuilder(n_edges, n_models, dt=DT, order_seed=7,
                                 start_tick=2)
    t_b = TC.SignalWindowBuilder(n_edges, n_models, dt=DT, order_seed=7,
                                 start_tick=2, device="cpu")
    rng = np.random.default_rng(21)
    for i in range(3):
        lo = (2 + i * window) * DT
        events = _stream_events(rng, lo, lo + window * DT, n_edges,
                                n_models)
        _feed(j_b, events)
        _feed(t_b, events)
        assert (t_b.cursor, t_b.pending_ticks) == (j_b.cursor,
                                                   j_b.pending_ticks)
        assert_signals_equal(t_b.emit_window(window),
                             j_b.emit_window(window))
    assert t_b.cursor == 2 + 3 * window


def test_load_dense_before_cursor_raises():
    b = TC.SignalWindowBuilder(1, 2, device="cpu")
    b.emit_window(4)
    with pytest.raises(ValueError, match="emit cursor"):
        b.load_dense("theta", np.zeros((2, 1), np.float32), start_tick=1)


FAULT_BUILDS = [
    lambda f: f.EdgeCrash(edge=-1, start_ms=0.0, end_ms=1.0),
    lambda f: f.EdgeCrash(edge=0, start_ms=5.0, end_ms=5.0),
    lambda f: f.Partition(start_ms=-1.0, end_ms=10.0),
    lambda f: f.Partition(start_ms=0.0, end_ms=10.0, edges=(-2,)),
    lambda f: f.Jamming(start_ms=0.0, end_ms=10.0, bw_cap_mbps=0.0),
    lambda f: f.Jamming(start_ms=0.0, end_ms=10.0, theta_ms=-1.0),
    lambda f: f.Brownout(start_ms=0.0, end_ms=10_000.0, ramp_ms=6_000.0),
    lambda f: f.Flood(start_ms=0.0, end_ms=10.0, rate_hz=0.0),
    lambda f: f.TelemetryChaos(drop_p=1.5),
    lambda f: f.TelemetryChaos(max_delay_ms=-1.0),
    lambda f: f.FaultSpec(crashes=(f.EdgeCrash(0, 0.0, 10_000.0),
                                   f.EdgeCrash(0, 5_000.0, 20_000.0))),
]


@pytest.mark.parametrize("i", range(len(FAULT_BUILDS)))
def test_bad_fault_specs_raise_in_both(i):
    build = FAULT_BUILDS[i]
    with pytest.raises(ValueError) as want:
        build(JF)
    with pytest.raises(ValueError) as got:
        build(TF)
    assert str(got.value) == str(want.value)


SPEC_BUILDS = [
    lambda r, s, f: dataclasses.replace(r.get("baseline"), faults=f.FaultSpec(
        crashes=(f.EdgeCrash(edge=3, start_ms=0.0, end_ms=1_000.0),))),
    lambda r, s, f: dataclasses.replace(r.get("baseline"), faults=f.FaultSpec(
        floods=(f.Flood(start_ms=0.0, end_ms=1_000.0, edges=(5,)),))),
    lambda r, s, f: dataclasses.replace(r.get("baseline"), qoe=(1.5, 100.0)),
    lambda r, s, f: r.get("baseline", duration_ms=0.0),
    lambda r, s, f: r.get("baseline", cloud_concurrency=0),
    lambda r, s, f: r.get("baseline", edges=()),
    lambda r, s, f: r.get("baseline", edges=(s.EdgeSite(radius=0.0),)),
    lambda r, s, f: r.get("baseline", drones=(
        s.DroneSpec(spawn_ms=5.0, despawn_ms=5.0),)),
    lambda r, s, f: r.get("baseline", bursts=(s.Burst(10.0, 5.0),)),
    lambda r, s, f: r.get("baseline", outages=(
        s.CloudOutage(0.0, 10.0), s.CloudOutage(5.0, 20.0))),
    lambda r, s, f: r.get("baseline", jitter=s.DurationJitter(
        heavy_tail_p=2.0)),
    lambda r, s, f: r.get("baseline", jitter=s.DurationJitter(
        edge_clip=(2.0, 1.0))),
    lambda r, s, f: r.get("no-such-scenario"),
]


@pytest.mark.parametrize("i", range(len(SPEC_BUILDS)))
def test_bad_scenario_specs_raise_in_both(i):
    build = SPEC_BUILDS[i]
    with pytest.raises(ValueError) as want:
        build(JR, JSpec, JF)
    with pytest.raises(ValueError) as got:
        build(TR, TSpec, TF)
    assert str(got.value) == str(want.value)


def test_n_steps_matches_jax():
    for total, step in ((300_000.0, 25.0), (0.1 + 0.1 + 0.1, 0.1)):
        assert TC.n_steps(total, step) == JC.n_steps(total, step)
    for total, step in ((1_000.0, 300.0), (10.0, 300.0)):
        with pytest.raises(ValueError, match="not an integer multiple"):
            TC.n_steps(total, step)


@pytest.mark.parametrize("name", ["flash-crowd", "ddos-flood"])
def test_flood_events_match_jax(name):
    j_spec, t_spec = JR.get(name), TR.get(name)
    args = (len(j_spec.model_names), j_spec.duration_ms, j_spec.n_drones)
    want = JF.flood_events(j_spec.seed, j_spec.faults, j_spec.n_edges, *args)
    got = TF.flood_events(t_spec.seed, t_spec.faults, t_spec.n_edges, *args)
    assert len(got) == len(want) > 0
    for (tg, dg, eg, og), (tw, dw, ew, ow) in zip(got, want):
        assert (tg, dg, eg) == (tw, dw, ew)
        np.testing.assert_array_equal(og, ow)


def test_perturb_telemetry_and_fault_lanes_match_jax():
    events = [(float(t), i) for i, t in enumerate(
        np.random.default_rng(3).uniform(0, 5_000, 400))]
    for kw in (dict(drop_p=0.1, dup_p=0.2, reorder_p=0.3, seed=4),
               dict(reorder_p=1.0, max_delay_ms=50.0)):
        got = TF.perturb_telemetry(events, TF.TelemetryChaos(**kw))
        want = JF.perturb_telemetry(events, JF.TelemetryChaos(**kw))
        assert got == want
    times = np.arange(0.0, 60_000.0, DT, dtype=np.float32)

    def faults(f):
        return f.FaultSpec(
            crashes=(f.EdgeCrash(1, 4_000.0, 9_000.0),),
            partitions=(f.Partition(2_000.0, 6_000.0, edges=(0,)),),
            jamming=(f.Jamming(10_000.0, 20_000.0, edges=(1,)),),
            brownouts=(f.Brownout(5_000.0, 40_000.0),))
    jf, tf = faults(JF), faults(TF)
    for fn in ("edge_up_dense", "link_up_dense"):
        np.testing.assert_array_equal(getattr(TF, fn)(tf, times, 2),
                                      getattr(JF, fn)(jf, times, 2))
    for fn in ("crash_windows", "partition_windows"):
        assert getattr(TF, fn)(tf, 2) == getattr(JF, fn)(jf, 2)
    for e in range(2):
        for fn in ("theta_overlay_fn", "bw_cap_fn"):
            np.testing.assert_array_equal(getattr(TF, fn)(tf, e)(times),
                                          getattr(JF, fn)(jf, e)(times))
    assert TF.__all__ == JF.__all__


def test_mobility_matches_jax():
    from repro.scenarios import mobility as JM
    from repro_torch.scenarios import mobility as TM
    j_spec, t_spec = JR.get("roaming-vips"), TR.get("roaming-vips")
    for d in range(j_spec.n_drones):
        for t in np.arange(0.0, 300_000.0, 1_700.0):
            assert TM.position(t_spec.drones[d], t) == JM.position(
                j_spec.drones[d], t)
            assert TM.assignment(t_spec, d, t) == JM.assignment(j_spec, d, t)

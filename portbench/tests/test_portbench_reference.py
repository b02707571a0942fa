"""The plain reference against the program on the host at a tiny size,
the benchmark's traffic against the program's own generators, and the
selection kernel's byte and bound arithmetic."""
import numpy as np
import pytest
import torch

from portbench.harness import check, roofline, traffic
from portbench.harness.models import model_rows
from portbench.harness.profile import read
from portbench.reference import tick as ref

from repro_torch.core import task
from repro_torch.scenarios.compile import SignalWindowBuilder
from repro_torch.scenarios.runner import fleet_summary
from repro_torch.serve.controller import FleetController
from repro_torch.sim import fleet as F
from repro_torch.sim import network

CFG = dict(dt=25.0, edge_frac=0.62, cloud_frac=0.80, cloud_slots=16)
MIXES = {
    "DEMS-COOP": dict(models=[dict(name=m.name, beta=m.beta,
                                   deadline=m.deadline, t_edge=m.t_edge,
                                   t_cloud=m.t_cloud, cost_edge=m.cost_edge,
                                   cost_cloud=m.cost_cloud)
                              for m in (task.TABLE1[n] for n in task.ACTIVE)],
                      theta=None),
    "GEMS-A": dict(models=[dict(name=m.name, beta=m.beta,
                                deadline=m.deadline, t_edge=m.t_edge,
                                t_cloud=m.t_cloud, cost_edge=m.cost_edge,
                                cost_cloud=m.cost_cloud, qoe_beta=m.qoe_beta,
                                qoe_alpha=m.qoe_alpha,
                                qoe_window=m.qoe_window)
                           for m in task.table2("WL1", 0.9)],
                   theta=dict(low=0.0, high=400.0, ramp_up=[200.0, 400.0],
                              ramp_down=[600.0, 800.0])),
}
EDGES, TICKS = 2, 40


def _signals(policy, seed):
    mix = MIXES[policy]
    return traffic.steady_signals(len(mix["models"]), EDGES, 3,
                                  TICKS * CFG["dt"], CFG["dt"], mix["theta"],
                                  traffic.mission_rng(seed, 0))


def _ref_final(policy, host, counters=False, threads=1):
    old = torch.get_num_threads()
    torch.set_num_threads(threads)
    try:
        return ref.run_mission(
            model_rows(MIXES[policy]), policy,
            ref.FleetSignals(*(torch.from_numpy(host[k])
                               for k in traffic.SIGNAL_FIELDS)),
            dt=CFG["dt"], edge_frac=CFG["edge_frac"],
            cloud_frac=CFG["cloud_frac"], cloud_slots=CFG["cloud_slots"],
            counters=counters)
    finally:
        torch.set_num_threads(old)


@pytest.mark.parametrize("policy", sorted(MIXES))
def test_reference_equals_run_fleet(policy):
    host = _signals(policy, 11)
    got = F.run_fleet(model_rows(MIXES[policy]), policy,
                      F.FleetSignals(*(torch.from_numpy(host[k])
                                       for k in traffic.SIGNAL_FIELDS)),
                      device="cpu", **CFG)
    want, _ = _ref_final(policy, host)
    assert check.state_numbers(check.named_leaves(got),
                               check.named_leaves(want)) \
        == dict(leaves_off=0, values_off=0)
    assert fleet_summary(got) == ref.fleet_summary(want)
    assert ref.fleet_summary(want)["completed"] > 0


@pytest.mark.parametrize("policy", sorted(MIXES))
def test_reference_equals_streamed_controller(policy):
    from portbench.drivers import stream
    mix = MIXES[policy]
    events = traffic.paper_events(len(mix["models"]), EDGES, 3,
                                  TICKS * CFG["dt"],
                                  traffic.mission_rng(3, 1))
    ctl = FleetController(model_rows(mix), policy, n_edges=EDGES,
                          dt=CFG["dt"], window_ticks=8,
                          cloud_slots=CFG["cloud_slots"], device="cpu")
    records, i, now = [], 0, 0.0
    while now < TICKS * CFG["dt"] or ctl.builder.pending_ticks:
        now += 8 * CFG["dt"]
        while i < len(events) and events[i][0] < now:
            ctl.submit(*events[i])
            i += 1
        records += ctl.poll(now)
    host = traffic.stream_signals(events, len(mix["models"]), EDGES,
                                  CFG["dt"], ctl.tick)
    want, counters = _ref_final(policy, host, counters=True)
    assert check.state_numbers(check.named_leaves(ctl.state),
                               check.named_leaves(want))["values_off"] == 0
    assert records == stream.records_of(counters, CFG["dt"])
    assert sum(r["arrivals"] for r in records) == len(events)


def test_reference_answers_do_not_depend_on_threads():
    host = _signals("DEMS-COOP", 5)
    one, _ = _ref_final("DEMS-COOP", host, threads=1)
    four, _ = _ref_final("DEMS-COOP", host, threads=4)
    assert check.state_numbers(check.named_leaves(one),
                               check.named_leaves(four))["values_off"] == 0


@pytest.mark.parametrize("theta", [None, dict(low=0.0, high=400.0,
                                              ramp_up=[6000.0, 9000.0],
                                              ramp_down=[21000.0, 24000.0])])
def test_steady_signals_equal_the_programs_generator(theta):
    fn = None if theta is None else network.trapezium(
        theta["low"], theta["high"], tuple(theta["ramp_up"]),
        tuple(theta["ramp_down"]))
    want = F.default_signals(6, n_edges=4, drones_per_edge=3,
                             duration_ms=30_000.0, dt=25.0, theta_fn=fn,
                             seed=21, device="cpu")
    got = traffic.steady_signals(6, 4, 3, 30_000.0, 25.0, theta,
                                 np.random.default_rng(21))
    for k, a in zip(traffic.SIGNAL_FIELDS, want):
        assert np.array_equal(got[k], a.numpy()), k


def test_stream_signals_equal_the_window_builder():
    events = traffic.paper_events(6, 3, 3, 2_000.0, traffic.mission_rng(8, 0))
    # two drones of one edge in one tick: a spill forward
    events = sorted(events + [(events[0][0], events[0][1], events[0][2])])
    b = SignalWindowBuilder(3, 6, dt=25.0, device="cpu")
    for ev in events:
        b.add_arrival(*ev)
    n = b.pending_ticks
    want = b.emit_window(n)
    got = traffic.stream_signals(events, 6, 3, 25.0, n)
    for k, a in zip(traffic.SIGNAL_FIELDS, want):
        assert np.array_equal(got[k], a.numpy()), k
    assert got["arrive"].sum() == len(events)


def test_argext_bytes_and_bound():
    # (28, 64): f32 scores and bool mask read, int32 index and f32 value
    # written a row
    assert roofline.argext_bytes(28, 64) == 28 * 64 * 5 + 28 * 8 == 9184
    assert roofline.bound_s(9184) == pytest.approx(2.7415e-9, rel=1e-4)
    assert roofline.bound_s(roofline.argext_bytes(1024, 64)) \
        == pytest.approx(1024 * 328 / 3.35e12)


def test_roofline_reader_and_idle_share():
    from portbench.harness import registry
    events = [("masked_argext_key<0>", True, 0.0, 2.0),
              ("masked_argext_key<1>", True, 10.0, 14.0),
              ("elementwise", True, 1.0, 3.0),
              ("poll", False, 0.0, 20.0)]
    prof = read(events, 20e-6)
    assert prof["busy_s"] == pytest.approx(7e-6)   # [0, 3] and [10, 14]
    assert prof["idle_gaps"][0] == ["poll", pytest.approx(7e-6)]
    obs = dict(driver="replay", profile=prof, argext_shapes=[(28, 64)])
    share = registry.metric("argext_roofline.replay").read(obs)
    assert share == pytest.approx(100 * 2.7415e-9 / 3e-6, rel=1e-4)
    # the idle share is the unprofiled window's, from the CUDA events
    assert registry.metric("idle_share.replay").read(obs) is None
    obs.update(event_busy_s=15.0, window_s=20.0)
    idle = registry.metric("idle_share.replay").read(obs)
    assert idle == pytest.approx(25.0)
    assert registry.metric("idle_share.stream").read(obs) is None

"""The port's flight recorder against ``repro.obs`` and the JAX traced
fleet.

Tolerance: integer and boolean counters, the histograms and every
metric built from them are held exactly; float leaves (the QoS/QoE
deltas, t̂, the final state's utilities) to rtol 1e-6 / atol 1e-4
(``_torch_parity``), and exact equality is the expected outcome.  The
one allowance: where a scenario scales durations by factors other than
1.0, a histogram count may move to the adjacent bin (XLA on the CPU
fuses the multiply-add that the port rounds twice).  Every run here is a
2 s horizon on 2-3 edges under a θ ramp that forces drops, misses,
migrations, GEMS moves, steals and peer offload.
"""
import dataclasses
import json
import math

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import (assert_counters_match,  # noqa: E402
                           assert_states_match, port_signals)
from repro.core import task as JT  # noqa: E402
from repro.obs import metrics as JM  # noqa: E402
from repro.obs import trace as JTR  # noqa: E402
from repro.scenarios import get as jget  # noqa: E402
from repro.scenarios.runner import run_scenario_fleet as j_run_scenario  # noqa
from repro.sim import fleet_jax as FJ  # noqa: E402
from repro.sim import network as JN  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.obs import metrics as TM  # noqa: E402
from repro_torch.obs import trace as TTR  # noqa: E402
from repro_torch.scenarios.registry import get as tget  # noqa: E402
from repro_torch.scenarios.runner import run_scenario_fleet  # noqa: E402
from repro_torch.sim import fleet as F  # noqa: E402

ACTIVE = [JT.TABLE1[n] for n in JT.ACTIVE]
PASSIVE = [JT.TABLE1[n] for n in JT.PASSIVE]
WL1 = JT.table2("WL1", 0.9)
RAMP = dict(ramp_up=(200.0, 600.0), ramp_down=(1_500.0, 1_900.0))
FULL = (JTR.TraceSpec.full(), TTR.TraceSpec.full())


def _signals(n_models, n_edges=2, duration_ms=2_000.0):
    return FJ.default_signals(n_models, n_edges=n_edges, drones_per_edge=4,
                              duration_ms=duration_ms,
                              theta_fn=JN.trapezium(**RAMP))


def _traced_pair(models, policy, sig, **kw):
    want = FJ.run_fleet(models, policy, sig, trace=FULL[0])
    got = F.run_fleet(models, policy, port_signals(sig), trace=FULL[1],
                      device="cpu", **kw)
    return got, want


def _assert_result_match(got, want, hist_adjacent=False):
    assert_states_match(got.final, want.final)
    np.testing.assert_array_equal(got.t_hat.numpy(), np.asarray(want.t_hat))
    assert_counters_match(got.counters, want.counters,
                          hist_adjacent=hist_adjacent)


# ---------------------------------------------------------------------------
# obs/trace.py
# ---------------------------------------------------------------------------

def test_trace_spec_and_schema_match_reference():
    assert dataclasses.asdict(TTR.TraceSpec()) == dataclasses.asdict(
        JTR.TraceSpec())
    for name in ("off", "full"):
        ours, ref = getattr(TTR.TraceSpec, name)(), getattr(
            JTR.TraceSpec, name)()
        assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
        assert ours.enabled == ref.enabled
    assert TTR.TraceSpec(t_hat=True).enabled and \
        hash(TTR.TraceSpec.full()) == hash(TTR.TraceSpec.full())
    with pytest.raises(dataclasses.FrozenInstanceError):
        TTR.TraceSpec().hist_bins = 8
    assert TTR.TickCounters._fields == JTR.TickCounters._fields
    assert len(TTR.TickCounters._fields) == 28
    assert TTR.EVENT_FIELDS == JTR.EVENT_FIELDS
    for args in ((None, False), (None, True),
                 (TTR.TraceSpec(counters=True), True)):
        ours = TTR.resolve_spec(*args)
        ref = JTR.resolve_spec(
            None if args[0] is None else JTR.TraceSpec(counters=True),
            args[1])
        assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    for mod in (TTR, JTR):
        with pytest.raises(TypeError, match="TraceSpec"):
            mod.resolve_spec("full")


@pytest.mark.parametrize("lead", [(), (3,), (2, 5)])
def test_zero_counters_match_reference(lead):
    spec = TTR.TraceSpec(hist_bins=12)
    ours = TTR.zero_counters(5, spec, lead, device="cpu")
    ref = JTR.zero_counters(5, JTR.TraceSpec(hist_bins=12))
    for name, g, w in zip(ref._fields, ours, ref):
        w = np.asarray(w)
        assert g.shape == lead + w.shape, name
        assert g.numpy().dtype == w.dtype, name
        assert not g.numpy().any(), name


_EDGES = np.concatenate([
    np.arange(-3, 35) * 125.0,                         # every bin edge
    np.arange(-3, 35) * 125.0 - 1e-3, np.arange(-3, 35) * 125.0 + 1e-3,
    [-1e30, -4e9, -0.0, 3_999.999, 4_000.0, 4e9, 1e30, np.inf, -np.inf]])


@pytest.mark.parametrize("case", ["edges", "random", "dense_overflow",
                                  "masked_rows"])
def test_hist_counts_match_reference(case):
    rng = np.random.default_rng(7)
    spec = TTR.TraceSpec()
    if case == "edges":
        vals = _EDGES.astype(np.float32)[None]
        mask = np.ones_like(vals, bool)
    elif case == "random":
        vals = rng.normal(1_500.0, 1_800.0, (9, 64)).astype(np.float32)
        mask = rng.random((9, 64)) < 0.6
    elif case == "dense_overflow":
        vals = rng.uniform(-2e4, 2e4, (4, 3, 33)).astype(np.float32)
        mask = rng.random((4, 3, 33)) < 0.9
    else:
        vals = rng.normal(200.0, 50.0, (6, 1)).astype(np.float32)
        mask = np.asarray([[True], [False]] * 3)
    got = TTR.hist_counts(torch.from_numpy(vals), torch.from_numpy(mask),
                          spec).numpy()
    assert got.dtype == np.int32 and got.shape == vals.shape[:-1] + (32,)
    flat_v, flat_m = vals.reshape(-1, vals.shape[-1]), \
        mask.reshape(-1, vals.shape[-1])
    want = np.stack([np.asarray(JTR.hist_counts(v, m, JTR.TraceSpec()))
                     for v, m in zip(flat_v, flat_m)])
    np.testing.assert_array_equal(got.reshape(want.shape), want)
    # clamp and overflow keep the total: every masked value lands once
    np.testing.assert_array_equal(got.sum(-1), mask.sum(-1))


# ---------------------------------------------------------------------------
# obs/metrics.py on the same counters
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_counters():
    """A JAX traced DEMS-COOP run's counters ([T, E, …] numpy)."""
    res = FJ.run_fleet(ACTIVE, "DEMS-COOP", _signals(len(ACTIVE)),
                       trace=FULL[0])
    return jax.tree.map(np.asarray, res.counters)


def _same(a, b):
    """Equal nested results, NaN equal to NaN."""
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    elif isinstance(a, float) and math.isnan(a):
        assert isinstance(b, float) and math.isnan(b)
    else:
        assert type(a) is type(b) and a == b, (a, b)


def test_metrics_match_reference_on_the_same_counters(jax_counters):
    jc = jax_counters
    tc = TTR.TickCounters(*(torch.from_numpy(np.array(x)) for x in jc))
    spec_j, spec_t = JTR.TraceSpec(), TTR.TraceSpec()
    names = [m.name for m in ACTIVE]
    _same(TM.bin_edges(spec_t), JM.bin_edges(spec_j))
    for q in (TM.PERCENTILES, (1.0, 50.0, 99.9)):
        _same(TM.hist_percentiles(tc.slack_hist, spec_t, q),
              JM.hist_percentiles(jc.slack_hist, spec_j, q))
    _same(TM.time_series(tc), JM.time_series(jc))
    _same(TM.conservation_ledger(tc), JM.conservation_ledger(jc))
    TM.check_conservation(tc)
    for kw in ({}, dict(window_ms=250.0), dict(window_ms=50.0, dt_ms=25.0)):
        _same(TM.deadline_hit_tail(tc, **kw), JM.deadline_hit_tail(jc, **kw))
    _same(TM.qoe_frequencies(tc, names), JM.qoe_frequencies(jc, names))
    _same(TM.qoe_frequencies(tc), JM.qoe_frequencies(jc))
    _same(TM.tail_metrics(tc, spec_t, names),
          JM.tail_metrics(jc, spec_j, names))
    assert TM.to_json(tc, spec_t, names) == JM.to_json(jc, spec_j, names)
    assert json.loads(TM.to_json(tc, spec_t, indent=1))["ledger"]
    assert TM.to_csv(tc) == JM.to_csv(jc)
    assert TM.to_perfetto(tc, stride=7) == JM.to_perfetto(jc, stride=7)
    rows = [dict(scenario="s", policy="DEMS-COOP", seed=0,
                 trace=F.FleetResult(None, None, tc))]
    jrows = [dict(rows[0], trace=FJ.FleetResult(None, None, jc))]
    _same(TM.summarize_rows(rows, spec_t)[0],
          JM.summarize_rows(jrows, spec_j)[0])
    # a leaked task fails the same way in both
    leak_t = tc._replace(arrivals=tc.arrivals.clone())
    leak_t.arrivals[5, 0] += 1
    leak_j = jc._replace(arrivals=np.array(jc.arrivals))
    leak_j.arrivals[5, 0] += 1
    msgs = []
    for fn, c in ((TM.check_conservation, leak_t),
                  (JM.check_conservation, leak_j)):
        with pytest.raises(AssertionError) as err:
            fn(c)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1] and "tick 5" in msgs[0]
    # a batch stream: one replica out of [R, T, E, …]
    stack_t = TTR.TickCounters(*(torch.stack([x, x]) for x in tc))
    _same(TM.time_series(TM.select_replica(stack_t, 1)),
          JM.time_series(JM.select_replica(
              JTR.TickCounters(*(np.stack([x, x]) for x in jc)), 1)))


# ---------------------------------------------------------------------------
# the traced tick against the JAX traced run_fleet
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("policy,models", [
    ("DEMS", ACTIVE), ("GEMS-A", WL1), ("DEMS-COOP", ACTIVE),
    ("SOTA2", PASSIVE)])
def test_traced_run_fleet_matches_jax(policy, models):
    got, want = _traced_pair(models, policy, _signals(len(models)))
    _assert_result_match(got, want)
    c = got.counters
    assert int(c.arrivals.sum()) > 0 and int(c.hit.sum()) > 0
    TM.check_conservation(c)


def test_traced_padded_tail_matches_jax():
    """Replica 0 of a padded pair (2 edges × 1.2 s inside 3 edges × 2 s):
    events zero on the padded cells, gauges hold, the ledger stays
    exact."""
    padded = FJ.pad_signals([_signals(len(ACTIVE), 2, 1_200.0),
                             _signals(len(ACTIVE), 3, 2_000.0)])
    lane = jax.tree.map(lambda a: a[0], padded)
    got, want = _traced_pair(ACTIVE, "DEMS-COOP", lane)
    _assert_result_match(got, want)
    valid = got.counters.valid.numpy()
    assert not valid[48:].any() and not valid[:, 2].any()
    for f in TTR.EVENT_FIELDS:
        assert not getattr(got.counters, f).numpy()[~valid].any(), f
    TM.check_conservation(got.counters)


def test_traced_chunked_replay_matches_jax():
    sig = _signals(len(ACTIVE))
    got, want = _traced_pair(ACTIVE, "DEMS-COOP", sig, chunk_ticks=7)
    _assert_result_match(got, want)
    whole = F.run_fleet(ACTIVE, "DEMS-COOP", port_signals(sig),
                        trace=FULL[1], device="cpu")
    for a, b in zip(jax.tree.leaves(convert.to_numpy(whole)),
                    jax.tree.leaves(convert.to_numpy(got))):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("policy", ["DEMS-COOP", "GEMS-A"])
def test_trace_on_and_off_give_bitwise_equal_states(policy):
    models = WL1 if policy.startswith("GEMS") else ACTIVE
    sig = port_signals(_signals(len(models), duration_ms=1_000.0))
    off = F.run_fleet(models, policy, sig, device="cpu")
    for spec in (TTR.TraceSpec.full(), TTR.TraceSpec(counters=True),
                 TTR.TraceSpec(t_hat=True)):
        on = F.run_fleet(models, policy, sig, trace=spec, device="cpu")
        assert (on.t_hat is None) != spec.t_hat
        assert (on.counters is None) != spec.counters
        for a, b in zip(jax.tree.leaves(convert.to_numpy(off)),
                        jax.tree.leaves(convert.to_numpy(on.final))):
            np.testing.assert_array_equal(a, b)
    alias = F.run_fleet(models, policy, sig, record_trace=True,
                        device="cpu")
    assert alias.counters is None
    assert alias.t_hat.shape == (40, 2, len(models))


def test_traced_scenario_matches_jax_within_adjacent_bins():
    """A registry scenario with sampled durations through both packages'
    ``run_scenario_fleet``: the histograms may move by adjacent bins,
    every other leaf is held as everywhere else."""
    want = j_run_scenario(jget("duration-jitter", duration_ms=2_000.0),
                          "DEMS-COOP", trace=FULL[0])
    got = run_scenario_fleet(tget("duration-jitter", duration_ms=2_000.0),
                             "DEMS-COOP", trace=FULL[1], device="cpu")
    _assert_result_match(got, want, hist_adjacent=True)
    TM.check_conservation(got.counters)

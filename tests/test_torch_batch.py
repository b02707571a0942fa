"""The port's replica axis and batched sweep against ``repro.sim.fleet_jax``
and ``repro.scenarios``, and against the port's own per-run path.

Tolerance: the arrays that build a batch (signals, tables, flags, initial
state) are held bitwise to the JAX ones, with the same error messages.
A lane of a batch is held bitwise to the port's own ``run_fleet`` on that
run (every leaf, cut to the run's own edges, models and pool slots), and
the two sweep planners' rows bitwise to each other.  Against the JAX
package: integer summary fields, counters and digests exactly, float
leaves to rtol 1e-6 / atol 1e-4 (``_torch_parity``; exact equality
expected).  The sweep rows in ``tests/golden/torch_port_sweep.json`` come
from the JAX package on the CPU; a subset (a flattened 1-edge bucket and
a COOP multi-edge one) is held to them here, all of them by
``chip_smoke.py`` on the card.
"""
import dataclasses
import json
import math
import pathlib

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import (ATOL, RTOL, assert_counters_match,  # noqa: E402
                           assert_signals_equal, assert_states_match,
                           port_signals)
from repro.core import task as JT  # noqa: E402
from repro.obs.trace import TraceSpec as JTS  # noqa: E402
from repro.scenarios import compile as JC  # noqa: E402
from repro.scenarios import get as jget  # noqa: E402
from repro.scenarios import runner as JR  # noqa: E402
from repro.sim import fleet_jax as FJ  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.obs import metrics as TM  # noqa: E402
from repro_torch.obs.trace import TraceSpec  # noqa: E402
from repro_torch.scenarios import compile as TC  # noqa: E402
from repro_torch.scenarios import runner as TR  # noqa: E402
from repro_torch.scenarios.registry import get as tget  # noqa: E402
from repro_torch.sim import fleet as F  # noqa: E402

GOLDEN = pathlib.Path(__file__).parent / "golden" / "torch_port_sweep.json"
FULL = TraceSpec.full()
# state leaves whose last axis is the model axis; the estimator buffer
# has it second to last
_MODEL_LAST = {"n_success", "n_miss", "n_drop", "n_stolen", "n_edge_exec",
               "lam", "lam_hat", "prev_lam", "win_end", "windows_met",
               "count", "idx", "current", "cooling_start"}


def _cut(tree, e, m, s, prefix=()):
    """A lane's leaves cut to its own edges ``e``, models ``m`` and pool
    slots ``s`` (``tree``: one replica, leaves ``[E, …]``)."""
    if isinstance(tree, tuple):
        return [x for name, v in zip(tree._fields, tree)
                for x in _cut(v, e, m, s, prefix + (name,))]
    a = np.asarray(tree)[:e]
    name = prefix[-1]
    if name in _MODEL_LAST:
        a = a[..., :m]
    elif name == "buf":
        a = a[..., :m, :]
    elif name == "cloud_busy_until":
        a = a[..., :s]
    return [(".".join(prefix), a)]


def _assert_lane_equals(lane, own, e, m, s):
    for (name, g), (_, w) in zip(_cut(lane, e, m, s), _cut(own, e, m, s)):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_array_equal(g, w, err_msg=name)


def _jax_sig(name, ms, seed=0):
    return JC.compile_fleet(jget(name, duration_ms=ms, seed=seed))


def _port_sig(name, ms, seed=0):
    return TC.compile_fleet(tget(name, duration_ms=ms, seed=seed),
                            device="cpu")


# the heterogeneous batch: 1 edge × 4 models, 3 edges × 6 models
# (cooperative), a 2-slot pool; horizons 2 s and 1 s (a padded tail)
RUNS = (("baseline", "DEMS", 2_000.0), ("roaming-vips", "DEMS-COOP", 2_000.0),
        ("cloud-crunch", "GEMS-A", 1_000.0))


def _runs(port: bool):
    get, sig = (tget, _port_sig) if port else (jget, _jax_sig)
    return [(get(n).models, pol, sig(n, ms), get(n).cloud_concurrency)
            for n, pol, ms in RUNS]


# ---------------------------------------------------------------------------
# stacking, padding, batch building, bucket planning
# ---------------------------------------------------------------------------

def test_stack_signals_and_compile_fleet_batch_match_jax():
    spec_j, spec_t = jget("churn", duration_ms=1_000.0), \
        tget("churn", duration_ms=1_000.0)
    assert_signals_equal(TC.compile_fleet_batch(spec_t, (0, 3),
                                                device="cpu"),
                         JC.compile_fleet_batch(spec_j, (0, 3)))
    msgs = []
    for mod, sig in ((F, _port_sig), (FJ, _jax_sig)):
        with pytest.raises(ValueError) as err:
            mod.stack_signals([sig("baseline", 1_000.0),
                               sig("rush-hour", 1_000.0)])
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1] and "'theta'" in msgs[0]


def test_pad_signals_matches_jax():
    got = F.pad_signals([s for _, _, s, _ in _runs(True)], device="cpu")
    want = FJ.pad_signals([s for _, _, s, _ in _runs(False)])
    assert_signals_equal(got, want)
    assert tuple(got.arrive.shape) == (3, 80, 3, 6)
    assert not got.valid[2, 40:].any() and not got.valid[0, :, 1:].any()


def test_build_fleet_batch_and_plan_buckets_match_jax():
    got = F.build_fleet_batch(_runs(True), device="cpu")
    want = FJ.build_fleet_batch(_runs(False))
    assert got.coop_rounds == want.coop_rounds == 2
    for cls, g, w in ((F.Profiles, got.profiles, want.profiles),
                      (F.PolicyParams, got.params, want.params)):
        for name, a, b in zip(cls._fields, convert.to_numpy(g), w):
            b = np.asarray(b)
            assert a.dtype == b.dtype and a.shape == b.shape, name
            np.testing.assert_array_equal(a, b, err_msg=name)
    assert_states_match(got.state, want.state)
    assert_signals_equal(got.signals, want.signals)
    # exact-shape buckets: the same partition, lanes and shapes
    runs_t, runs_j = _runs(True) * 2, _runs(False) * 2
    runs_t[4] = runs_t[4][:1] + ("SJF-E+C",) + runs_t[4][2:]
    runs_j[4] = runs_j[4][:1] + ("SJF-E+C",) + runs_j[4][2:]
    bt = F.plan_buckets(runs_t, device="cpu")
    bj = FJ.plan_buckets(runs_j)
    assert [idxs for _, idxs in bt] == [idxs for _, idxs in bj]
    for (b1, _), (b2, _) in zip(bt, bj):
        assert b1.coop_rounds == b2.coop_rounds
        for f, a, b in zip(F.FleetSignals._fields, b1.signals, b2.signals):
            assert tuple(a.shape) == np.asarray(b).shape, f
    msgs = []
    for mod, runs in ((F, _runs(True)), (FJ, _runs(False))):
        pol = dataclasses.replace(mod.FleetPolicy.from_name("DEMS-A"),
                                  adapt_window=4)
        bad = runs[:1] + [runs[1][:1] + (pol,) + runs[1][2:]]
        kw = dict(device="cpu") if mod is F else {}
        with pytest.raises(ValueError) as err:
            mod.build_fleet_batch(bad, **kw)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1] and "adapt_window" in msgs[0]


# ---------------------------------------------------------------------------
# a batch's lanes against the port's own per-run path
# ---------------------------------------------------------------------------

def test_run_batch_lanes_equal_run_fleet_bitwise():
    batch = F.build_fleet_batch(_runs(True), device="cpu")
    res = F.run_batch(batch, trace=FULL)
    chunked = F.run_batch(batch, trace=FULL, chunk_ticks=11)
    for a, b in zip(jax.tree.leaves(convert.to_numpy(res)),
                    jax.tree.leaves(convert.to_numpy(chunked))):
        np.testing.assert_array_equal(a, b)
    for r, (models, pol, sig, slots) in enumerate(_runs(True)):
        own = F.run_fleet(models, pol, sig, cloud_slots=slots, trace=FULL,
                          device="cpu")
        t, e, m = sig.arrive.shape
        _assert_lane_equals(
            jax.tree.map(lambda a: a[r], convert.to_numpy(res.final)),
            convert.to_numpy(own.final), e, m, slots)
        for name, g, w in zip(own.counters._fields, res.counters,
                              own.counters):
            g = g[r, :t, :e].numpy()
            if name in TM.PER_MODEL_FIELDS:
                g = g[..., :m]
            np.testing.assert_array_equal(g, w.numpy(), err_msg=name)
        np.testing.assert_array_equal(res.t_hat[r, :t, :e, :m].numpy(),
                                      own.t_hat.numpy())
        TM.check_conservation(TM.select_replica(res.counters, r))


def test_run_fleet_batch_matches_jax_and_lanes_equal_run_fleet():
    models = [JT.TABLE1[n] for n in JT.ACTIVE]
    sig_j = FJ.stack_signals([FJ.default_signals(
        len(models), n_edges=2, drones_per_edge=4, duration_ms=1_000.0,
        seed=s) for s in (0, 5)])
    want = FJ.run_fleet_batch(models, "DEMS-COOP", sig_j,
                              trace=JTS.full())
    sig_t = port_signals(sig_j)
    got = F.run_fleet_batch(models, "DEMS-COOP", sig_t, trace=FULL,
                            device="cpu")
    assert_states_match(got.final, want.final)
    assert_counters_match(got.counters, want.counters)
    np.testing.assert_array_equal(got.t_hat.numpy(), np.asarray(want.t_hat))
    assert TR.fleet_summary_batch(got.final) == \
        JR.fleet_summary_batch(jax.tree.map(np.asarray, want.final))
    own = F.run_fleet(models, "DEMS-COOP", F.FleetSignals(
        *(a[1] for a in sig_t)), trace=FULL, device="cpu")
    for a, b in zip(jax.tree.leaves(convert.to_numpy(own)),
                    jax.tree.leaves(convert.to_numpy(jax.tree.map(
                        lambda x: x[1], got)))):
        np.testing.assert_array_equal(a, b)


def test_run_scenario_fleet_batch_matches_jax():
    want = JR.run_scenario_fleet_batch(jget("baseline", duration_ms=1_000.0),
                                       "DEMS", (0, 2))
    got = TR.run_scenario_fleet_batch(tget("baseline", duration_ms=1_000.0),
                                      "DEMS", (0, 2), device="cpu")
    assert TR.fleet_summary_batch(got) == \
        JR.fleet_summary_batch(jax.tree.map(np.asarray, want))
    assert_states_match(got, want)


# ---------------------------------------------------------------------------
# the sweep: lowering, planners, JAX rows, goldens
# ---------------------------------------------------------------------------

def test_registry_lowerings_match_jax():
    kw = dict(duration_ms=1_000.0)
    scen = ("baseline", "roaming-vips", "cloud-crunch")
    for pols in (("DEMS", "SJF-E+C"), ("DEMS", "DEMS-COOP")):
        bt, rows_t = TC.compile_registry_batch(scen, pols, (0,),
                                               device="cpu", **kw)
        bj, rows_j = JC.compile_registry_batch(scen, pols, (0,), **kw)
        assert [dataclasses.astuple(r) for r in rows_t] == \
            [dataclasses.astuple(r) for r in rows_j]
        assert_signals_equal(bt.signals, bj.signals)
        gt = TC.compile_registry_groups(scen, pols, (0,), device="cpu",
                                        **kw)
        gj = JC.compile_registry_groups(scen, pols, (0,), **kw)
        assert [[dataclasses.astuple(r) for r in rows] for _, rows in gt] \
            == [[dataclasses.astuple(r) for r in rows] for _, rows in gj]
        for (b1, _), (b2, _) in zip(gt, gj):
            assert_signals_equal(b1.signals, b2.signals)


def _row_key(row, n_edges, n_models):
    """What two planners' rows must share bitwise."""
    tr = row["trace"]
    return (
        {k: v for k, v in row.items() if k != "trace"},
        json.dumps(TM.tail_metrics(tr.counters, FULL)),
        TM.stream_digests(tr.counters, n_edges, n_models),
        TM.stream_digests(tr.counters._replace(
            slack_hist=tr.counters.hit, latency_hist=tr.counters.hit)),
        tr.t_hat[:, :n_edges, :n_models].tobytes())


def test_planners_rows_bitwise_equal_and_match_jax():
    scen = ("baseline", "rush-hour", "cloud-crunch")
    pols = ("DEMS", "DEMS-COOP")
    kw = dict(duration_ms=2_000.0, trace=FULL, device="cpu")
    bucketed = TR.run_registry_sweep(scen, pols, (0,), planner="bucketed",
                                     **kw)
    padded = TR.run_registry_sweep(scen, pols, (0,), planner="padded", **kw)
    jrows = JR.run_registry_sweep(scen, pols, (0,), duration_ms=2_000.0,
                                  trace=JTS.full())
    assert len(bucketed) == len(padded) == len(jrows) == 6
    for b, p, j in zip(bucketed, padded, jrows):
        sc = tget(b["scenario"])
        e, m = sc.n_edges, len(sc.model_names)
        # histogram digests are compared through the per-field sums
        kb, kp = _row_key(b, e, m), _row_key(p, e, m)
        assert kb[:3] == kp[:3] and kb[4] == kp[4]
        assert TM.stream_sums(b["trace"].counters) == \
            TM.stream_sums(p["trace"].counters)
        for f in ("slack_hist", "latency_hist"):
            np.testing.assert_array_equal(
                getattr(b["trace"].counters, f),
                getattr(p["trace"].counters, f)[:, :e])
        ours = {k: v for k, v in b.items() if k != "trace"}
        ref = {k: v for k, v in j.items() if k != "trace"}
        assert ours == ref
        assert kb[1] == json.dumps(TM.tail_metrics(
            jax.tree.map(np.asarray, j["trace"].counters), FULL))
        TM.check_conservation(b["trace"].counters)
    with pytest.raises(ValueError, match="planner"):
        TR.run_registry_sweep(("baseline",), planner="sorted", device="cpu")


def _close(got, want, path=""):
    """A golden value: ints exactly, floats to RTOL/ATOL, None = NaN."""
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _close(got[k], want[k], f"{path}.{k}")
    elif want is None:
        assert isinstance(got, float) and math.isnan(got), path
    elif isinstance(want, float):
        assert abs(got - want) <= ATOL + RTOL * abs(want), (path, got, want)
    else:
        assert got == want, (path, got, want)


def test_sweep_rows_match_the_golden_subset():
    gold = json.loads(GOLDEN.read_text())
    scen, pols = ("rush-hour",), ("DEMS", "DEMS-COOP")
    rows = TR.run_registry_sweep(
        scen, pols, tuple(gold["seeds"]), dt=gold["dt"],
        duration_ms=gold["duration_ms"], planner="bucketed", device="cpu",
        trace=TraceSpec.full(
            hist_bins=gold["hist_bins"], hist_max_ms=gold["hist_max_ms"]))
    want = {(r["scenario"], r["policy"]): r for r in gold["rows"]}
    assert len(gold["rows"]) == 56 and len(gold["seed_batch"]["lanes"]) == 4
    for row in rows:
        w = want[row["scenario"], row["policy"]]
        c = row["trace"].counters
        _close({k: v for k, v in row.items()
                if k not in ("scenario", "policy", "seed", "trace")},
               w["summary"])
        _close(TM.tail_metrics(c, FULL), w["tail"])
        _close(TM.stream_sums(c), w["sums"])
        assert TM.stream_digests(c, w["n_edges"], w["n_models"]) == \
            w["digests"]
        TM.check_conservation(c)

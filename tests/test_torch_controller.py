"""The port's online control plane against the JAX package's, on the CPU:
``FleetController``, ``drive_stream``, the streaming runners, the
checkpoint format and ``launch/serve.py --backend fleet``, case for case
with ``tests/test_controller.py``.

Streaming a scenario window by window equals its replay bitwise in the
port; the port's streamed state, decision records and snapshot equal the
JAX controller's on the same telemetry; a checkpoint written by the JAX
controller restores into the port's and finishes as the JAX controller's
uninterrupted run.  Each JAX run is computed once per module.
"""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.scenarios.registry import get as jget
from repro.scenarios.runner import stream_scenario_fleet as jstream
from repro.serve.controller import FleetController as JController
from repro.train import checkpoint as jckpt
from repro_torch.obs.trace import TraceSpec
from repro_torch.scenarios.compile import compile_fleet
from repro_torch.scenarios.registry import get
from repro_torch.scenarios.runner import (assert_streaming_equivalence,
                                          fleet_summary, run_scenario_fleet,
                                          stream_scenario_fleet)
from repro_torch.serve.controller import FleetController, drive_stream
from repro_torch.sim import fleet as F
from repro_torch.train import checkpoint as ckpt

from _torch_parity import assert_states_match

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STREAM_CASES = [
    ("baseline", "DEMS-A", 16),
    ("rush-hour", "GEMS", 7),          # ragged final window
    ("flaky-cloud", "DEMS-COOP", 13),  # cooperative peer offload
]
# metrics_snapshot fields read from the wall clock
WALL_FIELDS = ("step_latency_ms", "ingest_to_decision_ms")
# the port's fields the reference has not: the span table's rows and the
# counters (repro_torch.obs.prof)
TABLE_FIELDS = ["spans", "counters"]


def _changed(a, b) -> list:
    """Names of EdgeState fields whose leaves differ bitwise."""
    return [name for name, x, y in zip(F.EdgeState._fields, a, b)
            if not all(torch.equal(u, v)
                       for u, v in zip(F._leaves(x), F._leaves(y)))]


def _ctl(spec, policy="DEMS-A", **kw):
    kw.setdefault("n_edges", 2)
    kw.setdefault("window_ticks", 8)
    return FleetController(spec.models, policy, device="cpu", **kw)


def _feed(ctl, lo_ms: float, hi_ms: float, n_models: int) -> None:
    """Deterministic synthetic telemetry stream over [lo_ms, hi_ms) (the
    reference test's)."""
    t = int(lo_ms)
    while t < hi_ms:
        ctl.submit(float(t), t % ctl.n_edges, (t // 40) % n_models)
        if t % 400 == 0:
            ctl.observe_bandwidth(float(t), 18.0 + (t % 1200) / 100.0,
                                  edge=0)
        if t % 1000 == 0:
            ctl.observe_theta(float(t), float(t % 3000) / 20.0)
        t += 40


# ---------------------------------------------------------------------------
# module fixtures: each run once


@pytest.fixture(scope="module")
def streams():
    """Per case: the port's replay state and streaming controller."""
    out = {}
    for scenario, policy, window in STREAM_CASES:
        spec = get(scenario, duration_ms=5000)
        out[scenario] = (run_scenario_fleet(spec, policy, device="cpu"),
                         stream_scenario_fleet(spec, policy,
                                               window_ticks=window,
                                               device="cpu"))
    return out


@pytest.fixture(scope="module")
def live(tmp_path_factory):
    """The reference test's live stream (DEMS-A, 2 edges, windows of 8,
    6 s) through the JAX controller uninterrupted and the port's, and a
    JAX controller checkpointed at 3 s."""
    spec = jget("baseline", duration_ms=6000)
    m = len(spec.models)
    jax_ctl = JController(spec.models, "DEMS-A", n_edges=2, window_ticks=8)
    _feed(jax_ctl, 0, 6000, m)
    jax_ctl.poll(6000.0)
    jax_ctl.close()
    path = str(tmp_path_factory.mktemp("jax_ckpt") / "ck")
    killed = JController(spec.models, "DEMS-A", n_edges=2, window_ticks=8,
                         checkpoint_path=path)
    _feed(killed, 0, 3000, m)
    killed.poll(3000.0)
    killed.checkpoint()
    port = _ctl(get("baseline", duration_ms=6000))
    _feed(port, 0, 6000, m)
    port.poll(6000.0)
    port.close()
    return dict(jax=jax_ctl, port=port, path=path, kill_tick=killed.tick)


# ---------------------------------------------------------------------------
# replay-vs-streaming equivalence


@pytest.mark.parametrize("scenario,policy,window", STREAM_CASES)
def test_streaming_matches_replay_bitwise(streams, scenario, policy,
                                          window):
    ref, ctl = streams[scenario]
    assert ctl.windows_run == -(-200 // window)
    assert _changed(ref, ctl.state) == []


@pytest.mark.parametrize("scenario,policy,window", STREAM_CASES)
def test_streamed_state_matches_the_jax_controller(streams, scenario,
                                                   policy, window):
    want = jstream(jget(scenario, duration_ms=5000), policy,
                   window_ticks=window)
    assert_states_match(streams[scenario][1].state, want.state)


def test_streaming_equivalence_hook_detects_drift(streams):
    # the hook must bite: perturb the streamed state and expect the
    # field to be named
    spec = get("baseline", duration_ms=1000)
    assert assert_streaming_equivalence(spec, "DEMS", device="cpu") == \
        fleet_summary(run_scenario_fleet(spec, "DEMS", device="cpu"))
    ref, ctl = streams["baseline"]
    bad = ctl.state._replace(n_success=ctl.state.n_success + 1)
    assert _changed(ref, bad) == ["n_success"]


def test_streamed_decisions_conserve_arrivals():
    spec = get("rush-hour", duration_ms=3000)
    sig = compile_fleet(spec, device="cpu")
    ctl = _ctl(spec, n_edges=spec.n_edges, window_ticks=16,
               cloud_slots=spec.cloud_concurrency)
    T = int(sig.times.shape[0])
    recs = []
    for lo in range(0, T, 16):
        recs.extend(ctl.step_signals(F.slice_signals(sig, lo,
                                                     min(lo + 16, T))))
    assert len(recs) == T
    assert sum(r["arrivals"] for r in recs) == int(sig.arrive.sum())
    s = ctl.summary()
    assert sum(r["hit"] for r in recs) == s["completed"]
    assert sum(r["drop"] for r in recs) == s["dropped"]


# ---------------------------------------------------------------------------
# the live stream against the JAX controller


def test_live_state_matches_the_jax_controller(live):
    assert_states_match(live["port"].state, live["jax"].state)
    assert live["port"].summary() == pytest.approx(live["jax"].summary())


def test_decision_records_match_the_jax_controller(live):
    got, want = list(live["port"].decisions), list(live["jax"].decisions)
    assert len(got) == len(want) == 240
    for g, w in zip(got, want):
        assert g == w


def test_metrics_snapshot_matches_the_jax_controller(live):
    got = live["port"].metrics_snapshot()
    want = live["jax"].metrics_snapshot()
    assert list(got) == list(want) + TABLE_FIELDS
    assert {"ctl.poll", "ctl.step", "fleet.window"} <= set(got["spans"])
    assert got["counters"]["ctl.submitted"] > 0
    for key in want:
        if key in WALL_FIELDS:
            assert list(got[key]) == list(want[key])
            assert got[key]["p50"] is not None
        elif isinstance(want[key], float):
            assert got[key] == pytest.approx(want[key], rel=1e-6), key
        else:
            assert got[key] == want[key], key
    for key in ("now_ms", "tick", "policy", "completed", "missed",
                "dropped", "completion_rate", "step_latency_ms",
                "ingest_to_decision_ms", "eq_depth", "cq_depth",
                "slots_busy", "latency_ms", "slack_ms", "windows_run"):
        assert key in got, key
    assert got["windows_run"] == 30


def test_jax_checkpoint_restores_into_the_port(live):
    spec = get("baseline", duration_ms=6000)
    c = _ctl(spec, checkpoint_path=live["path"])
    tick = c.restore()
    assert tick == live["kill_tick"] == 120
    _feed(c, tick * 25.0, 6000, len(spec.models))
    c.poll(6000.0)
    c.close()
    assert_states_match(c.state, live["jax"].state)
    assert c.summary() == pytest.approx(live["jax"].summary())


def test_checkpoint_file_format_matches_the_reference(tmp_path):
    # the same tree written by both packages: the same leaves, in order
    spec = get("baseline", duration_ms=1000)
    ctl = _ctl(spec, trace=TraceSpec())
    _feed(ctl, 0, 1000, len(spec.models))
    ctl.poll(1000.0)
    tree = ctl._ckpt_tree(ctl.state, ctl.tick)
    ckpt.save(str(tmp_path / "port"), tree)
    jstate = JController(jget("baseline", duration_ms=1000).models,
                         "DEMS-A", n_edges=2).state
    jckpt.save(str(tmp_path / "jax"), dict(tree, state=jax.tree.unflatten(
        jax.tree.structure(jstate),
        [a.numpy() for a in F._leaves(ctl.state)])))
    got = np.load(str(tmp_path / "port.npz"))
    want = np.load(str(tmp_path / "jax.npz"))
    assert sorted(got.files) == sorted(want.files)
    for k in want.files:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    meta = json.load(open(str(tmp_path / "port.tree.json")))
    assert meta["n"] == len(want.files)
    with pytest.raises(ValueError, match="shape mismatch"):
        ckpt.load(str(tmp_path / "port"),
                  dict(tree, dedupe_ids=np.zeros(3, np.int64)))


# ---------------------------------------------------------------------------
# live ingestion + checkpoint/restore


def test_checkpoint_roundtrip(tmp_path):
    spec = get("baseline", duration_ms=3000)
    path = os.path.join(tmp_path, "ck")
    ctl = _ctl(spec, checkpoint_path=path)
    _feed(ctl, 0, 3000, len(spec.models))
    ctl.poll(3000.0)
    ctl.checkpoint()
    assert os.path.exists(path + ".npz")
    assert os.path.exists(path + ".tree.json")

    fresh = _ctl(spec, checkpoint_path=path)
    assert _changed(fresh.state, ctl.state) != []   # actually moved
    tick = fresh.restore()
    assert tick == ctl.tick
    assert _changed(fresh.state, ctl.state) == []
    assert all(a.dtype == b.dtype for a, b in
               zip(F._leaves(fresh.state), F._leaves(ctl.state)))
    assert fresh.summary() == ctl.summary()


def test_kill_restore_resumes_identically(tmp_path, live):
    # killed mid-run and restored from its own checkpoint, the port's
    # controller finishes bitwise as its uninterrupted run
    spec = get("baseline", duration_ms=6000)
    m = len(spec.models)
    path = os.path.join(tmp_path, "ck")
    b = _ctl(spec, checkpoint_path=path)
    _feed(b, 0, 3000, m)
    b.poll(3000.0)
    b.checkpoint()
    killed_at = b.tick
    del b                                   # the crash

    c = _ctl(spec, checkpoint_path=path)
    tick = c.restore()
    assert tick == killed_at
    # upstream replays telemetry from the checkpoint tick (the
    # at-least-once ingestion contract)
    _feed(c, tick * 25.0, 6000, m)
    c.poll(6000.0)
    c.close()
    assert _changed(live["port"].state, c.state) == []
    assert c.summary() == live["port"].summary()


def test_periodic_checkpointing(tmp_path):
    spec = get("baseline", duration_ms=1000)
    path = os.path.join(tmp_path, "auto")
    ctl = _ctl(spec, policy="DEMS", checkpoint_path=path,
               checkpoint_every=2, trace=TraceSpec())
    _feed(ctl, 0, 1000, len(spec.models))
    ctl.poll(1000.0)
    assert ctl.windows_run == 5
    assert ctl.checkpoints_written == 2
    assert os.path.exists(path + ".npz")


def test_kill_restore_mid_crash_window_bitwise(tmp_path):
    # checkpoint taken inside an active EdgeCrash window, restore, finish:
    # bitwise the uninterrupted streamed run
    from repro_torch.faults import EdgeCrash, FaultSpec

    spec = dataclasses.replace(
        get("baseline", duration_ms=4000), name="crash-stream",
        faults=FaultSpec(crashes=(
            EdgeCrash(edge=0, start_ms=1500.0, end_ms=3500.0),)))
    sig = compile_fleet(spec, device="cpu")
    T = int(sig.times.shape[0])
    kw = dict(n_edges=spec.n_edges, window_ticks=16,
              cloud_slots=spec.cloud_concurrency, trace=TraceSpec())

    a = _ctl(spec, **kw)
    for lo in range(0, T, 16):
        a.step_signals(F.slice_signals(sig, lo, min(lo + 16, T)))

    path = os.path.join(tmp_path, "ck")
    b = _ctl(spec, checkpoint_path=path, **kw)
    kill_tick = 80                           # inside the crash window
    assert not bool(sig.edge_up[kill_tick, 0])
    for lo in range(0, kill_tick, 16):
        b.step_signals(F.slice_signals(sig, lo, lo + 16))
    b.checkpoint()
    del b

    c = _ctl(spec, checkpoint_path=path, **kw)
    assert c.restore() == kill_tick
    for lo in range(kill_tick, T, 16):
        c.step_signals(F.slice_signals(sig, lo, min(lo + 16, T)))
    assert _changed(a.state, c.state) == []
    assert c.summary() == a.summary()


# ---------------------------------------------------------------------------
# serve-facing surface


def test_poll_only_steps_complete_windows():
    ctl = _ctl(get("baseline", duration_ms=1000), policy="DEMS")
    ctl.submit(0.0, 0, 0)
    assert ctl.poll(100.0) == []            # 4 ticks < one 8-tick window
    assert ctl.tick == 0
    recs = ctl.poll(225.0)                  # 9 ticks -> one window steps
    assert ctl.tick == 8 and len(recs) == 8
    # the ragged remainder only flushes on close()
    ctl.submit(210.0, 0, 1)
    assert ctl.poll(225.0) == []
    assert len(ctl.close()) == 1


def test_drive_stream_virtual_time():
    spec = get("baseline", duration_ms=2000)
    ctl = _ctl(spec)
    fps = {m.name: 25.0 for m in spec.models[:2]}
    snap = drive_stream(ctl, fps, 2_000.0)
    expect = sum(int(np.ceil(2_000.0 * f / 1000.0)) for f in fps.values())
    # every frame was scheduled; some may still sit in a queue at close
    assert sum(r["arrivals"] for r in ctl.decisions) == expect
    settled = snap["completed"] + snap["missed"] + snap["dropped"]
    assert 0 < settled <= expect
    assert snap["now_ms"] == 2_000.0


def test_trace_off_controller_still_steps():
    spec = get("baseline", duration_ms=2000)
    ctl = _ctl(spec, policy="DEMS", trace=TraceSpec())
    _feed(ctl, 0, 2000, len(spec.models))
    assert ctl.poll(2000.0) == []           # no counters -> no records
    ctl.close()
    assert ctl.summary()["completed"] > 0
    assert "latency_ms" not in ctl.metrics_snapshot()


def test_entry_points_refuse_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    spec = get("baseline", duration_ms=1000)
    with pytest.raises(RuntimeError, match="CUDA"):
        FleetController(spec.models, "DEMS", n_edges=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        stream_scenario_fleet(spec, "DEMS")


# ---------------------------------------------------------------------------
# chaos hardening: backpressure, idempotent replay, restore under faults


def test_backpressure_reject_sheds_and_recovers():
    ctl = _ctl(get("baseline", duration_ms=1000), max_pending_ticks=16,
               shed_policy="reject")
    assert ctl.submit(0.0, 0, 0) == 0
    # a submission 16+ ticks past the emit cursor is shed, not buffered
    assert ctl.submit(16 * 25.0, 0, 0) == -1
    assert ctl.shed_tasks == 1
    assert ctl.builder.pending_ticks <= 16
    # polling advances the cursor and the same timestamp is admitted
    ctl.poll(16 * 25.0)
    assert ctl.submit(16 * 25.0, 0, 0) >= 0
    snap = ctl.metrics_snapshot()
    assert snap["shed_tasks"] == 1
    assert snap["shed_policy"] == "reject"
    assert snap["max_pending_ticks"] == 16


def test_backpressure_degrade_advances_instead_of_shedding():
    ctl = _ctl(get("baseline", duration_ms=1000), max_pending_ticks=16,
               shed_policy="degrade")
    assert ctl.submit(0.0, 0, 0) == 0
    # a far-future submission force-steps windows instead of rejecting
    assert ctl.submit(40 * 25.0, 0, 0) >= 0
    assert ctl.shed_tasks == 0
    assert ctl.degrade_windows > 0
    assert ctl.tick > 0
    assert ctl.builder.pending_ticks <= 16


def test_backpressure_config_validated():
    spec = get("baseline", duration_ms=1000)
    with pytest.raises(ValueError, match="shed_policy"):
        _ctl(spec, n_edges=1, shed_policy="panic")
    with pytest.raises(ValueError, match="max_pending_ticks"):
        _ctl(spec, n_edges=1, max_pending_ticks=4)


def test_duplicate_task_ids_are_idempotent(tmp_path):
    spec = get("baseline", duration_ms=1000)
    path = os.path.join(tmp_path, "ck")
    ctl = _ctl(spec, checkpoint_path=path)
    assert ctl.submit(100.0, 0, 0, task_id=7) >= 0
    assert ctl.submit(100.0, 0, 0, task_id=7) == -1
    assert ctl.duplicate_events == 1
    with pytest.raises(ValueError, match="task_id"):
        ctl.submit(0.0, 0, 0, task_id=-3)
    ctl.poll(1000.0)
    ctl.checkpoint()
    # the dedupe ring survives kill/restore: a replayed duplicate from
    # before the crash is still recognized afterwards
    fresh = _ctl(spec, checkpoint_path=path)
    fresh.restore()
    assert fresh.submit(100.0, 0, 0, task_id=7) == -1
    assert fresh.duplicate_events == 1
    assert fresh.submit(1050.0, 0, 0, task_id=8) >= 0
    assert fresh.metrics_snapshot()["duplicate_events"] == 1


def test_restore_under_duplicated_out_of_order_replay():
    # an at-least-once channel (duplicates + reordering) feeding a
    # controller that polls only at mission end lands in the bitwise
    # state of the exactly-once in-order twin
    from repro_torch.faults import TelemetryChaos
    from repro_torch.faults.compile import perturb_telemetry

    spec = get("baseline", duration_ms=2000)
    m = len(spec.models)
    events, tid, t = [], 0, 0
    while t < 2000:
        events.append((float(t), t % 2, (t // 40) % m, tid))
        tid += 1
        if t % 200 == 0:        # a second task in the same (tick, cell)
            events.append((float(t), t % 2, (t // 40) % m, tid))
            tid += 1
        t += 40
    a = _ctl(spec, trace=TraceSpec())
    for t, e, mi, tid in events:
        assert a.submit(t, e, mi, task_id=tid) >= 0
    a.poll(2000.0)
    a.close()

    replay = perturb_telemetry(events, TelemetryChaos(
        drop_p=0.0, dup_p=0.35, reorder_p=0.6, max_delay_ms=300.0, seed=2))
    assert len(replay) > len(events)        # duplicates really delivered
    assert [ev[3] for ev in replay] != [ev[3] for ev in events]
    b = _ctl(spec, trace=TraceSpec())
    for t, e, mi, tid in replay:
        b.submit(t, e, mi, task_id=tid)
    b.poll(2000.0)
    b.close()
    assert b.duplicate_events > 0
    assert _changed(a.state, b.state) == []
    assert b.summary() == a.summary()


# ---------------------------------------------------------------------------
# the launcher's fleet backend


def test_serve_launcher_fleet_backend_writes_the_snapshot(tmp_path, live):
    snap_path = tmp_path / "snap.json"
    ck = tmp_path / "ck"
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--backend",
         "fleet", "--device", "cpu", "--duration", "1", "--edges", "2",
         "--checkpoint", str(ck), "--snapshot-out", str(snap_path)],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")),
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    snap = json.load(open(snap_path))
    assert set(snap) == set(live["jax"].metrics_snapshot()) \
        | set(TABLE_FIELDS)
    assert snap["now_ms"] == 1000.0 and snap["policy"] == "GEMS"
    assert snap["checkpoints_written"] >= 1
    assert os.path.exists(str(ck) + ".npz")

"""What decides ``correct`` fails what it has to: the lower-precision
control, and a run whose timed path is broken underneath.  The harness
runs on the host here (its look for a card skipped) at a tiny size."""
import pytest
import torch

from portbench import calibrate
from portbench.harness import core, registry

from repro_torch.sim import fleet as F

BENCH = registry.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
COOP = [w["name"] for w in BENCH["workloads"]
        if registry.traffic(w["traffic"])["policy"].endswith("-COOP")]


def _tiny(name, n_edges=4, mission_ms=1_000.0):
    cell = registry.cell(BENCH, name)
    cfg = dict(registry.config(cell["config"]), n_edges=n_edges)
    mix = dict(registry.traffic(cell["traffic"]), mission_ms=mission_ms,
               mission_slots=1)
    return dict(config=cfg, mix=mix)


def _run(name, seed=17, seconds=0.05, **sizes):
    return core.run_cell(name, seed, seconds, False, device="cpu",
                         **_tiny(name, **sizes))


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    res = _run(cell)
    assert res["correct"] and res["failed"] == 0, res["checks"]
    assert all(c["limit"] == 0 for c in res["checks"].values())


@pytest.mark.parametrize("cell", CELLS)
def test_control_in_bfloat16_is_not_correct(cell):
    run, drv, sample = core.measure(cell, 23, 0.05, False, device="cpu",
                                    **_tiny(cell))
    row = calibrate._check(("control", run, run.mix["driver"], sample))
    assert not row["correct"], row
    assert calibrate._check(("program", run, run.mix["driver"],
                             sample))["correct"]


def _window_fault(monkeypatch, change):
    orig = F.TickProgram.window

    def broken(self, prof, pp, state, signals):
        state2, t_hat, counters = orig(self, prof, pp, state, signals)
        return change(state, state2), t_hat, counters

    monkeypatch.setattr(F.TickProgram, "window", broken)


def _half(old, new):
    keep = torch.arange(old.busy_rem.shape[-1]) < old.busy_rem.shape[-1] // 2
    return F._tree_where(keep, new, old)


def _altered(old, new):
    n = new.n_success.clone()
    n[0, 0] += 1
    return new._replace(n_success=n)


FAULTS = {
    "state_unchanged": lambda old, new: old,
    "half_the_edges_left_out": _half,
    "answer_altered": _altered,
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_broken_timed_path_is_not_correct(monkeypatch, cell, fault):
    _window_fault(monkeypatch, FAULTS[fault])
    res = _run(cell)
    assert not res["correct"] and res["failed"] > 0, res["checks"]


@pytest.mark.parametrize("cell", COOP)
def test_exchange_left_out_is_not_correct(monkeypatch, cell):
    monkeypatch.setattr(F, "peer_offload", lambda fs, *a, **k: fs)
    # a whole mission long enough for exports (the replay runs one at the
    # least, the stream as many polls as the seconds allow)
    res = _run(cell, seed=29, seconds=8.0, n_edges=8, mission_ms=3_000.0)
    assert not res["correct"], res["checks"]


@pytest.mark.cuda
def test_control_on_the_card(card):
    """The control at a small size on the card: the program's check
    passes, the control's fails (the cell sizes run by
    ``portbench/calibrate.py``)."""
    for cell in CELLS:
        run, drv, sample = core.measure(cell, 31, 0.05, False, device=card,
                                        **_tiny(cell))
        assert calibrate._check(("program", run, run.mix["driver"],
                                 sample))["correct"]
        assert not calibrate._check(("control", run, run.mix["driver"],
                                     sample))["correct"]

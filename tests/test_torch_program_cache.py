"""The port's tick-program cache, the counterpart of
``tests/test_compile_cache.py``, on the CPU.

* **shape keys** — a sweep over N distinct shape buckets records exactly
  N shape keys (one CUDA graph each on the card; the tick program is
  policy-generic and shape-keyed), and re-running it records none;
* **bounded program cache** — ``_fleet_program`` is an LRU of capacity
  ``FLEET_PROGRAM_CACHE_CAPACITY`` that evicts beyond it and returns a
  cached program by identity;
* **donate** — the in-place carry gives bitwise the undonated results,
  the caller's initial state survives ``run``, and the traced streams of
  consecutive windows are distinct tensors;
* **the recorded body** — what a graph records (the window body on
  static buffers and, donated, the carry written back into them), called
  eagerly on the CPU, equals ``step_chunk`` bitwise window by window;
* **the replay** — ``TickProgram._replay`` over a stand-in graph that
  runs the recorded body: two donated streams of one shape interleaved
  stay apart, and profiles and params are read anew when they change.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import task
from repro_torch.obs import prof
from repro_torch.obs.trace import TraceSpec
from repro_torch.sim import fleet as F

MODELS = [task.TABLE1[n] for n in task.ACTIVE]


@pytest.fixture(autouse=True)
def _fresh_programs():
    """Count shape keys from zero and leave no programs behind."""
    prof.reset_fleet_programs()
    yield
    prof.reset_fleet_programs()


def _equal(a, b) -> bool:
    la, lb = F._leaves(a), F._leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


def _coop_setup(n_edges=3, ticks=30, trace=TraceSpec(), donate=False):
    pol = F.FleetPolicy.from_name("DEMS-COOP")
    prog = F.FleetProgram.for_policy(pol, trace=trace, donate=donate)
    pr = F.Profiles.build(MODELS, "cpu")
    sig = F.default_signals(len(MODELS), n_edges=n_edges,
                            duration_ms=ticks * 25.0, seed=3, device="cpu")
    return prog, pr, pol.params("cpu"), prog.init(pr, pol, n_edges), sig


def test_three_bucket_sweep_records_three_shape_keys():
    from repro_torch.scenarios.runner import run_registry_sweep

    # baseline (1 edge, PASSIVE), rush-hour (2 edges, PASSIVE) and
    # roaming-vips (3 edges, ACTIVE) land in three distinct coop buckets
    # under GEMS-COOP: three exact shapes, each run in whole windows
    scenarios = ("baseline", "rush-hour", "roaming-vips")
    ticks = 2 * F.RUN_WINDOW_TICKS
    rows = run_registry_sweep(scenarios, ("GEMS-COOP",), (0,),
                              duration_ms=ticks * 25.0, planner="bucketed",
                              device="cpu")
    assert [r["scenario"] for r in rows] == list(scenarios)
    stats = prof.fleet_compile_stats()
    assert stats.programs == 1 and stats.traces == 3, stats
    assert not stats.policy_generic      # one program saw three shapes

    # the identical sweep again: every window's shape is already keyed
    rerun = run_registry_sweep(scenarios, ("GEMS-COOP",), (0,),
                               duration_ms=ticks * 25.0, planner="bucketed",
                               device="cpu")
    assert rerun == rows
    assert prof.fleet_compile_stats().traces == 3


def test_policies_share_a_shape_key():
    # policies are runtime data: more policies through one shape add no
    # key; a horizon that RUN_WINDOW_TICKS does not divide is still one
    # key, the whole horizon's, as the reference traces it once
    for ticks in (10, 2 * F.RUN_WINDOW_TICKS + 5):
        prof.reset_fleet_programs()
        sig = F.default_signals(len(MODELS), n_edges=2,
                                duration_ms=ticks * 25.0, device="cpu")
        for pol in ("DEMS", "GEMS", "DEMS-A", "SJF-E+C"):
            F.run_fleet(MODELS, pol, sig, device="cpu")
        stats = prof.fleet_compile_stats()
        assert (stats.programs, stats.traces) == (1, 1), ticks
        assert stats.policy_generic
    # explicit windows key each window shape, a ragged tail its own
    F.run_fleet(MODELS, "DEMS", sig, chunk_ticks=F.RUN_WINDOW_TICKS,
                device="cpu")
    assert prof.fleet_compile_stats().traces == 3


def test_program_cache_evicts_beyond_capacity(monkeypatch):
    monkeypatch.setattr(F, "FLEET_PROGRAM_CACHE_CAPACITY", 2)
    progs = [F._fleet_program(dt, 0.62, 0.80, 0, TraceSpec(), False)
             for dt in (11.0, 13.0, 17.0)]
    stats = prof.fleet_compile_stats()
    assert stats.capacity == 2
    assert stats.programs == 2
    assert stats.evictions == 1
    assert progs[0] not in F._PROGRAM_REGISTRY
    # the newest entry survived and is returned by identity on re-request
    assert F._fleet_program(17.0, 0.62, 0.80, 0, TraceSpec(),
                            False) is progs[-1]
    # 11.0 was the LRU casualty: re-requesting it builds a fresh program
    assert F._fleet_program(11.0, 0.62, 0.80, 0, TraceSpec(),
                            False) is not progs[0]
    assert prof.fleet_compile_stats().evictions == 2


def test_cache_clear_resets_registry_and_evictions(monkeypatch):
    monkeypatch.setattr(F, "FLEET_PROGRAM_CACHE_CAPACITY", 1)
    F._fleet_program(19.0, 0.62, 0.80, 0, TraceSpec(), False)
    F._fleet_program(23.0, 0.62, 0.80, 0, TraceSpec(), True)
    assert prof.fleet_compile_stats().programs == 1
    assert prof.fleet_compile_stats().evictions == 1
    prof.reset_fleet_programs()
    stats = prof.fleet_compile_stats()
    assert (stats.programs, stats.traces, stats.evictions) == (0, 0, 0)
    assert F._PROGRAM_CACHE == {}


def test_statics_are_the_cache_key():
    a = F.FleetProgram(dt=25.0, coop_rounds=2)
    assert a._program is F.FleetProgram(dt=25.0, coop_rounds=2)._program
    assert a._program is not F.FleetProgram(dt=25.0, coop_rounds=2,
                                            donate=True)._program
    assert a._program is not F.FleetProgram(
        dt=25.0, coop_rounds=2, trace=TraceSpec(counters=True))._program
    assert F.FleetProgram.for_policy("DEMS-COOP", donate=True).donate


def test_compile_counter_counts_no_capture_on_the_host():
    with prof.CompileCounter() as cc:
        _, pr, pp, state, sig = _coop_setup(ticks=4)
        F.FleetProgram.for_policy("DEMS-COOP").step_chunk(pr, pp, state, sig)
    assert (cc.count, cc.total_secs) == (0, 0.0)
    assert prof.fleet_compile_stats().traces == 1


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    with prof.profile_trace(str(tmp_path)) as on:
        torch.ones(8).sum()
    assert on is True
    assert (tmp_path / "trace.json").stat().st_size > 0


@pytest.mark.parametrize("traced", [False, True])
def test_donate_is_bitwise_and_the_callers_state_survives(traced):
    trace = TraceSpec.full() if traced else TraceSpec()
    sig = F.default_signals(len(MODELS), n_edges=3, duration_ms=45 * 25.0,
                            seed=5, device="cpu")
    kw = dict(trace=trace, chunk_ticks=20, device="cpu")
    plain = F.run_fleet(MODELS, "DEMS-COOP", sig, **kw)
    donated = F.run_fleet(MODELS, "DEMS-COOP", sig, donate=True, **kw)
    assert _equal(plain, donated)

    prog, pr, pp, state, _ = _coop_setup(donate=True, trace=trace)
    before = F._map(torch.clone, state)
    res = prog.run(pr, pp, state, sig, chunk_ticks=20)
    assert _equal(state, before)         # run consumed a copy, not this
    assert _equal(res, plain)


def test_batch_entry_points_take_donate():
    from repro_torch.scenarios.runner import run_registry_sweep

    kw = dict(duration_ms=1_000.0, device="cpu")
    rows = run_registry_sweep(("rush-hour", "cloud-crunch"),
                              ("DEMS", "DEMS-COOP"), (0,), **kw)
    assert run_registry_sweep(("rush-hour", "cloud-crunch"),
                              ("DEMS", "DEMS-COOP"), (0,), donate=True,
                              **kw) == rows
    sig = F.stack_signals([F.default_signals(
        len(MODELS), n_edges=2, duration_ms=500.0, seed=s, device="cpu")
        for s in (0, 1)])
    assert _equal(F.run_fleet_batch(MODELS, "GEMS-COOP", sig, device="cpu"),
                  F.run_fleet_batch(MODELS, "GEMS-COOP", sig, donate=True,
                                    device="cpu"))


def test_traced_streams_of_consecutive_windows_do_not_alias():
    prog, pr, pp, state, sig = _coop_setup(trace=TraceSpec.full())
    state, r1 = prog.step_chunk(pr, pp, state, F.slice_signals(sig, 0, 10))
    first = F._map(torch.clone, r1)
    state, r2 = prog.step_chunk(pr, pp, state, F.slice_signals(sig, 10, 20))
    assert _equal(r1, first)                    # untouched by window 2
    ptrs = {a.untyped_storage().data_ptr() for a in F._leaves(r1)}
    assert not ptrs & {a.untyped_storage().data_ptr()
                       for a in F._leaves(r2)}
    assert r2.final is state


@pytest.mark.parametrize("donate", [False, True])
@pytest.mark.parametrize("trace", [TraceSpec(), TraceSpec.full()],
                         ids=["untraced", "traced"])
def test_recorded_body_on_static_buffers_equals_step_chunk(donate, trace):
    # the graph's recording called eagerly on static buffers, window by
    # window (a copy_ a leaf in, as a replay does), against plain
    # step_chunk: across windows and a ragged tail
    prog, pr, pp, state, sig = _coop_setup(ticks=27, trace=trace,
                                           donate=donate)
    tp = prog._program
    windows = [(0, 10), (10, 20), (20, 27)]
    first = F.slice_signals(sig, *windows[0])
    static = tuple(F._map(torch.clone, t) for t in (pr, pp, state, first))
    want = state
    for lo, hi in windows:
        win = F.slice_signals(sig, lo, hi)
        want, want_res = prog.step_chunk(pr, pp, want, win)
        if hi - lo != first.times.shape[0]:
            # a ragged window is a shape key of its own: fresh buffers
            static = tuple(F._map(torch.clone, t)
                           for t in static[:3] + (win,))
        for a, b in zip(F._leaves(static[3]), F._leaves(win)):
            a.copy_(b)
        with torch.inference_mode():
            got, t_hat, counters = tp.record(static)
        assert _equal(got, want), (lo, hi)
        if trace.enabled:
            assert _equal((t_hat, counters),
                          (want_res.t_hat, want_res.counters))
        if donate:
            # the carry was written back into the static state buffers
            assert got is static[2]
        else:
            # the next window copies the new carry in, as a replay does
            for a, b in zip(F._leaves(static[2]), F._leaves(got)):
                a.copy_(b)


def test_record_clones_an_output_that_aliases_its_input():
    # a body that hands an input leaf through unchanged must not see it
    # overwritten by an earlier leaf's write-back
    class Swap(F.TickProgram):
        def window(self, prof, pp, state, signals):
            return state._replace(n_peer_out=state.n_peer_in,
                                  n_peer_in=state.n_peer_out), None, None

    _, pr, pp, state, sig = _coop_setup(ticks=2)
    state = state._replace(n_peer_out=torch.full_like(state.n_peer_out, 1),
                           n_peer_in=torch.full_like(state.n_peer_in, 2))
    tp = Swap(25.0, 0.62, 0.80, 0, TraceSpec(), True)
    static = (pr, pp, state, sig)
    got, _, _ = tp.record(static)
    assert got is state
    assert np.all(state.n_peer_out.numpy() == 2)
    assert np.all(state.n_peer_in.numpy() == 1)


def _eager_graph(tp, inputs):
    """A stand-in for ``tp``'s graph of ``inputs``' shape on the CPU: its
    ``replay`` runs the recorded body on the static inputs and writes what
    it returns into the static outputs, as the captured kernels do."""
    class Graph:
        def replay(self):
            for a, b in zip(F._leaves(outputs), F._leaves(tp.record(static))):
                if a is not b:
                    a.copy_(b)

    static = tuple(F._map(torch.clone, t) for t in inputs)
    with torch.inference_mode():
        state, t_hat, counters = tp.window(*static)
    outputs = (static[2] if tp.donate else state, t_hat, counters)
    return F._Graph(Graph(), static, outputs, (0, 0), 0, 0.0, 0.0)


def test_interleaved_donated_streams_stay_apart():
    # stream a from the fresh state over windows 0-3, stream b from the
    # fresh state over windows 1-4, on one donated graph; each window's
    # result, and the state a stream still holds after the other's
    # window, equal the undonated run's
    prog, pr, pp, fresh, sig = _coop_setup(ticks=50, trace=TraceSpec.full(),
                                           donate=True)
    plain = F.FleetProgram.for_policy("DEMS-COOP", trace=TraceSpec.full())
    tp = prog._program
    g = _eager_graph(tp, (pr, pp, fresh, F.slice_signals(sig, 0, 10)))
    got = {"a": fresh, "b": fresh}
    want = dict(got)
    start = {"a": 0, "b": 1}
    done = {"a": 0, "b": 0}
    with torch.inference_mode():
        for s in "aabaabbab":
            lo = 10 * (start[s] + done[s])
            win = F.slice_signals(sig, lo, lo + 10)
            done[s] += 1
            want[s], res = plain.step_chunk(pr, pp, want[s], win)
            got[s], t_hat, counters = tp._replay(g, pr, pp, got[s], win)
            assert _equal((t_hat, counters), (res.t_hat, res.counters)), s
            for k in "ab":
                assert _equal(got[k], want[k]), (s, k)
    # the last window's result is the buffers' own carry
    assert all(a.untyped_storage().data_ptr() == b.untyped_storage().data_ptr()
               for a, b in zip(F._leaves(got["b"]), F._leaves(g.inputs[2])))


def test_replay_reads_changed_profiles_and_params():
    # the same profiles and params objects window after window, then the
    # params changed in place, then new objects: every window equals the
    # undonated step_chunk on the same inputs
    prog, pr, pp, state, sig = _coop_setup(ticks=40)
    tp = prog._program
    g = _eager_graph(tp, (pr, pp, state, F.slice_signals(sig, 0, 10)))
    other = F.FleetPolicy.from_name("SJF-E+C").params("cpu")
    want = state
    for w in range(4):
        if w == 2:
            for a, b in zip(pp, other):
                a.copy_(b)
        if w == 3:
            pr = F._map(torch.clone, pr)
            pp = F.FleetPolicy.from_name("DEMS-COOP").params("cpu")
        win = F.slice_signals(sig, 10 * w, 10 * w + 10)
        want, _ = prog.step_chunk(pr, pp, want, win)
        with torch.inference_mode():
            state, _, _ = tp._replay(g, pr, pp, state, win)
        assert _equal(state, want), w

"""The port's span and counter table (``repro_torch.obs.prof``), on the
CPU.

* **the control plane's tree** — every ``FleetController.poll`` is a
  ``ctl.poll`` span whose children are its windows' ``ctl.emit``,
  ``ctl.step`` (holding the tick program's ``fleet.window``) and
  ``ctl.record``, all of one request;
* **the profiler's clock** — under ``torch.profiler`` each span is a
  ``record_function`` range of its name, and ``to_profiler_ns`` puts the
  span on that range's clock;
* **off** — ``tracing(False)`` records nothing and changes no result;
* **capture accounting** — ``CompileCounter`` reads the table's
  ``fleet.capture`` and ``fleet.instantiate`` totals;
* **bounded** — past the rings' sizes the rings stay bounded while the
  counts and totals count every span; threads keep their own parents
  and lose no update;
* **launch counts** — ``sched_ops.launch_counts()`` reads the counters
  ``add_launches`` writes.
"""
import sys
import threading

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.kernels import sched_ops
from repro_torch.obs import prof
from repro_torch.scenarios.registry import get
from repro_torch.serve.controller import FleetController
from repro_torch.sim import fleet as F

SPEC = get("baseline", duration_ms=2000)
WINDOW = 8
POLLS = 4
# a span against its profiler range (the first call of a process opens
# its range about 0.2 ms late)
CLOCK_TOL_NS = 200_000


def _mission() -> FleetController:
    """A 2-edge DEMS-COOP controller fed a cadence of arrivals, then
    polled, ``POLLS`` times: one window a poll."""
    ctl = FleetController(SPEC.models, "DEMS-COOP", n_edges=2,
                          window_ticks=WINDOW, device="cpu")
    cadence = WINDOW * ctl.dt
    for k in range(POLLS):
        t = int(k * cadence)
        while t < (k + 1) * cadence:
            ctl.submit(float(t), t % 2, (t // 40) % len(SPEC.models))
            t += 20
        ctl.poll((k + 1) * cadence)
    return ctl


def _since(mark: prof.span) -> list:
    return [r for r in prof.span_records() if r.id > mark.id]


def test_every_poll_is_one_request_of_emit_step_and_record():
    with prof.span("test.mark") as mark:
        pass
    _mission()
    recs = _since(mark)
    by_id = {r.id: r for r in recs}
    polls = [r for r in recs if r.name == "ctl.poll"]
    assert len(polls) == POLLS
    assert len({p.request for p in polls}) == POLLS
    for p in polls:
        assert p.parent == 0 and p.request == p.id
        kids = [r for r in recs if r.parent == p.id]
        assert [k.name for k in sorted(kids, key=lambda r: r.start_ns)] \
            == ["ctl.emit", "ctl.step", "ctl.record"]
        step = next(k for k in kids if k.name == "ctl.step")
        assert [r.name for r in recs if r.parent == step.id] \
            == ["fleet.window"]
        assert sum(k.end_ns - k.start_ns for k in kids) \
            <= p.end_ns - p.start_ns
        for k in kids:
            assert p.start_ns <= k.start_ns <= k.end_ns <= p.end_ns
    # every span under a poll carries its request id
    for r in recs:
        if r.name.startswith(("ctl.", "fleet.")):
            top = r
            while top.parent:
                top = by_id[top.parent]
            assert r.request == top.id and top.name == "ctl.poll"


def _profiled_offsets() -> list:
    """Each span of a profiled mission against the profiler range of its
    name (matched in start order): start and end offsets in ns, the first
    span of the block left out."""
    with prof.span("test.mark") as mark:
        pass
    with profile(activities=[ProfilerActivity.CPU]) as pr:
        _mission()
    recs = _since(mark)
    assert recs
    names = {r.name for r in recs}
    ranges: dict = {}
    for e in pr.profiler.kineto_results.events():
        if e.name() in names:
            ranges.setdefault(e.name(), []).append((e.start_ns(),
                                                    e.end_ns()))
    first = min(recs, key=lambda r: r.start_ns)
    out = []
    for name in names:
        mine = sorted((r.start_ns, r.end_ns, r.id) for r in recs
                      if r.name == name)
        theirs = sorted(ranges.get(name, []))
        assert len(theirs) == len(mine), name
        for (s, e, i), (rs, re_) in zip(mine, theirs):
            if i != first.id:
                out.append((name, prof.to_profiler_ns(s) - rs,
                            prof.to_profiler_ns(e) - re_))
    return out


def test_spans_are_profiler_ranges_on_the_profilers_clock():
    # a preempted thread can open its range late: a block passes when
    # every span in it lies within the tolerance, and three are tried
    worst = None
    for _ in range(3):
        offsets = _profiled_offsets()
        assert {n for n, _, _ in offsets} >= {
            "ctl.poll", "ctl.emit", "ctl.step", "fleet.window", "ctl.record"}
        worst = max(offsets, key=lambda o: max(abs(o[1]), abs(o[2])))
        if max(abs(worst[1]), abs(worst[2])) <= CLOCK_TOL_NS:
            return
    pytest.fail(f"a span lies {worst} ns off its profiler range")


def test_tracing_off_records_nothing_and_changes_nothing():
    on = _mission()
    table, n_recs = prof.span_table(), len(prof.span_records())
    last = prof.span_records()[-1]
    was = prof.tracing(False)
    try:
        off = _mission()
        assert prof.span_table() == table
        recs = prof.span_records()
        assert len(recs) == n_recs and recs[-1] == last
    finally:
        prof.tracing(was)
    assert all(torch.equal(a, b) for a, b in zip(F._leaves(on.state),
                                                 F._leaves(off.state)))
    # the step latency is the span's, taken with the table off too
    assert len(off.step_latencies_ms) == POLLS
    assert all(ms > 0 for ms in off.step_latencies_ms)


def test_compile_counter_reads_the_capture_spans():
    names = prof.CompileCounter.NAMES
    before = prof.span_table(*names)
    with prof.CompileCounter() as cc:
        F.run_fleet(SPEC.models, "DEMS", F.default_signals(
            len(SPEC.models), n_edges=2, duration_ms=250.0, seed=3,
            device="cpu"), device="cpu")
        spans = []
        for _ in range(2):
            with prof.span("fleet.capture") as cap:
                pass
            with prof.span("fleet.instantiate") as inst:
                pass
            spans += [cap, inst]
    after = prof.span_table(*names)

    def total(rows, name):
        return rows.get(name, {}).get("total_s", 0.0)
    assert cc.count == after["fleet.capture"]["count"] - before.get(
        "fleet.capture", {}).get("count", 0) == 2
    assert cc.total_secs == pytest.approx(
        sum(total(after, n) - total(before, n) for n in names), abs=1e-12)
    assert cc.total_secs == pytest.approx(sum(s.seconds for s in spans),
                                          abs=1e-9)


def test_rings_stay_bounded_while_counts_and_totals_count_every_span():
    name = "test.ring"
    n = prof.RECORDS + 10
    before = prof.span_table(name).get(name, dict(count=0, total_s=0.0))
    total_ns = 0
    for _ in range(n):
        with prof.span(name) as s:
            pass
        total_ns += s.end_ns - s.start_ns
    row = prof.span_table(name)[name]
    assert row["count"] == before["count"] + n
    assert row["total_s"] == pytest.approx(before["total_s"]
                                           + total_ns / 1e9, abs=1e-9)
    assert len(prof._TABLE.rows[name][3]) == prof.RING
    recs = prof.span_records()
    assert len(recs) == prof.RECORDS
    assert all(r.name == name for r in recs[-prof.RING:])


def test_threads_keep_their_own_parents_and_lose_no_update():
    name, threads, each = "test.thread", 12, 400
    before = prof.span_table(name).get(name, dict(count=0))["count"]
    c0 = prof.counters().get(name, 0)
    errors = []

    def work():
        try:
            for _ in range(each):
                with prof.span(name) as outer:
                    with prof.span(name + ".inner") as inner:
                        prof.count(name)
                    if (inner.parent is not outer
                            or inner.request != outer.request
                            or outer.parent is not None):
                        errors.append((outer.id, inner.id))
        except BaseException as e:  # reported below
            errors.append(e)
            raise

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with prof.span("test.main"):
            ts = [threading.Thread(target=work) for _ in range(threads)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in ts)
    assert errors == []
    assert prof.span_table(name)[name]["count"] == before + threads * each
    assert prof.counters()[name] == c0 + threads * each


def test_launch_counts_read_what_add_launches_added():
    n0, k0 = sched_ops.launch_counts()
    try:
        sched_ops.add_launches(5, 3)
        assert sched_ops.launch_counts() == (n0 + 5, k0 + 3)
        assert prof.counters()[sched_ops.LAUNCHES] == n0 + 5
        assert prof.counters()[sched_ops.KEY_LAUNCHES] == k0 + 3
        sched_ops.reset_count()
        assert sched_ops.launch_counts() == (0, 0)
    finally:
        sched_ops.add_launches(n0 - sched_ops.launch_counts()[0],
                               k0 - sched_ops.launch_counts()[1])
    assert sched_ops.launch_counts() == (n0, k0)

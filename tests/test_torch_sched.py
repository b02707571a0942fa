"""The port's batched decision functions against the vmapped JAX ones.

``repro_torch.core.sched`` takes an explicit leading edge axis where
``repro.core.jax_sched`` is written for one edge; each function here runs
on the same random queues (E = 3 edges, numpy-seeded, shaped like the
fleet's: EDF keys with ties, fractional busy times, Table-1 models) and
must equal ``jax.vmap`` of its reference.  Integer and boolean outputs
are compared exactly; float outputs too, as the port keeps the
reference's operation order.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import jax_sched as J  # noqa: E402
from repro.core.task import TABLE1  # noqa: E402
from repro_torch.core import sched as T  # noqa: E402

MODELS = list(TABLE1.values())
M = len(MODELS)
E, Q, QC, W = 3, 12, 16, 10
T_EDGE = np.asarray([m.t_edge for m in MODELS], np.float32)
T_CLOUD = np.asarray([m.t_cloud for m in MODELS], np.float32)
DL = np.asarray([m.deadline for m in MODELS], np.float32)
GE = np.asarray([m.gamma_edge for m in MODELS], np.float32)
GC = np.asarray([m.gamma_cloud for m in MODELS], np.float32)
RANK = np.asarray([m.steal_rank() for m in MODELS], np.float32)
SEEDS = [0, 1, 2]
NOW = np.float32(1000.0)


def _edge_queue(rng, q=Q):
    model = rng.integers(0, M, (E, q)).astype(np.int32)
    created = (rng.integers(0, 60, (E, q)) * 25).astype(np.float32)
    abs_dl = created + DL[model]
    ext = np.where(rng.random((E, q)) < 0.2, 0.1 * DL[model], 0.0)
    return dict(
        valid=rng.random((E, q)) < 0.6,
        key=abs_dl,                                    # EDF keys, with ties
        seq=np.stack([rng.permutation(q) for _ in range(E)]).astype(
            np.int32),
        t_edge=(T_EDGE[model] * np.where(rng.random((E, q)) < 0.3, 1.25,
                                         1.0)).astype(np.float32),
        deadline=(abs_dl + ext).astype(np.float32),
        abs_dl=abs_dl, model=model)


def _cloud_queue(rng):
    model = rng.integers(0, M, (E, QC)).astype(np.int32)
    dl = (rng.integers(20, 80, (E, QC)) * 25 + DL[model]).astype(np.float32)
    return dict(valid=rng.random((E, QC)) < 0.6,
                trigger=(dl - T_CLOUD[model] - 50).astype(np.float32),
                t_edge=T_EDGE[model], deadline=dl,
                steal_only=rng.random((E, QC)) < 0.3,
                rank=RANK[model]), model


def _pair(cls_j, cls_t, d):
    return (cls_j(**{k: jnp.asarray(v) for k, v in d.items()}),
            cls_t(**{k: torch.tensor(np.asarray(v)) for k, v in
                     d.items()}))


def _inputs(seed):
    rng = np.random.default_rng(seed)
    qj, qt = _pair(J.EdgeQueue, T.EdgeQueue, _edge_queue(rng))
    cqd, cq_model = _cloud_queue(rng)
    cqj, cqt = _pair(J.CloudQueue, T.CloudQueue, cqd)
    busy = (0.62 * T_EDGE[rng.integers(0, M, E)]
            * rng.random(E)).astype(np.float32)
    new_model = rng.integers(0, M, E).astype(np.int32)
    new_dl = (NOW + DL[new_model]).astype(np.float32)
    new_te = T_EDGE[new_model]
    tcc = (T_CLOUD[None] + rng.integers(0, 8, (E, M)) * 50.0).astype(
        np.float32)
    return dict(rng=rng, qj=qj, qt=qt, cqj=cqj, cqt=cqt, busy=busy,
                new_model=new_model, new_dl=new_dl, new_te=new_te, tcc=tcc,
                cq_model=cq_model)


def _t(a):
    return torch.tensor(np.asarray(a))


def _same(got, want):
    if isinstance(got, tuple):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
        return
    g = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    w = np.asarray(want)
    assert g.shape == w.shape, (g.shape, w.shape)
    if w.dtype == np.bool_ or np.issubdtype(w.dtype, np.integer):
        np.testing.assert_array_equal(g.astype(w.dtype), w)
    else:
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("seed", SEEDS)
def test_projected_completions_and_slacks(seed):
    d = _inputs(seed)
    args_j = (d["qj"], NOW, jnp.asarray(d["busy"]))
    args_t = (d["qt"], _t(NOW), _t(d["busy"]))
    vm = (0, None, 0)
    _same(T.projected_completions(*args_t),
          jax.vmap(J.projected_completions, vm)(*args_j))
    _same(T.queue_slacks(*args_t), jax.vmap(J.queue_slacks, vm)(*args_j))
    _same(T.max_front_delay(*args_t),
          jax.vmap(J.max_front_delay, vm)(*args_j))
    _same(T.head_slack(d["qt"], _t(NOW)),
          jax.vmap(J.head_slack, (0, None))(d["qj"], NOW))
    _same(T.queue_load(d["qt"], _t(d["busy"])),
          jax.vmap(J.queue_load)(d["qj"], jnp.asarray(d["busy"])))


@pytest.mark.parametrize("prio", [J.PRIO_EDF, J.PRIO_HPF, J.PRIO_SJF])
def test_edge_priority_key(prio):
    rng = np.random.default_rng(prio)
    m = rng.integers(0, M, E)
    dl = (NOW + DL[m]).astype(np.float32)
    te = (T_EDGE[m] * 1.25).astype(np.float32)
    _same(T.edge_priority_key(torch.tensor(prio, dtype=torch.int32), _t(dl),
                              _t(te), _t(GE[m])),
          J.edge_priority_key(jnp.int32(prio), dl, te, GE[m]))


@pytest.mark.parametrize("seed", SEEDS)
def test_insert_feasible_victims_and_act(seed):
    d = _inputs(seed)
    new_key = d["new_dl"]
    args_j = (d["qj"], NOW, jnp.asarray(d["busy"]), jnp.asarray(new_key),
              jnp.asarray(d["new_te"]))
    args_t = (d["qt"], _t(NOW), _t(d["busy"]), _t(new_key), _t(d["new_te"]))
    vm = (0, None, 0, 0, 0)
    _same(T.insert_feasible(*args_t, _t(d["new_dl"])),
          jax.vmap(J.insert_feasible, vm + (0,))(*args_j,
                                                 jnp.asarray(d["new_dl"])))
    _same(T.victim_mask(*args_t), jax.vmap(J.victim_mask, vm)(*args_j))
    _same(T.act_improves(*args_t), jax.vmap(J.act_improves, vm)(*args_j))


@pytest.mark.parametrize("seed", SEEDS)
def test_eqn3_and_migration_decision(seed):
    d = _inputs(seed)
    qj, qt = d["qj"], d["qt"]
    _same(T.eqn3_scores(qt.model, _t(NOW), qt.deadline, _t(GE), _t(GC),
                        _t(d["tcc"])),
          jax.vmap(J.eqn3_scores, (0, None, 0, None, None, 0))(
              qj.model, NOW, qj.deadline, jnp.asarray(GE), jnp.asarray(GC),
              d["tcc"]))
    victims = d["rng"].random((E, Q)) < 0.3
    _same(T.migration_decision(qt, _t(victims), _t(NOW), _t(d["new_model"]),
                               _t(d["new_dl"]), _t(GE), _t(GC),
                               _t(d["tcc"])),
          jax.vmap(J.migration_decision,
                   (0, 0, None, 0, 0, None, None, 0))(
              qj, victims, NOW, d["new_model"], d["new_dl"],
              jnp.asarray(GE), jnp.asarray(GC), d["tcc"]))


@pytest.mark.parametrize("seed", SEEDS)
def test_steal_select(seed):
    d = _inputs(seed)
    min_t = np.float32(T_EDGE.min())
    _same(T.steal_select(d["cqt"], d["qt"], _t(NOW), _t(d["busy"]),
                         _t(min_t)),
          jax.vmap(J.steal_select, (0, 0, None, 0, None))(
              d["cqj"], d["qj"], NOW, d["busy"], min_t))
    # a generous clock makes the steal-only offsets and ties decide
    late = np.float32(0.0)
    _same(T.steal_select(d["cqt"], d["qt"], _t(late), _t(d["busy"] * 0),
                         _t(min_t)),
          jax.vmap(J.steal_select, (0, 0, None, 0, None))(
              d["cqj"], d["qj"], late, d["busy"] * 0, min_t))


@pytest.mark.parametrize("seed", SEEDS)
def test_export_select(seed):
    d = _inputs(seed)
    dst = np.asarray([0.0, 150.0, 900.0], np.float32)
    for thresh in (0.0, 200.0):
        th = np.float32(thresh)
        _same(T.export_select(d["qt"], _t(NOW), _t(d["busy"]), _t(dst),
                              _t(th)),
              jax.vmap(J.export_select, (0, None, 0, 0, None))(
                  d["qj"], NOW, d["busy"], dst, th))


@pytest.mark.parametrize("seed", SEEDS)
def test_gems_helpers(seed):
    d = _inputs(seed)
    rng = d["rng"]
    lag = rng.integers(0, M, E).astype(np.int32)
    _same(T.gems_reschedule_mask(d["qt"], _t(NOW), _t(lag), _t(d["tcc"]),
                                 _t(GC)),
          jax.vmap(J.gems_reschedule_mask, (0, None, 0, 0, None))(
              d["qj"], NOW, lag, d["tcc"], jnp.asarray(GC)))
    lam = rng.integers(0, 9, (E, M)).astype(np.int32)
    lam_hat = np.minimum(lam, rng.integers(0, 9, (E, M))).astype(np.int32)
    prev = rng.integers(0, 9, (E, M)).astype(np.int32)
    succ = rng.random((E, M)) < 0.5
    _same(T.window_update(_t(lam), _t(lam_hat), _t(succ)),
          J.window_update(jnp.asarray(lam), jnp.asarray(lam_hat),
                          jnp.asarray(succ)))
    alpha = np.full(M, 0.9, np.float32)
    win_end = (rng.integers(1, 5, (E, M)) * 5000.0).astype(np.float32)
    window = np.full(M, 20_000.0, np.float32)
    now = np.float32(4_525.0)
    _same(T.gems_winnable(_t(lam), _t(lam_hat), _t(prev), _t(alpha),
                          _t(now), _t(win_end), _t(window)),
          J.gems_winnable(lam, lam_hat, prev, alpha, now, win_end, window))


def _adapt_state(rng):
    count = rng.integers(0, W + 1, (E, M)).astype(np.int32)
    idx = np.where(count < W, 0, rng.integers(0, W, (E, M))).astype(
        np.int32)
    buf = (rng.random((E, M, W)) * 900.0).astype(np.float32)
    buf = np.where(np.arange(W) < count[..., None], buf, 0.0).astype(
        np.float32)
    cur = (T_CLOUD[None] + rng.integers(0, 4, (E, M)) * 60.0).astype(
        np.float32)
    cs = np.where(rng.random((E, M)) < 0.5, -1.0,
                  rng.integers(0, 40, (E, M)) * 250.0).astype(np.float32)
    return dict(buf=buf, count=count, idx=idx, current=cur,
                cooling_start=cs)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("with_obs", [True, False])
def test_adapt_feed_batch(seed, with_obs):
    rng = np.random.default_rng(100 + seed)
    sj, stt = _pair(J.AdaptState, T.AdaptState, _adapt_state(rng))
    k = 24
    ids = rng.integers(0, M, (E, k)).astype(np.int32)
    sent = rng.random((E, k)) < 0.4
    obs = sent & (rng.random((E, k)) < 0.8)
    per_model = (T_CLOUD[None] * 0.8 + rng.random((E, M)) * 300.0).astype(
        np.float32)
    obs_val = np.take_along_axis(per_model, ids, 1)
    skip = rng.random((E, k)) < 0.2
    now, eps, tcp = np.float32(9_000.0), np.float32(10.0), np.float32(5e3)
    for max_obs in (None, 6):
        fn = functools.partial(J.adapt_feed_batch, with_obs=with_obs,
                               max_obs=max_obs)
        want = jax.vmap(fn, (0, 0, 0, 0, 0, 0, None, None, None, None))(
            sj, ids, sent, obs, obs_val, skip, now, T_CLOUD, eps, tcp)
        got = T.adapt_feed_batch(stt, _t(ids), _t(sent), _t(obs),
                                 _t(obs_val), _t(skip), _t(now), _t(T_CLOUD),
                                 _t(eps), _t(tcp), with_obs=with_obs,
                                 max_obs=max_obs)
        _same(tuple(got), tuple(want))
    if not with_obs:   # the skip-only form of the offer path
        got = T.adapt_feed_batch(stt, _t(ids), None, None, None, _t(skip),
                                 _t(now), _t(T_CLOUD), _t(eps), _t(tcp),
                                 with_obs=False)
        want = jax.vmap(functools.partial(J.adapt_feed_batch,
                                          with_obs=False),
                        (0, 0, 0, 0, 0, 0, None, None, None, None))(
            sj, ids, np.zeros_like(sent), np.zeros_like(obs), obs_val, skip,
            now, T_CLOUD, eps, tcp)
        _same(tuple(got), tuple(want))


@pytest.mark.parametrize("seed", SEEDS)
def test_queue_mutation(seed):
    d = _inputs(seed)
    rng = d["rng"]
    full = dict(zip(J.EdgeQueue._fields, map(np.asarray, d["qj"])))
    full["valid"] = full["valid"].copy()
    full["valid"][0] = True                       # edge 0 has no free slot
    qj, qt = _pair(J.EdgeQueue, T.EdgeQueue, full)
    enable = np.asarray([True, True, False])
    seq = np.asarray([40, 41, 42], np.int32)
    key = d["new_dl"]
    sched_dl = (key + 5.0).astype(np.float32)
    got = T.edge_push(qt, _t(key), _t(seq), _t(d["new_te"]), _t(sched_dl),
                      _t(d["new_model"]), enable=_t(enable), abs_dl=_t(key))
    want = jax.vmap(J.edge_push)(qj, key, seq, d["new_te"], sched_dl,
                                 d["new_model"], enable, key)
    _same((tuple(got[0]), got[1]), (tuple(want[0]), want[1]))
    q2, idx, found = T.edge_pop_head(qt)
    wq2, widx, wfound = jax.vmap(J.edge_pop_head)(qj)
    _same((tuple(q2), idx, found), (tuple(wq2), widx, wfound))
    mask = rng.random((E, Q)) < 0.5
    _same(tuple(T.edge_remove(qt, _t(mask))),
          tuple(jax.vmap(J.edge_remove)(qj, mask)))


# ---------------------------------------------------------------------------
# per-event functions, on the event sequences of tests/test_jax_sched.py
# ---------------------------------------------------------------------------

def _close(got, want):
    """Integer and boolean fields exactly, floats within 1e-6."""
    for g, w in zip(got, want):
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape
        if w.dtype == np.bool_ or np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(g.astype(w.dtype), w)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("seed", SEEDS)
def test_adapt_observe_sequence(seed):
    """A run of observations (1–30 durations in [50, 2000] ms, windows of
    2–10), state against state after every one."""
    rng = np.random.default_rng(300 + seed)
    w = int(rng.integers(2, 11))
    sj = J.adapt_init(jnp.array([400.0]), w=w)
    st = T.adapt_init(torch.tensor([400.0]), w=w)
    for o in rng.uniform(50, 2000, int(rng.integers(1, 31))):
        sj = J.adapt_observe(sj, 0, float(o), eps=10.0)
        st = T.adapt_observe(st, 0, float(o), eps=10.0)
        _close(st, sj)


@pytest.mark.parametrize("seed", SEEDS)
def test_adapt_skip_cooling_sequence(seed):
    """Four 900 ms observations inflate t̂, then sends and skips at sorted
    times in [0, 40 s] cool it (t_cp 10 s)."""
    rng = np.random.default_rng(310 + seed)
    static_j, static_t = jnp.array([400.0]), torch.tensor([400.0])
    sj = J.adapt_init(static_j, w=4)
    st = T.adapt_init(static_t, w=4)
    for _ in range(4):
        sj = J.adapt_observe(sj, 0, 900.0, eps=10.0)
        st = T.adapt_observe(st, 0, 900.0, eps=10.0)
    n = int(rng.integers(1, 26))
    for sent, t in zip(rng.random(n) < 0.5,
                       np.sort(rng.uniform(0, 40_000, n))):
        if sent:
            sj, st = J.adapt_on_sent(sj, 0), T.adapt_on_sent(st, 0)
        else:
            sj = J.adapt_on_skip(sj, 0, float(t), static_j, t_cp=10_000.0)
            st = T.adapt_on_skip(st, 0, float(t), static_t, t_cp=10_000.0)
        _close(st, sj)


@pytest.mark.parametrize("seed", SEEDS + [3, 4])
def test_adapt_mixed_sequence(seed):
    """Interleaved observe / skip / sent events over two models (1–40
    events, 1–2000 ms apart, windows of 2–8, t_cp 5 s)."""
    rng = np.random.default_rng(320 + seed)
    w = int(rng.integers(2, 9))
    static_j, static_t = jnp.array([400.0, 400.0]), torch.tensor([400.0,
                                                                  400.0])
    sj, st = J.adapt_init(static_j, w=w), T.adapt_init(static_t, w=w)
    now = 0.0
    for _ in range(int(rng.integers(1, 41))):
        m, kind = int(rng.integers(0, 2)), int(rng.integers(0, 3))
        val = float(rng.uniform(50, 2000))
        now += float(rng.integers(1, 2001))
        if kind == 0:
            sj = J.adapt_observe(sj, m, val, eps=10.0)
            st = T.adapt_observe(st, m, val, eps=10.0)
        elif kind == 1:
            sj = J.adapt_on_skip(sj, m, now, static_j, t_cp=5_000.0)
            st = T.adapt_on_skip(st, m, now, static_t, t_cp=5_000.0)
        else:
            sj, st = J.adapt_on_sent(sj, m), T.adapt_on_sent(st, m)
        _close(st, sj)


@pytest.mark.parametrize("seed", SEEDS)
def test_adapt_select(seed):
    """A masked choice between two whole estimator states."""
    rng = np.random.default_rng(330 + seed)
    a = _adapt_state(rng)
    b = _adapt_state(rng)
    aj, at = _pair(J.AdaptState, T.AdaptState, a)
    bj, bt = _pair(J.AdaptState, T.AdaptState, b)
    for pred in (True, False, bool(rng.random() < 0.5)):
        _same(tuple(T.adapt_select(torch.tensor(pred), at, bt)),
              tuple(J.adapt_select(jnp.asarray(pred), aj, bj)))


@pytest.mark.parametrize("seed", SEEDS)
def test_cloud_push_remove_sequence(seed):
    """Pushes (some disabled) into a 16-slot cloud queue past full, with
    removals between, field by field after every event, as the steal
    test of tests/test_jax_sched.py fills its queue."""
    rng = np.random.default_rng(340 + seed)
    cqj = J.empty_cloud_queue(QC)
    cqt = T.empty_cloud_queue(QC, device="cpu")
    for _ in range(3 * QC):
        if rng.random() < 0.25:
            idx = int(rng.integers(0, QC))
            cqj, cqt = J.cloud_remove(cqj, idx), T.cloud_remove(cqt, idx)
        else:
            mi = int(rng.integers(0, M))
            m = MODELS[mi]
            trig = float(rng.integers(0, 200) * 10)
            dl = trig + float(m.deadline)
            enable = bool(rng.random() < 0.9)
            cqj, okj = J.cloud_push(cqj, trig, m.t_edge, dl,
                                    m.gamma_cloud <= 0, m.steal_rank(),
                                    enable)
            cqt, okt = T.cloud_push(cqt, trig, m.t_edge, dl,
                                    m.gamma_cloud <= 0, m.steal_rank(),
                                    enable)
            assert bool(okt) == bool(okj)
        _close(cqt, cqj)


def test_transfer_ms_matches_jax():
    from repro.sim import network as JN
    from repro_torch.sim import network as TN
    for kb, bw in ((38.0, 20.0), (38.0, 0.0), (512.0, 3.5), (0.0, 1e-4),
                   (1.5, 1e-3)):
        assert TN.transfer_ms(kb, bw) == JN.transfer_ms(kb, bw)

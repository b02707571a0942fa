"""The port's live serving path on the CPU: ``ServeEngine`` over reduced
zoo models (mirroring ``tests/test_serve_and_train.py``), the launcher,
and the serve policies' decisions against ``repro.core.schedulers`` on a
table of tasks (equal exactly: the same float arithmetic in Python)."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro.core import schedulers as JS  # noqa: E402
from repro.core import task as JT  # noqa: E402
from repro_torch.configs.base import reduced  # noqa: E402
from repro_torch.configs.registry import ARCHS  # noqa: E402
from repro_torch.core import schedulers as TS  # noqa: E402
from repro_torch.core import task as TT  # noqa: E402
from repro_torch.launch import serve as launch  # noqa: E402
from repro_torch.serve.engine import (ServableModel, ServeEngine,  # noqa: E402
                                      run_stream)


def _servable(name, arch, beta=100, ke=1, kc=25, deadline=400.0,
              attn_impl="ref"):
    cfg = dataclasses.replace(
        reduced(ARCHS[arch], n_layers=2, d_model=128, vocab=512),
        attn_impl=attn_impl)
    prof = TT.ModelProfile(name=name, beta=beta, deadline=deadline,
                           t_edge=20.0, t_cloud=60.0, cost_edge=ke,
                           cost_cloud=kc, qoe_beta=50.0, qoe_alpha=0.8,
                           qoe_window=2_000.0)
    return ServableModel.from_arch(prof, cfg, batch=1, seq=16, device="cpu")


@pytest.fixture
def one_intra_op_thread():
    """torch's intra-op pool cut to one thread for a live stream, then
    restored.  The engine calls the model from its edge thread and its
    cloud threads at once, each with its own team of the pool's size
    (the host's cores); beside other busy processes those teams spin at
    every op's barrier, the forwards of these reduced models slow with
    the host's load, and so would the stream's outcomes that the tests
    assert.  On one thread a forward keeps its pace under that load."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_serve_engine_runs_real_models(one_intra_op_thread):
    models = {"HV": _servable("HV", "granite-3-2b", attn_impl="kernel"),
              "BP": _servable("BP", "starcoder2-3b", beta=40, kc=43)}
    engine = ServeEngine(TS.make_policy("DEMS"), models, cloud_concurrency=2,
                         seed=0)
    r = run_stream(engine, {"HV": 12.0, "BP": 6.0}, duration_ms=3_000.0)
    assert r.generated >= 40
    assert r.completed > 0
    assert r.completion_rate > 0.5
    for st in r.per_model.values():      # conservation
        done = (st.edge_success + st.edge_miss + st.cloud_success
                + st.cloud_miss + st.dropped)
        assert done <= st.generated
    assert not any(t.is_alive() for t in (engine._edge_thread,
                                          *engine._cloud_threads))


def test_serve_engine_gems_windows(one_intra_op_thread):
    models = {"HV": _servable("HV", "granite-3-2b")}
    engine = ServeEngine(TS.make_policy("GEMS"), models, cloud_concurrency=2,
                         seed=0)
    r = run_stream(engine, {"HV": 15.0}, duration_ms=3_000.0)
    st = r.per_model["HV"]
    assert st.windows_total >= 1
    assert st.qoe_utility == st.windows_met * 50.0
    snap = engine.metrics_snapshot()
    assert snap["policy"] == "GEMS"
    assert snap["per_model"]["HV"]["generated"] == st.generated


@pytest.mark.parametrize("arch", ["granite-3-2b", "xlstm-1.3b",
                                  "zamba2-7b", "qwen3-moe-30b-a3b"])
def test_servable_model_on_cpu_is_the_eager_forward(arch):
    """On the CPU, which the caller asked for, ``run()`` is the eager
    forward (no CUDA graph): its logits equal a forward of the same model,
    weights and tokens built from the same seed, for each served family
    (dense, ssm, hybrid, moe)."""
    from repro_torch.models.model import Model
    cfg = dataclasses.replace(
        reduced(ARCHS[arch], n_layers=2, d_model=128, vocab=512),
        attn_impl="kernel")
    prof = TT.ModelProfile(name="M", beta=100, deadline=400.0, t_edge=20.0,
                           t_cloud=60.0, cost_edge=1, cost_cloud=25,
                           qoe_beta=50.0, qoe_alpha=0.8, qoe_window=2_000.0)
    sm = ServableModel.from_arch(prof, cfg, batch=1, seq=16, seed=3,
                                 device="cpu")
    assert sm.graph is None
    model = Model(cfg, "cpu")
    gen = torch.Generator().manual_seed(3)
    params = model.init(gen)
    tokens = torch.randint(0, cfg.vocab, (1, 16), generator=gen)
    want = model.forward(params, {"tokens": tokens})[0]
    first, second = sm.run(), sm.run()
    assert torch.equal(first, want) and torch.equal(second, want)


def test_launcher_builds_roles_and_serves_on_cpu(capsys):
    """The launcher's three roles (HV starcoder2, DEV granite, BP xLSTM) at
    the JAX launcher's reduced size, through the kernel path's dispatch."""
    launch.main(["--device", "cpu", "--duration", "1", "--policy", "DEMS",
                 "--attn-impl", "kernel"])
    out = capsys.readouterr().out
    for role in ("HV:", "DEV:", "BP:", "DEMS"):
        assert role in out
    launch.main(["--device", "cpu", "--backend", "fleet", "--duration",
                 "1", "--policy", "DEMS"])
    out = capsys.readouterr().out
    for key in ("HV:", '"policy": "DEMS"', '"windows_run": 5',
                "step_latency_ms"):
        assert key in out
    cfg = launch.role_config("granite-3-2b", full_size=True,
                             attn_impl="kernel")
    assert (cfg.d_model, cfg.n_layers, cfg.dtype) == (2048, 40, "bfloat16")


# ---------------------------------------------------------------------------
# policy decisions against the reference
# ---------------------------------------------------------------------------

def _tasks(tt):
    """A table of tasks over every Table-1 model: on-time, late, extended
    deadlines, γ^C < 0 (BP) and the Table-2 variants."""
    out = []
    models = list(tt.TABLE1.values()) + tt.table2("WL1", 0.9)
    uid = 0
    for m in models:
        for created in (0.0, 250.0, 1_000.0):
            for ext in (0.0, 65.0):
                uid += 1
                out.append(tt.Task(uid=uid, model=m, created=created,
                                   deadline_ext=ext))
    return out


@pytest.mark.parametrize("name", TS.ALL_POLICIES)
def test_policy_decisions_match_reference(name):
    tp, jp = TS.make_policy(name), JS.make_policy(name)
    assert dataclasses.asdict(tp) == dataclasses.asdict(jp)
    t_tasks, j_tasks = _tasks(TT), _tasks(JT)
    for a, b in zip(t_tasks, j_tasks):
        assert tp.edge_key(a) == jp.edge_key(b)
        for now in (0.0, 200.0, 600.0):
            for t_cloud in (a.model.t_cloud, a.model.t_cloud + 300.0):
                ca = tp.offer_cloud(a, now, t_cloud)
                cb = jp.offer_cloud(b, now, t_cloud)
                assert dataclasses.asdict(ca) == dataclasses.asdict(cb)
    for i in range(0, len(t_tasks) - 3, 3):
        new_t, vic_t = t_tasks[i], t_tasks[i + 1:i + 4]
        new_j, vic_j = j_tasks[i], j_tasks[i + 1:i + 4]
        for now in (0.0, 400.0):
            assert tp.migration_decision(
                new_t, vic_t, now, lambda m: m.t_cloud) == \
                jp.migration_decision(new_j, vic_j, now,
                                      lambda m: m.t_cloud)


def test_task_utility_and_migration_score_match_reference():
    for a, b in zip(_tasks(TT), _tasks(JT)):
        for ta, tb in zip(TT.Outcome, JT.Outcome):
            assert ta.value == tb.value
            a.outcome, b.outcome = ta, tb
            assert a.utility() == b.utility() and a.success == b.success
        assert a.sched_deadline == b.sched_deadline
        for feas in (True, False):
            assert TT.migration_score(a.model, feas) == \
                JT.migration_score(b.model, feas)


def test_adaptive_estimator_matches_reference():
    ta, ja = TS.AdaptiveEstimator(static=400.0), \
        JS.AdaptiveEstimator(static=400.0)
    durations = [380, 420, 900, 950, 1000, 410, 1200, 390, 395, 405, 990,
                 1010, 400, 401, 402, 403, 404, 405, 406, 407]
    now = 0.0
    for d in durations:
        ta.observe(d)
        ja.observe(d)
        now += 3_000.0
        ta.on_skip(now)
        ja.on_skip(now)
        assert ta.current == ja.current
    ta.on_sent()
    ja.on_sent()
    assert dataclasses.asdict(ta) == dataclasses.asdict(ja)

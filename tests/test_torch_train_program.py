"""The port's train program (``repro_torch.train.loop.TrainProgram``, the
counterpart of the reference's jitted step) on the host, where its step
body runs without capture.

From the same numpy weights (``test_torch_models._weights``) and
``FastSyntheticLM`` batches, N = 3 steps of the program equal N steps of
``make_train_step`` bitwise (losses, parameters, moments, step count)
for the dense, moe, hybrid and encdec families at the reduced sizes of
``tests/test_torch_train.py``, and their losses are within 1e-5 of the
JAX package's jitted ``make_train_step`` on the same inputs.  The
program writes the step count into the state's own tensor and copies
each batch into its static buffers; ``AdamW.update`` stays functional
(the dry run's alias bytes count on it); ``train`` steps through a
program.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import ArchConfig as JArchConfig  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro.train import loop as jloop  # noqa: E402
from repro.train.optimizer import AdamW as JAdamW  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.base import reduced  # noqa: E402
from repro_torch.configs.registry import ARCHS  # noqa: E402
from repro_torch.data.pipeline import FastSyntheticLM  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.train import loop  # noqa: E402
from repro_torch.train.optimizer import AdamW, tree_leaves  # noqa: E402

from test_torch_models import _weights  # noqa: E402

B, S, N, LR = 2, 16, 3, 3e-3
LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
CASES = {"dense": ("granite-3-2b", {}),
         "dense-dots": ("granite-3-2b",
                        dict(remat=True, remat_policy="dots")),
         "moe": ("qwen3-moe-30b-a3b", {}),
         "hybrid": ("zamba2-7b", {}),
         "encdec": ("whisper-medium", {})}


def _setup(case, seed=31):
    arch, repl = CASES[case]
    cfg = dataclasses.replace(reduced(ARCHS[arch]), **repl)
    tree = _weights(cfg, seed)
    data = FastSyntheticLM(vocab=cfg.vocab, seq_len=S, batch=B,
                           seed=seed).batches()
    return cfg, tree, [next(data) for _ in range(N)]


def _start(cfg, tree):
    model, opt = Model(cfg, "cpu"), AdamW(lr=LR)
    params = convert.params_from_numpy(cfg, tree, "cpu")
    return model, opt, params, opt.init(params)


def _jax_losses(cfg, tree, raws):
    """The reference's jitted step over the same weights and batches."""
    jcfg = JArchConfig(**convert.arch_to_fields(cfg))
    model, opt = JModel(jcfg), JAdamW(lr=LR)
    params = jax.tree.map(jnp.asarray, tree)
    state = opt.init(params)
    step = jloop.make_train_step(model, opt)
    out = []
    for raw in raws:
        b = {k: jnp.asarray(raw[k]) for k in ("tokens", "labels")}
        if cfg.family == "encdec":
            b["frames"] = jnp.zeros((B, cfg.n_frames, cfg.d_model))
        loss, params, state = step(params, state, b)
        out.append(float(loss))
    return out


def _equal_trees(a, b):
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert torch.equal(x.detach(), y.detach())


@pytest.mark.parametrize("case", list(CASES))
def test_program_steps_equal_eager_steps(case):
    """N program steps and N ``make_train_step`` steps from the same
    weights and batches: losses, parameters, moments and step count
    bitwise; the losses within 1e-5 of the JAX package's jitted step."""
    cfg, tree, raws = _setup(case)
    model, opt, params, state = _start(cfg, tree)
    step = loop.make_train_step(model, opt)
    want = []
    for raw in raws:
        loss, params, state = step(params, state,
                                   loop.batch_tensors(cfg, raw, "cpu"))
        want.append(loss)
    model, opt, cparams, cstate = _start(cfg, tree)
    prog = loop.TrainProgram(model, opt, cparams, cstate)
    got = [prog(raw) for raw in raws]
    assert torch.equal(torch.stack(got), torch.stack(want))
    _equal_trees(cparams, params)
    _equal_trees(cstate.mu, state.mu)
    _equal_trees(cstate.nu, state.nu)
    assert int(cstate.step) == int(state.step) == N
    assert prog.graph is None and prog.replays == 0
    np.testing.assert_allclose([float(x) for x in got],
                               _jax_losses(cfg, tree, raws), **LOSS_TOL)


def test_program_keeps_its_buffers_and_step():
    """The step count is written into the state's own tensor, which reads
    N after N steps; the parameters, moments and static batch buffers
    keep their storage, and each step's batch is copied into them."""
    cfg, tree, raws = _setup("dense")
    model, opt, params, state = _start(cfg, tree)
    prog = loop.TrainProgram(model, opt, params, state)
    prog(raws[0])
    ptrs = {k: v.data_ptr() for k, v in prog.static.items()}
    held = [t.data_ptr() for tree in (params, state.mu, state.nu)
            for t in tree_leaves(tree)]
    step_ptr = state.step.data_ptr()
    for raw in raws[1:]:
        prog(raw)
        for k in ("tokens", "labels"):
            assert prog.static[k].data_ptr() == ptrs[k]
            np.testing.assert_array_equal(prog.static[k].numpy(), raw[k])
    assert state.step.data_ptr() == step_ptr
    assert state.step.dtype == torch.int32 and int(state.step) == N
    assert [t.data_ptr() for tree in (params, state.mu, state.nu)
            for t in tree_leaves(tree)] == held
    with pytest.raises(ValueError, match="tokens of shape"):
        prog({k: v[:1] for k, v in raws[0].items()})


def test_adamw_update_stays_functional():
    """``AdamW.update`` returns a new step tensor and leaves the given
    one as it was (the dry run traces it, and its alias bytes count the
    outputs that are inputs); the parameters and moments it writes in
    place."""
    gen = torch.Generator().manual_seed(3)
    params = {"w": torch.randn(3, 4, generator=gen)}
    grads = {"w": torch.randn(3, 4, generator=gen)}
    opt = AdamW(lr=1e-2)
    state = opt.init(params)
    before = params["w"].clone()
    out, new = opt.update(grads, state, params)
    assert out["w"] is params["w"] and new.mu["w"] is state.mu["w"]
    assert new.step is not state.step
    assert int(state.step) == 0 and int(new.step) == 1
    assert not torch.equal(params["w"], before)


def test_train_steps_through_a_program(monkeypatch):
    """``train`` on the host runs a ``TrainProgram`` (its body eagerly, no
    graph) and returns it with the state, whose step count reads the
    steps taken."""
    cfg, tree, _ = _setup("dense")
    monkeypatch.setattr(Model, "init", lambda self, gen:
                        convert.params_from_numpy(cfg, tree, "cpu"))
    state, losses = loop.train(cfg, steps=N, batch=B, seq_len=S, lr=LR,
                               log=lambda _: None, device="cpu")
    prog = state.program
    assert isinstance(prog, loop.TrainProgram) and prog.graph is None
    assert prog.params is state.params
    assert prog.opt_state is state.opt_state
    assert int(state.opt_state.step) == state.step == N
    assert len(losses) == N and all(np.isfinite(losses))

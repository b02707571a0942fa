"""The port's trainer against the JAX package: ``Model.loss`` and its
gradient for every family, remat, AdamW, the train loop, the data
pipelines, checkpoints both ways, the launcher, and the kernel route's
refusal of autograd.

The same numpy weights (``test_torch_models._weights``) and batches go
to both packages.  The loss is held to 1e-5 and every gradient leaf to
1e-4 in float32 (the frameworks sum in other orders; the hybrid family's
Mamba2 blocks carry rounding further, as its forward does in
``test_torch_models.py``).
"""
import dataclasses
import io
import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import ArchConfig as JArchConfig  # noqa: E402
from repro.data import pipeline as jpipeline  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro.train import checkpoint as jckpt  # noqa: E402
from repro.train import loop as jloop  # noqa: E402
from repro.train.optimizer import AdamW as JAdamW  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.base import reduced  # noqa: E402
from repro_torch.configs.registry import ARCHS  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train import loop  # noqa: E402
from repro_torch.train.optimizer import AdamW, AdamWState  # noqa: E402

from test_torch_models import _weights  # noqa: E402

B, S = 2, 16
LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
# one arch a family, reduced
FAMILIES = {"dense": "granite-3-2b", "vlm": "llava-next-34b",
            "moe": "qwen3-moe-30b-a3b", "ssm": "xlstm-1.3b",
            "hybrid": "zamba2-7b", "encdec": "whisper-medium"}


def _cfg(arch, **repl):
    return dataclasses.replace(reduced(ARCHS[arch]), **repl)


def _jax_tree(tree):
    return jax.tree.map(jnp.asarray, tree)


def _batch(cfg, seed=0):
    """Tokens, labels (two masked with -1) and the stub frontends' inputs,
    as numpy."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, (B, S), dtype=np.int32)
    labels = rng.integers(0, cfg.vocab, (B, S), dtype=np.int32)
    labels[0, 3] = labels[1, -1] = -1
    out = {"tokens": tokens, "labels": labels}
    if cfg.family == "vlm":
        out["patches"] = rng.standard_normal(
            (B, cfg.n_image_tokens, cfg.d_model), dtype=np.float32)
    if cfg.family == "encdec":
        out["frames"] = rng.standard_normal(
            (B, cfg.n_frames, cfg.d_model), dtype=np.float32)
    return out


def _torch_batch(batch):
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32
            else torch.from_numpy(v) for k, v in batch.items()}


def _port_loss_and_grads(cfg, tree, batch):
    model = Model(cfg, "cpu")
    params = convert.params_from_numpy(cfg, tree, "cpu")
    leaves = jax.tree.leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    loss = model.loss(params, _torch_batch(batch))
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), grads, jax.tree.structure(params)


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               err_msg=msg, **tol)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_loss_and_grads_match_jax(family):
    """``Model.loss`` and the gradient of every parameter leaf against
    ``jax.value_and_grad(Model.loss)`` on the JAX ``"ref"`` route."""
    cfg = _cfg(FAMILIES[family])
    tree = _weights(cfg, 11)
    batch = _batch(cfg, 12)
    jm = JModel(JArchConfig(**convert.arch_to_fields(cfg)))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want, jgrads = jax.value_and_grad(jm.loss)(_jax_tree(tree), jb)
    got, grads, struct = _port_loss_and_grads(cfg, tree, batch)
    _close(got, want, LOSS_TOL, "loss")
    jleaves, jstruct = jax.tree.flatten(jgrads)
    assert jstruct == struct
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(jgrads)[0]]
    for path, g, jg in zip(paths, grads, jleaves):
        _close(g, jg, GRAD_TOL, path)


@pytest.mark.parametrize("family", ["dense", "encdec", "hybrid"])
def test_remat_changes_no_number(family):
    """``cfg.remat`` recomputes each block in the backward pass: under
    policy ``"full"`` and ``"dots"`` the loss and every gradient equal
    those without it, bitwise."""
    cfg = _cfg(FAMILIES[family])
    tree = _weights(cfg, 13)
    batch = _batch(cfg, 14)
    off = _port_loss_and_grads(cfg, tree, batch)
    on = _port_loss_and_grads(dataclasses.replace(cfg, remat=True), tree,
                              batch)
    assert torch.equal(off[0], on[0])
    for a, b in zip(off[1], on[1]):
        assert torch.equal(a, b)
    dots = _port_loss_and_grads(
        dataclasses.replace(cfg, remat=True, remat_policy="dots"), tree,
        batch)
    assert torch.equal(off[0], dots[0])
    for a, b in zip(off[1], dots[1]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_remat_dots_matches_jax(family):
    """``remat_policy="dots"``: the loss and every gradient within the
    trainer's tolerances of ``jax.value_and_grad`` of the JAX model under
    its ``"dots"`` policy (bitwise ``"full"``'s: ``test_remat_changes_no_
    number``)."""
    cfg = _cfg(FAMILIES[family], remat=True, remat_policy="dots")
    tree = _weights(cfg, 16)
    batch = _batch(cfg, 17)
    got, grads, struct = _port_loss_and_grads(cfg, tree, batch)
    jm = JModel(JArchConfig(**convert.arch_to_fields(cfg)))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want, jgrads = jax.value_and_grad(jm.loss)(_jax_tree(tree), jb)
    _close(got, want, LOSS_TOL, "loss")
    jleaves, jstruct = jax.tree.flatten(jgrads)
    assert jstruct == struct
    for g, jg in zip(grads, jleaves):
        _close(g, jg, GRAD_TOL)


def test_remat_dots_saves_the_matmuls():
    """Under ``"dots"`` the backward recomputes fewer ``aten.mm`` than under
    ``"full"`` (their outputs are saved), and no fewer ``aten.bmm`` (the
    einsum products, recomputed by both), counted with a dispatch mode."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = {"mm": 0, "bmm": 0}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = func._overloadpacket.__name__
            if name in self.n:
                self.n[name] += 1
            return func(*args, **(kwargs or {}))

    def backward_counts(policy):
        cfg = _cfg("granite-3-2b", remat=True, remat_policy=policy)
        model = Model(cfg, "cpu")
        params = convert.params_from_numpy(cfg, _weights(cfg, 18), "cpu")
        leaves = jax.tree.leaves(params)
        for t in leaves:
            t.requires_grad_(True)
        loss = model.loss(params, _torch_batch(_batch(cfg, 19)))
        with Count() as c:
            torch.autograd.grad(loss, leaves)
        return c.n

    full, dots = backward_counts("full"), backward_counts("dots")
    assert dots["mm"] < full["mm"]
    assert dots["bmm"] == full["bmm"]


def test_remat_skips_forwards_without_grad(monkeypatch):
    """A forward that takes no gradient (a served one: parameters that do
    not require grad) runs its blocks directly under ``remat``; a loss
    whose parameters require grad recomputes every block."""
    import repro_torch.models.model as M
    cfg = _cfg("granite-3-2b", remat=True)
    tree = _weights(cfg, 15)
    calls = []

    def recording(fn, *args, use_reentrant):
        calls.append(use_reentrant)
        return fn(*args)
    monkeypatch.setattr(M, "checkpoint", recording)
    model = Model(cfg, "cpu")
    params = convert.params_from_numpy(cfg, tree, "cpu")
    model.forward(params, {"tokens": torch.zeros((1, 4), dtype=torch.long)})
    assert calls == []
    _port_loss_and_grads(cfg, tree, _batch(cfg, 16))
    assert calls == [False] * cfg.n_layers


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_jax(moment_dtype):
    """Two AdamW updates on the same gradients, from the same state: the
    parameters and moments within 1e-6 of the reference's."""
    rng = np.random.default_rng(21)

    def tree(scale):
        return {"a": {"w": rng.standard_normal((3, 4, 5), np.float32)
                      * scale, "ln": rng.standard_normal((3, 5), np.float32)
                      * scale},
                "embed": rng.standard_normal((7, 5), np.float32) * scale}
    params, g1, g2 = tree(1.0), tree(0.1), tree(0.1)
    jopt = JAdamW(lr=3e-3, moment_dtype=moment_dtype)
    opt = AdamW(lr=3e-3, moment_dtype=moment_dtype)
    jp, js = _jax_tree(params), jopt.init(_jax_tree(params))
    tp = jax.tree.map(torch.from_numpy, params)
    ts = opt.init(tp)
    for g in (g1, g2):
        jp, js = jopt.update(_jax_tree(g), js, jp)
        tp, ts = opt.update(jax.tree.map(torch.from_numpy, g), ts, tp)
    assert isinstance(ts, AdamWState) and int(ts.step) == int(js.step) == 2
    tol = dict(rtol=1e-6, atol=1e-6)
    for got, want in ((tp, jp), (ts.mu, js.mu), (ts.nu, js.nu)):
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            np.testing.assert_allclose(a.float().numpy(),
                                       np.asarray(b, np.float32), **tol)


@pytest.mark.parametrize("family", ["dense", "encdec"])
def test_train_matches_jax(family, monkeypatch):
    """Three steps of ``train`` in both packages from the same weights
    (each package's ``Model.init`` replaced by the numpy tree): the
    losses within 1e-5.  The final parameters agree within 1e-4 but where
    a gradient is near zero: there AdamW's normalised step
    ``mhat / sqrt(vhat)`` turns the two frameworks' rounding of that
    gradient into a step of up to ``lr`` either way, so such an element
    may part by up to ``2·lr`` a step (1 of 131,072 in one leaf here); at
    most 1e-4 of a leaf's elements may."""
    cfg = _cfg(FAMILIES[family])
    tree = _weights(cfg, 16)
    monkeypatch.setattr(JModel, "init", lambda self, rng: _jax_tree(tree))
    monkeypatch.setattr(Model, "init", lambda self, gen:
                        convert.params_from_numpy(cfg, tree, "cpu"))
    jstate, jlosses = jloop.train(
        JArchConfig(**convert.arch_to_fields(cfg)), steps=3, batch=B,
        seq_len=S, lr=3e-3, log=lambda _: None)
    state, losses = loop.train(cfg, steps=3, batch=B, seq_len=S, lr=3e-3,
                               log=lambda _: None, device="cpu")
    np.testing.assert_allclose(losses, jlosses, **LOSS_TOL)
    assert state.step == jstate.step == 3
    for a, b in zip(jax.tree.leaves(state.params),
                    jax.tree.leaves(jstate.params)):
        a, b = a.detach().numpy(), np.asarray(b)
        diff = np.abs(a - b)
        assert diff.max() <= 2 * 3e-3 * 3
        assert (diff > 1e-4 + 1e-4 * np.abs(b)).mean() <= 1e-4


@pytest.mark.parametrize("kind", ["SyntheticLM", "FastSyntheticLM"])
def test_pipelines_are_bitwise_the_reference(kind):
    kw = dict(vocab=97, seq_len=12, batch=3, seed=5)
    ours = getattr(pipeline, kind)(**kw).batches(start_step=2)
    theirs = getattr(jpipeline, kind)(**kw).batches(start_step=2)
    for _ in range(3):
        a, b = next(ours), next(theirs)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


def test_checkpoints_cross_between_the_packages(tmp_path):
    """Parameters the port writes load with the reference's ``ckpt.load``
    into a JAX tree, and the reference's load in the port; bf16 tensors
    are written as the float32 of their values."""
    cfg = _cfg("whisper-medium")
    tree = _weights(cfg, 17)
    params = convert.params_from_numpy(cfg, tree, "cpu")
    ckpt.save(str(tmp_path / "port"), params)
    back = jckpt.load(str(tmp_path / "port"), _jax_tree(tree))
    assert jax.tree.structure(back) == jax.tree.structure(_jax_tree(tree))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)
    jckpt.save(str(tmp_path / "jax"), _jax_tree(tree))
    mine = ckpt.load(str(tmp_path / "jax"), params)
    for a, b in zip(jax.tree.leaves(mine), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)
    p16 = convert.params_from_numpy(cfg, tree, "cpu", torch.bfloat16)
    ckpt.save(str(tmp_path / "bf16"), p16)
    back = ckpt.load(str(tmp_path / "bf16"), p16)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(p16)):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, b.float().numpy())


def test_launch_train_runs_on_the_host(tmp_path):
    """``python -m repro_torch.launch.train --device cpu`` trains the
    reduced variant and writes its checkpoint in the reference's format."""
    out = io.StringIO()
    path = str(tmp_path / "ck")
    with contextlib.redirect_stdout(out):
        launch_train.main(["--arch", "granite-3-2b", "--device", "cpu",
                           "--steps", "3", "--batch", "2", "--seq", "16",
                           "--ckpt", path])
    lines = out.getvalue().splitlines()
    assert lines[-1].startswith("final loss") and "after 3 steps" in lines[-1]
    cfg = reduced(ARCHS["granite-3-2b"])
    like = Model(cfg, "cpu").param_shapes()
    like = jax.tree.map(np.zeros, like,
                        is_leaf=lambda s: isinstance(s, tuple))
    loaded = ckpt.load(path, like)
    assert all(np.isfinite(a).all() for a in jax.tree.leaves(loaded))


def test_kernel_dispatch_refuses_autograd():
    """The check every kernel dispatch makes on the card before its
    launch: grad mode on and a floating input that requires grad is
    refused, with the kernel named; without grad mode, or without such
    an input, it passes.  The plain versions (the CPU route) stay
    differentiable."""
    x = torch.randn(2, 8, requires_grad=True)
    scale = torch.ones(8)
    assert ops.refuses_grad(x, scale)
    assert not ops.refuses_grad(x.detach(), scale)
    with torch.no_grad():
        assert not ops.refuses_grad(x, scale)
    with pytest.raises(RuntimeError, match="rmsnorm.*forward-only"):
        ops._check_forward_only("rmsnorm", x, scale)
    ops._check_forward_only("rmsnorm", x.detach(), scale)
    y = ops.rmsnorm(x, scale)             # CPU: the plain version
    (g,) = torch.autograd.grad(y.square().sum(), x)
    assert torch.isfinite(g).all() and g.abs().sum() > 0

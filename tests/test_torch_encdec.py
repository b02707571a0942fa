"""The port's encdec family (whisper-medium) against the JAX package.

Reduced whisper-medium (2 encoder and 2 decoder layers, d_model 128, 16
frames): the same numpy weights and frames go to the JAX ``Model`` and
the port's, through ``forward``, ``prefill`` and teacher-forced
``decode_step``s (``test_torch_models._check_model``).  ``"ref"`` is held
to the JAX ``"ref"`` route and ``"kernel"`` (the plain versions on the
CPU: the flash kernel's in the encoder and the decoder's self-attention,
flash decode's in the decoder's decode step) to the JAX ``"pallas"``
route in interpret mode, within 1e-5 in float32.  At whisper's published
1,500 frames the JAX ``"pallas"`` route cannot run (its block of 128
rows must divide the sequence), so the card's full-width golden comes
from JAX ``"ref"`` (``tests/golden/regen_torch_port_model.py``).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs.base import ArchConfig as JArchConfig  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.base import reduced  # noqa: E402
from repro_torch.configs.registry import ARCHS  # noqa: E402
from repro_torch.core.task import ModelProfile  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.serve.engine import ServableModel  # noqa: E402

from test_torch_models import _check_model, _weights  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


def _cfg(**repl):
    return dataclasses.replace(reduced(ARCHS["whisper-medium"]), **repl)


@pytest.mark.parametrize("impl", ["ref", "kernel"])
def test_whisper_matches_jax(impl):
    """forward, prefill and teacher-forced decode of reduced
    whisper-medium: ``"ref"`` against JAX ``"ref"``, ``"kernel"`` against
    JAX ``"pallas"`` (interpret mode)."""
    cfg = _cfg(attn_impl=impl)
    assert cfg.family == "encdec" and cfg.n_frames == 16 \
        and cfg.enc_layers == 2 and cfg.sliding_window == 0
    _check_model(cfg, tol=TOL)


def test_whisper_layout_and_params_from_numpy():
    """The encdec tree (``enc_blocks``, ``enc_norm``, ``blocks`` with the
    ``x_`` cross projections and ``ln3``) crosses ``params_from_numpy``
    and back unchanged, equal in shape to the JAX ``Model.init`` tree;
    ``enc_norm.scale`` is drawn at random, as the reference's init draws
    it (its constant rule matches ``ln*`` names only)."""
    import jax
    cfg = _cfg()
    tree = _weights(cfg, 3)
    assert set(tree) == {"embed", "final_norm", "enc_blocks", "enc_norm",
                         "blocks"}
    assert {"ln3", "x_wq", "x_wk", "x_wv", "x_wo"} <= set(tree["blocks"])
    jinit = JModel(JArchConfig(**convert.arch_to_fields(cfg))).init(
        jax.random.PRNGKey(0))
    shapes = jax.tree.map(lambda a: a.shape, jinit)
    assert shapes == jax.tree.map(lambda a: a.shape, tree)
    assert float(np.asarray(jinit["enc_norm"]["scale"]).std()) > 0
    back = convert.params_to_numpy(convert.params_from_numpy(cfg, tree,
                                                             "cpu"))
    for group in ("enc_blocks", "enc_norm", "blocks"):
        assert back[group].keys() == tree[group].keys()
        for name, val in tree[group].items():
            np.testing.assert_array_equal(back[group][name], val)
    fresh = convert.random_numpy_params(cfg, 0)
    assert (fresh["blocks"]["ln3"] == 1).all()
    assert fresh["enc_norm"]["scale"].std() > 0
    init = Model(cfg, "cpu").init(torch.Generator().manual_seed(0))
    assert torch.equal(init["enc_blocks"]["ln1"],
                       torch.ones(cfg.enc_layers, cfg.d_model))
    assert init["enc_norm"]["scale"].std() > 0


def test_whisper_cache_holds_the_cross_kv():
    """``prefill`` stores each decoder layer's cross K/V, the encoder's
    output through ``x_wk``/``x_wv``, in the cache the JAX package's
    prefill fills."""
    cfg = _cfg()
    tree = _weights(cfg, 4)
    frames = np.random.default_rng(5).standard_normal(
        (2, cfg.n_frames, cfg.d_model), dtype=np.float32)
    tokens = np.random.default_rng(6).integers(0, cfg.vocab, (2, 8),
                                               dtype=np.int32)
    jm = JModel(JArchConfig(**convert.arch_to_fields(cfg)))
    jp = {k: ({kk: jnp.asarray(vv) for kk, vv in v.items()}
              if isinstance(v, dict) else jnp.asarray(v))
          for k, v in tree.items()}
    _, jcache = jm.prefill(jp, {"tokens": jnp.asarray(tokens),
                                "frames": jnp.asarray(frames)}, 12)
    tm = Model(cfg, "cpu")
    _, tcache = tm.prefill(convert.params_from_numpy(cfg, tree, "cpu"),
                           {"tokens": torch.from_numpy(tokens).long(),
                            "frames": torch.from_numpy(frames)}, 12)
    assert set(tcache) == set(jcache) == {"k", "v", "xk", "xv"}
    for name in tcache:
        assert tuple(tcache[name].shape) == jcache[name].shape
        np.testing.assert_allclose(tcache[name].numpy(),
                                   np.asarray(jcache[name]), **TOL)


def test_from_arch_serves_whisper_with_frames():
    """``ServableModel.from_arch`` gives an encdec model zero frames of
    (batch, n_frames, d_model), as the reference does, and serves it."""
    cfg = _cfg()
    prof = ModelProfile(name="W", beta=1.0, deadline=1.0, t_edge=1.0,
                        t_cloud=1.0, cost_edge=1, cost_cloud=1,
                        qoe_beta=1.0, qoe_alpha=0.9, qoe_window=1.0)
    sm = ServableModel.from_arch(prof, cfg, batch=2, seq=8, device="cpu")
    logits = sm.run()
    assert logits.shape == (2, 8, Model(cfg, "cpu").vpad)
    assert torch.isfinite(logits[..., :cfg.vocab]).all()

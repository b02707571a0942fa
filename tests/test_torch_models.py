"""The port's model zoo (dense, vlm, xLSTM and hybrid families) against
the JAX package (the moe and encdec families' tests, in
``test_torch_moe.py`` and ``test_torch_encdec.py``, use this file's
``_check_model``).

The same weights — a numpy tree from ``repro_torch.convert.
random_numpy_params``, its norm scales and biases perturbed so that they
count — go to the JAX ``Model`` and, through ``convert.
params_from_numpy``, to the port's; the same tokens go through
``forward``, ``prefill`` and teacher-forced ``decode_step``s on both.
Logits agree to 1e-4 in float32, the JAX package's own bar for its
kernel path (``tests/test_kernels.py``): the two frameworks sum in other
orders.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs.base import ArchConfig as JArchConfig  # noqa: E402
from repro.configs.base import reduced as jreduced  # noqa: E402
from repro.configs.registry import ARCHS as JARCHS  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.base import reduced  # noqa: E402
from repro_torch.configs.registry import ARCHS  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
B, S, PROMPT, MAX_SEQ = 2, 32, 24, 40


def _cfg(arch, **repl):
    return dataclasses.replace(reduced(ARCHS[arch]), **repl)


def _weights(cfg, seed=0):
    """The numpy tree, with unit scales and zero biases perturbed."""
    tree = convert.random_numpy_params(cfg, seed)
    rng = np.random.default_rng(seed + 1)

    def perturb(sub):
        for name, val in sub.items():
            if isinstance(val, dict):
                perturb(val)
            elif name.startswith(("ln", "final_norm", "b", "dt_bias",
                                  "a_log", "d_skip")):
                sub[name] = (val + 0.1 * rng.standard_normal(
                    val.shape, dtype=np.float32)).astype(np.float32)
    perturb(tree)
    return tree


def _pair(cfg, seed=0):
    """(JAX model, JAX params, port model, port params, tokens)."""
    tree = _weights(cfg, seed)
    jmodel = JModel(JArchConfig(**convert.arch_to_fields(cfg)))
    jparams = {k: ({kk: jnp.asarray(vv) for kk, vv in v.items()}
                   if isinstance(v, dict) else jnp.asarray(v))
               for k, v in tree.items()}
    tmodel = Model(cfg, "cpu")
    tparams = convert.params_from_numpy(cfg, tree, "cpu")
    tokens = np.random.default_rng(seed + 2).integers(
        0, cfg.vocab, (B, S), dtype=np.int32)
    return jmodel, jparams, tmodel, tparams, tokens


def _close(got, want, msg="", tol=TOL):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want),
                               err_msg=msg, **tol)


def _check_model(cfg, seed=0, tol=TOL):
    jm, jp, tm, tp, tokens = _pair(cfg, seed)
    batch_j = {"tokens": jnp.asarray(tokens)}
    batch_t = {"tokens": torch.from_numpy(tokens).long()}
    if cfg.family == "vlm":
        patches = np.random.default_rng(seed + 3).standard_normal(
            (B, cfg.n_image_tokens, cfg.d_model), dtype=np.float32)
        batch_j["patches"] = jnp.asarray(patches)
        batch_t["patches"] = torch.from_numpy(patches)
    if cfg.family == "encdec":
        frames = np.random.default_rng(seed + 3).standard_normal(
            (B, cfg.n_frames, cfg.d_model), dtype=np.float32)
        batch_j["frames"] = jnp.asarray(frames)
        batch_t["frames"] = torch.from_numpy(frames)
    want, want_aux = jm.forward(jp, batch_j)
    got, aux = tm.forward(tp, batch_t)
    assert got.shape == (B, S, tm.vpad) and aux.dtype == torch.float32
    _close(got, want, "forward", tol)
    _close(aux, want_aux, "aux", tol)      # zero but for the moe family

    pre = {k: v[:, :PROMPT] if k == "tokens" else v
           for k, v in batch_j.items()}
    want_last, jcache = jm.prefill(jp, pre, MAX_SEQ)
    got_last, tcache = tm.prefill(
        tp, {k: v[:, :PROMPT] if k == "tokens" else v
             for k, v in batch_t.items()}, MAX_SEQ)
    _close(got_last, want_last, "prefill", tol)
    # teacher-forced decode over the rest of the tokens; the port's cache
    # is updated in place, the JAX one returned anew
    offset = cfg.n_image_tokens if cfg.family == "vlm" else 0
    for t in range(PROMPT, S):
        want_t, jcache = jm.decode_step(jp, jcache,
                                        jnp.asarray(tokens[:, t:t + 1]),
                                        jnp.asarray(t + offset, jnp.int32))
        got_t, tcache2 = tm.decode_step(
            tp, tcache, torch.from_numpy(tokens[:, t:t + 1]).long(),
            t + offset)
        assert tcache2 is tcache
        _close(got_t, want_t, f"decode at {t}", tol)


@pytest.mark.parametrize("sliding_window", [16, 0],
                         ids=["window16", "full"])
def test_granite_matches_jax(sliding_window):
    """Reduced granite-3-2b: its 16-key band (ring-buffer decode cache) as
    ``reduced`` sets it, and full causal attention (contiguous cache)."""
    _check_model(_cfg("granite-3-2b", sliding_window=sliding_window,
                      long_context_window=sliding_window))


def test_starcoder2_matches_jax():
    """Reduced starcoder2-3b: QKV bias, tanh-GELU MLP, GQA, window 16."""
    cfg = _cfg("starcoder2-3b")
    assert cfg.qkv_bias and cfg.act == "gelu" and cfg.sliding_window == 16
    _check_model(cfg)


def test_xlstm_matches_jax():
    """Reduced xlstm-1.3b: one mLSTM and one sLSTM block (no attention)."""
    cfg = _cfg("xlstm-1.3b")
    assert cfg.family == "ssm" and cfg.slstm_every == 2
    _check_model(cfg)


def test_llava_vlm_matches_jax():
    """Reduced llava-next-34b: image-patch projection before the text."""
    _check_model(_cfg("llava-next-34b"))


@pytest.mark.parametrize("sliding_window", [16, 0],
                         ids=["window16", "full"])
def test_kernel_path_matches_jax_pallas(sliding_window):
    """``attn_impl="kernel"`` in the port against ``"pallas"`` in the JAX
    package (interpret mode): forward through flash attention, decode
    through flash decode when the cache is contiguous."""
    _check_model(_cfg("granite-3-2b", attn_impl="kernel",
                      sliding_window=sliding_window,
                      long_context_window=sliding_window))


def test_kernel_and_ref_paths_agree_in_the_port():
    ref_cfg = _cfg("starcoder2-3b", sliding_window=0, long_context_window=0)
    tree = _weights(ref_cfg, 5)
    tokens = torch.from_numpy(np.random.default_rng(6).integers(
        0, ref_cfg.vocab, (B, S))).long()
    out = {}
    for impl in ("ref", "kernel"):
        cfg = dataclasses.replace(ref_cfg, attn_impl=impl)
        model = Model(cfg, "cpu")
        params = convert.params_from_numpy(cfg, tree, "cpu")
        logits, _ = model.forward(params, {"tokens": tokens})
        _, cache = model.prefill(params, {"tokens": tokens[:, :PROMPT]},
                                 MAX_SEQ)
        step, _ = model.decode_step(params, cache,
                                    tokens[:, PROMPT:PROMPT + 1], PROMPT)
        out[impl] = (logits, step)
    for a, b in zip(out["ref"], out["kernel"]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_attend_kernel_matches_attend():
    """The (B,S,H,hd) layout adapter around the kernel equals the plain
    ``attend`` it replaces."""
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.standard_normal((2, 32, 8, 64), np.float32))
    k = torch.from_numpy(rng.standard_normal((2, 32, 2, 64), np.float32))
    v = torch.from_numpy(rng.standard_normal((2, 32, 2, 64), np.float32))
    for window in (0, 16):
        torch.testing.assert_close(
            L.attend_kernel(q, k, v, causal=True, window=window),
            L.attend(q, k, v, causal=True, window=window),
            rtol=1e-6, atol=1e-6)


def test_params_round_trip_through_numpy():
    cfg = _cfg("starcoder2-3b")
    tree = _weights(cfg, 9)
    params = convert.params_from_numpy(cfg, tree, "cpu")
    back = convert.params_to_numpy(params)
    assert back.keys() == tree.keys()
    for name, val in tree.items():
        if isinstance(val, dict):
            assert back[name].keys() == val.keys()
            for sub in val:
                np.testing.assert_array_equal(back[name][sub], val[sub])
        else:
            np.testing.assert_array_equal(back[name], val)
    # bf16 parameters come back as the float32 of their bf16 values
    p16 = convert.params_from_numpy(cfg, tree, "cpu", torch.bfloat16)
    assert p16["blocks"]["wq"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        convert.params_to_numpy(p16)["embed"],
        torch.from_numpy(tree["embed"]).bfloat16().float().numpy())


def test_params_from_numpy_checks_the_tree():
    cfg = _cfg("granite-3-2b")
    tree = _weights(cfg)
    tree["blocks"]["wq"] = tree["blocks"]["wq"][:, :, :1]
    with pytest.raises(ValueError, match="wq"):
        convert.params_from_numpy(cfg, tree, "cpu")
    tree = _weights(cfg)
    del tree["blocks"]["ln2"]
    with pytest.raises(ValueError, match="blocks"):
        convert.params_from_numpy(cfg, tree, "cpu")


def test_configs_match_the_reference():
    """The port's registry and ``reduced`` equal the JAX package's field
    for field, with ``attn_impl`` "pallas" ↔ "kernel"."""
    assert ARCHS.keys() == JARCHS.keys()
    for name, cfg in ARCHS.items():
        fields = convert.arch_to_fields(cfg)
        assert fields == dataclasses.asdict(JARCHS[name])
        assert convert.arch_to_fields(reduced(cfg)) == dataclasses.asdict(
            jreduced(JARCHS[name]))
        assert (convert.arch_from_fields(JARCHS[name]) == cfg)
    pallas = dataclasses.replace(JARCHS["granite-3-2b"], attn_impl="pallas")
    assert convert.arch_from_fields(pallas).attn_impl == "kernel"


def test_model_init_from_a_generator():
    """``init(generator)`` draws the JAX scheme's shapes: the parameter
    tree ``params_from_numpy`` checks against, reproducible per seed."""
    cfg = _cfg("granite-3-2b")
    model = Model(cfg, "cpu")
    a = model.init(torch.Generator().manual_seed(3))
    b = model.init(torch.Generator().manual_seed(3))
    back = convert.params_from_numpy(cfg, convert.params_to_numpy(a), "cpu")
    torch.testing.assert_close(back["blocks"]["wg"], b["blocks"]["wg"],
                               rtol=0, atol=0)
    assert torch.equal(a["final_norm"], torch.ones(cfg.d_model))


# ---------------------------------------------------------------------------
# the hybrid family (Zamba2)
# ---------------------------------------------------------------------------

# Five Mamba2 blocks carry f32 rounding further than attention blocks do:
# each output sums a state accumulated over the whole chunk.  Against a
# float64 run of the same weights the JAX model's forward is 8.7e-5 off
# and the port's 1.5e-4 (the "tail" variant), so the two are held to
# 5e-4, not 1e-4.
HYBRID_TOL = dict(rtol=5e-4, atol=5e-4)
HYBRID = {
    # reduced zamba2-7b: attn_every 1, 2 layers, a 16-key band, so decode
    # runs on the ring cache (plain decode attention on both routes)
    "reduced": {},
    # attn_every 2 over 5 layers (two groups and a 1-layer tail), full
    # causal attention, so "kernel" decodes through flash decode
    "tail": dict(attn_every=2, n_layers=5, sliding_window=0,
                 long_context_window=0),
}


@pytest.mark.parametrize("impl", ["ref", "kernel"])
@pytest.mark.parametrize("variant", list(HYBRID))
def test_hybrid_matches_jax(variant, impl):
    """forward, prefill and teacher-forced decode of reduced zamba2-7b
    against the JAX ``Model`` (``"kernel"`` against ``"pallas"`` in
    interpret mode): the port's kernel route runs its scans through the
    selective scan and its norms through the fused RMSNorm, where the
    JAX model runs ``ssd_chunked`` and the plain norm."""
    cfg = _cfg("zamba2-7b", attn_impl=impl, **HYBRID[variant])
    model = Model(cfg, "cpu")
    assert ("mamba_tail" in model.layout()) == (variant == "tail")
    _check_model(cfg, tol=HYBRID_TOL)


def test_hybrid_params_round_trip_through_numpy():
    cfg = _cfg("zamba2-7b", **HYBRID["tail"])
    tree = _weights(cfg, 4)
    assert set(tree) == {"embed", "final_norm", "lm_head", "mamba",
                         "mamba_tail", "shared_attn"}
    back = convert.params_to_numpy(convert.params_from_numpy(cfg, tree,
                                                             "cpu"))
    for group in ("mamba", "mamba_tail", "shared_attn"):
        assert back[group].keys() == tree[group].keys()
        for name, val in tree[group].items():
            np.testing.assert_array_equal(back[group][name], val)
    # the JAX scheme's constants: unit D skips, zero dt biases and a_log
    fresh = convert.random_numpy_params(cfg, 0)["mamba"]
    assert (fresh["d_skip"] == 1).all() and (fresh["a_log"] == 0).all() \
        and (fresh["dt_bias"] == 0).all()
    init = Model(cfg, "cpu").init(torch.Generator().manual_seed(0))
    assert torch.equal(init["mamba_tail"]["d_skip"], torch.ones(1, 8))
    assert not init["mamba"]["a_log"].any()


def test_zamba2_published_size_layout():
    """zamba2-7b at its published width and depth: 13 groups of 6 Mamba2
    layers with the shared block after each, a 3-layer tail, ~6.8 B
    parameters, shared attention at hd 112 (shapes only; nothing is
    allocated)."""
    cfg = ARCHS["zamba2-7b"]
    model = Model(cfg, "cpu")
    shapes = model.param_shapes()
    assert shapes["mamba"]["w_in"][0] == 78
    assert shapes["mamba_tail"]["w_in"][0] == 3
    assert shapes["shared_attn"]["wq"] == (3584, 32, 112)
    count = sum(int(np.prod(s)) for group in shapes.values()
                for s in (group.values() if isinstance(group, dict)
                          else [group]))
    assert 6.7e9 < count < 6.9e9

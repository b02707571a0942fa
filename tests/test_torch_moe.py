"""The port's MoE family — the grouped-GEMM kernel's plain version, the
router, capacity dispatch, the MoE MLP and the model — against the JAX
package.

The same numpy inputs go through the JAX Pallas kernel in interpret mode
(``repro.kernels.ops.moe_gemm``), the JAX oracle (``repro.kernels.ref``),
the JAX MoE layer (``repro.models.moe``) and model, and the port, whose
dispatch runs the plain PyTorch versions on CPU tensors.  Tolerances:
the grouped GEMM 1e-4 in float32 and 3e-2 in bfloat16 (against the f32
oracle), as ``tests/test_kernels.py`` states them; routing integers
(experts, slots, keep) exactly; the MoE MLP 1e-5 in float32; the model
1e-4, the bar of ``tests/test_torch_models.py``.  Routing tests override
``reduced``'s capacity factor of 8.0 with the published 1.25, so that
pairs really drop.  The hand-written CUDA kernel is held against the
plain version on the card (marked ``cuda``; it skips without one).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_torch_models import _check_model, _weights  # noqa: E402

from repro.configs.base import ArchConfig as JArchConfig  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import moe as JMOE  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.base import reduced  # noqa: E402
from repro_torch.configs.registry import ARCHS  # noqa: E402
from repro_torch.kernels import moe_gemm as tmoe  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.models import moe as MOE  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402

GEMM_TOL = dict(rtol=1e-4, atol=1e-4)
BF16_TOL = dict(rtol=3e-2, atol=3e-2)
MLP_TOL = dict(rtol=1e-5, atol=1e-5)
MOE_ARCHS = ["qwen3-moe-30b-a3b", "grok-1-314b"]


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      np.asarray(x, np.float32), np.float32)


def _gemm_inputs(t, d, f, e, seed):
    """x (T,D), w (E,D,F) / sqrt(D) and a random ragged split of T rows
    over E experts (some may be empty), as numpy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((t, d), dtype=np.float32)
    w = rng.standard_normal((e, d, f), dtype=np.float32) / np.sqrt(d)
    cuts = np.sort(rng.integers(0, t + 1, e - 1))
    offsets = np.concatenate([[0], cuts, [t]]).astype(np.int32)
    return x, w.astype(np.float32), offsets


def _moe_cfg(arch, **repl):
    return dataclasses.replace(reduced(ARCHS[arch]), capacity_factor=1.25,
                               **repl)


# ---------------------------------------------------------------------------
# the grouped GEMM's plain version
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("t,d,f,e,block_t", [
    (256, 64, 128, 4, 128),
    (512, 128, 64, 8, 128),
    (128, 32, 32, 3, 64),
])
def test_ref_moe_gemm_matches_jax(t, d, f, e, block_t):
    """``tests/test_kernels.py``'s sweep: the port's plain version against
    the JAX oracle and the Pallas kernel in interpret mode."""
    x, w, off = _gemm_inputs(t, d, f, e, seed=t + d + f + e)
    got = tops.moe_gemm(torch.from_numpy(x), torch.from_numpy(w),
                        torch.from_numpy(off))
    np.testing.assert_allclose(
        _np(got), np.asarray(jref.ref_moe_gemm(x, w, jnp.asarray(off))),
        **GEMM_TOL)
    np.testing.assert_allclose(
        _np(got), np.asarray(jops.moe_gemm(
            jnp.asarray(x), jnp.asarray(w), jnp.asarray(off),
            block_t=block_t, interpret=True)), **GEMM_TOL)


def test_ref_moe_gemm_empty_experts():
    t, d, f, e = 128, 32, 32, 4
    x, w, _ = _gemm_inputs(t, d, f, e, seed=0)
    off = np.array([0, 0, t, t, t], np.int32)         # only expert 1
    got = _np(tops.moe_gemm(torch.from_numpy(x), torch.from_numpy(w),
                            torch.from_numpy(off)))
    np.testing.assert_allclose(got, x @ w[1], **GEMM_TOL)
    np.testing.assert_allclose(got, np.asarray(jops.moe_gemm(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(off), block_t=64,
        interpret=True)), **GEMM_TOL)


def test_ref_moe_gemm_bf16():
    """bf16 in, bf16 out, against the f32 oracle at 3e-2 (and the Pallas
    kernel's bf16 result)."""
    t, d, f, e = 256, 64, 64, 4
    x, w, _ = _gemm_inputs(t, d, f, e, seed=1)
    off = np.array([0, 64, 128, 192, 256], np.int32)
    xb, wb = torch.from_numpy(x).bfloat16(), torch.from_numpy(w).bfloat16()
    got = tops.moe_gemm(xb, wb, torch.from_numpy(off))
    assert got.dtype == torch.bfloat16
    want = jref.ref_moe_gemm(jnp.asarray(_np(xb)), jnp.asarray(_np(wb)),
                             jnp.asarray(off))
    np.testing.assert_allclose(_np(got), np.asarray(want), **BF16_TOL)
    pallas = jops.moe_gemm(jnp.asarray(_np(xb), jnp.bfloat16),
                           jnp.asarray(_np(wb), jnp.bfloat16),
                           jnp.asarray(off), block_t=64, interpret=True)
    np.testing.assert_allclose(_np(got), np.asarray(pallas, np.float32),
                               **BF16_TOL)


def test_uncovered_rows_zero_in_kernel_clipped_in_ref():
    """Rows before offsets[0] or from offsets[E] on: ``_moe_kernel`` gives
    zeros (its accumulator starts at zero and no expert's mask holds),
    the oracles clip them to expert 0 or E−1.  The port's kernel follows
    ``_moe_kernel`` (checked on the card), its plain version the oracle;
    on covered rows all agree."""
    t, d, f, e = 128, 32, 16, 3
    x, w, _ = _gemm_inputs(t, d, f, e, seed=2)
    off = np.array([16, 40, 40, 100], np.int32)
    kernel = np.asarray(jops.moe_gemm(jnp.asarray(x), jnp.asarray(w),
                                      jnp.asarray(off), block_t=64,
                                      interpret=True))
    plain = _np(tops.moe_gemm(torch.from_numpy(x), torch.from_numpy(w),
                              torch.from_numpy(off)))
    np.testing.assert_allclose(
        plain, np.asarray(jref.ref_moe_gemm(x, w, jnp.asarray(off))),
        **GEMM_TOL)
    assert not kernel[:16].any() and not kernel[100:].any()
    np.testing.assert_allclose(plain[:16], x[:16] @ w[0], **GEMM_TOL)
    np.testing.assert_allclose(plain[100:], x[100:] @ w[2], **GEMM_TOL)
    np.testing.assert_allclose(plain[16:100], kernel[16:100], **GEMM_TOL)


# ---------------------------------------------------------------------------
# router, capacity dispatch, the MoE MLP
# ---------------------------------------------------------------------------

def _layer_params(cfg, seed=0):
    """Layer 0 of a perturbed numpy tree, as (JAX dict, port dict)."""
    tree = _weights(cfg, seed)["blocks"]
    layer = {k: v[0] for k, v in tree.items()}
    return ({k: jnp.asarray(v) for k, v in layer.items()},
            {k: torch.from_numpy(v) for k, v in layer.items()})


def _jcfg(cfg):
    return JArchConfig(**convert.arch_to_fields(cfg))


@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_router_matches_jax(arch, groups):
    cfg = _moe_cfg(arch)
    jp, tp = _layer_params(cfg, 3)
    x = np.random.default_rng(4).standard_normal(
        (groups, 24, cfg.d_model), dtype=np.float32)
    wj, ej, aj = jax.vmap(lambda xg: JMOE.router(jp, xg, _jcfg(cfg)))(
        jnp.asarray(x))
    wt, et, at = MOE.router(tp, torch.from_numpy(x), cfg)
    np.testing.assert_array_equal(et.numpy(), np.asarray(ej))
    np.testing.assert_allclose(_np(wt), np.asarray(wj), **MLP_TOL)
    np.testing.assert_allclose(_np(at), np.asarray(aj), **MLP_TOL)


def test_router_ties_go_to_the_lower_expert():
    """``jax.lax.top_k`` breaks ties toward the lower index; so does the
    port's stable descending sort."""
    cfg = _moe_cfg("qwen3-moe-30b-a3b")
    d, e = cfg.d_model, cfg.n_experts
    router_w = np.zeros((d, e), np.float32)          # every logit equal
    x = np.ones((1, 3, d), np.float32)
    _, ej, _ = jax.vmap(lambda xg: JMOE.router(
        {"router": jnp.asarray(router_w)}, xg, _jcfg(cfg)))(jnp.asarray(x))
    _, et, _ = MOE.router({"router": torch.from_numpy(router_w)},
                          torch.from_numpy(x), cfg)
    np.testing.assert_array_equal(et.numpy(), np.asarray(ej))
    assert et[0, 0].tolist() == list(range(cfg.top_k))


@pytest.mark.parametrize("capacity", [1, 3, 40])
def test_capacity_dispatch_matches_jax(capacity):
    """Slots and keep flags equal the JAX package's exactly, per group,
    with pairs dropped at capacities 1 and 3."""
    rng = np.random.default_rng(capacity)
    g, t, k, e = 2, 20, 2, 4
    experts = np.stack([np.stack([rng.choice(e, k, replace=False)
                                  for _ in range(t)]) for _ in range(g)])
    sj, kj = jax.vmap(lambda ex: JMOE.capacity_dispatch(ex, e, capacity))(
        jnp.asarray(experts, jnp.int32))
    st, kt = MOE.capacity_dispatch(torch.from_numpy(experts), e, capacity)
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    np.testing.assert_array_equal(kt.numpy(), np.asarray(kj))
    assert kt.all() == (capacity == 40)


def test_buffer_is_expert_major_and_sorted():
    """Kept pairs land on distinct rows of the (E·g·C, D) buffer, expert
    e's rows all inside [e·g·C, (e+1)·g·C), the constant offsets."""
    rng = np.random.default_rng(5)
    g, t, k, e, c = 2, 16, 2, 4, 5
    experts = torch.from_numpy(np.stack([np.stack(
        [rng.choice(e, k, replace=False) for _ in range(t)])
        for _ in range(g)]))
    slot, keep = MOE.capacity_dispatch(experts, e, c)
    rows = MOE._buffer_rows(slot, c, g)
    kept = rows[keep]
    assert len(set(kept.tolist())) == len(kept)
    ex = experts.reshape(g, -1)
    assert ((rows // (g * c)) == ex).all()
    gi = torch.arange(g)[:, None].expand_as(rows)
    assert (((rows % (g * c)) // c) == gi).all()
    off = MOE._offsets(e, g * c, "cpu")
    assert off.dtype == torch.int32 and off.tolist() == [
        i * g * c for i in range(e + 1)]
    assert MOE._offsets(e, g * c, "cpu") is off       # built once a shape


@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("impl", ["ref", "kernel"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_mlp_matches_jax(arch, impl, groups):
    """(y, aux) of the MoE MLP against the JAX layer at capacity factor
    1.25 (pairs drop): silu experts (qwen3, 3 GEMMs) and gelu (grok, 2),
    1 and 2 dispatch groups, the plain einsums and the grouped-GEMM
    route."""
    cfg = _moe_cfg(arch, attn_impl=impl, moe_groups=groups)
    jp, tp = _layer_params(cfg, 6)
    # shifted inputs skew the routing, so that experts overflow
    x = np.random.default_rng(7).standard_normal(
        (2, 12, cfg.d_model), dtype=np.float32) + np.float32(1.0)
    yj, aj = JMOE.moe_mlp(jp, _jcfg(cfg), jnp.asarray(x))
    yt, at = MOE.moe_mlp(tp, cfg, torch.from_numpy(x))
    np.testing.assert_allclose(_np(yt), np.asarray(yj), **MLP_TOL)
    np.testing.assert_allclose(_np(at), np.asarray(aj), **MLP_TOL)
    # the capacity really dropped pairs
    tg = 24 // groups
    cap = int(tg * cfg.top_k / cfg.n_experts * cfg.capacity_factor) + 1
    _, experts, _ = MOE.router(tp, torch.from_numpy(x).reshape(
        groups, tg, -1), cfg)
    _, keep = MOE.capacity_dispatch(experts, cfg.n_experts, cap)
    assert not keep.all()


def test_moe_groups_shrink_by_halves():
    """moe_groups 4 on 6 tokens halves to 2 groups, as the JAX loop does;
    the groups change the result (capacity is per group)."""
    base = _moe_cfg("qwen3-moe-30b-a3b")
    jp, tp = _layer_params(base, 8)
    x = np.random.default_rng(9).standard_normal(
        (1, 6, base.d_model), dtype=np.float32)
    out = {}
    for groups in (1, 4):
        cfg = dataclasses.replace(base, moe_groups=groups)
        yj, _ = JMOE.moe_mlp(jp, _jcfg(cfg), jnp.asarray(x))
        yt, _ = MOE.moe_mlp(tp, cfg, torch.from_numpy(x))
        np.testing.assert_allclose(_np(yt), np.asarray(yj), **MLP_TOL)
        out[groups] = _np(yt)
    assert not np.allclose(out[1], out[4])


def test_kernel_route_calls_the_gemm_per_expert_product(monkeypatch):
    """Under ``"kernel"`` every expert product goes through
    ``ops.moe_gemm`` on the expert-major buffer with the constant
    offsets: 3 calls a layer for silu experts and 2 for gelu, in forward,
    prefill and each decode step."""
    calls = []
    real = tops.moe_gemm

    def spy(x, w, off):
        calls.append((tuple(x.shape), tuple(w.shape), off.tolist()))
        return real(x, w, off)
    monkeypatch.setattr(tops, "moe_gemm", spy)
    for arch, per_layer in (("qwen3-moe-30b-a3b", 3), ("grok-1-314b", 2)):
        cfg = _moe_cfg(arch, attn_impl="kernel")
        model = Model(cfg, "cpu")
        params = convert.params_from_numpy(
            cfg, convert.random_numpy_params(cfg, 0), "cpu")
        tokens = torch.from_numpy(np.random.default_rng(1).integers(
            0, cfg.vocab, (2, 8))).long()
        calls.clear()
        model.forward(params, {"tokens": tokens})
        assert len(calls) == per_layer * cfg.n_layers
        cap = int(16 * cfg.top_k / cfg.n_experts * cfg.capacity_factor) + 1
        e = cfg.n_experts
        assert calls[0] == ((e * cap, cfg.d_model),
                            (e, cfg.d_model, cfg.d_ff_expert),
                            [i * cap for i in range(e + 1)])
        calls.clear()
        _, cache = model.prefill(params, {"tokens": tokens[:, :6]}, 12)
        model.decode_step(params, cache, tokens[:, 6:7], 6)
        assert len(calls) == 2 * per_layer * cfg.n_layers


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("capacity_factor", [8.0, 1.25],
                         ids=["dropless", "drops"])
@pytest.mark.parametrize("impl", ["ref", "kernel"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_model_matches_jax(arch, impl, capacity_factor):
    """forward (with its router aux), prefill and teacher-forced decode of
    reduced qwen3-moe and grok-1 against the JAX ``Model``
    (``"kernel"`` against ``"pallas"``, whose MoE runs the einsums): at
    ``reduced``'s dropless capacity and at 1.25, where forward, prefill
    and each decode step drop pairs at their own capacities."""
    cfg = dataclasses.replace(reduced(ARCHS[arch]), attn_impl=impl,
                              capacity_factor=capacity_factor,
                              sliding_window=0, long_context_window=0)
    assert Model(cfg, "cpu").layout()["blocks"][0]["router"] == (
        cfg.d_model, cfg.n_experts)
    _check_model(cfg, seed=11)


def test_moe_params_round_trip_through_numpy():
    cfg = reduced(ARCHS["grok-1-314b"])
    tree = _weights(cfg, 12)
    assert set(tree["blocks"]) == {"ln1", "ln2", "wq", "wk", "wv", "wo",
                                   "router", "we_i", "we_d"}
    back = convert.params_to_numpy(convert.params_from_numpy(cfg, tree,
                                                             "cpu"))
    for name, val in tree["blocks"].items():
        np.testing.assert_array_equal(back["blocks"][name], val)
    qcfg = reduced(ARCHS["qwen3-moe-30b-a3b"])
    shapes = Model(qcfg, "cpu").param_shapes()["blocks"]
    e, d, f = qcfg.n_experts, qcfg.d_model, qcfg.d_ff_expert
    assert {k: shapes[k] for k in ("router", "we_g", "we_u", "we_d")} == {
        "router": (2, d, e), "we_g": (2, e, d, f), "we_u": (2, e, d, f),
        "we_d": (2, e, f, d)}
    init = Model(qcfg, "cpu").init(torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(
        convert.params_to_numpy(init)["blocks"]["we_g"].shape, (2, e, d, f))


def test_expert_split_is_refused():
    """``expert_split`` -1 ("auto") is resolved against a mesh by the dry
    run and refused by a model, as is a split that does not divide
    d_ff_expert; a split that divides builds (the split layout)."""
    base = reduced(ARCHS["grok-1-314b"])
    with pytest.raises(ValueError, match="auto"):
        Model(dataclasses.replace(base, expert_split=-1), "cpu")
    with pytest.raises(ValueError, match="does not divide"):
        Model(dataclasses.replace(base, expert_split=3), "cpu")
    shapes = Model(dataclasses.replace(base, expert_split=2),
                   "cpu").param_shapes()["blocks"]
    e, d, fe = base.n_experts, base.d_model, base.d_ff_expert
    assert shapes["we_i"] == (2, 2 * e, d, fe // 2)
    assert shapes["we_d"] == (2, 2 * e, fe // 2, d)


def _split_params(blk: dict, cfg, s: int) -> dict:
    """The JAX test's rearrangement of unsplit expert weights into the
    split layout: up (E, D, Fe) → (E·s, D, Fe/s) with split j the columns
    [j·Fe/s, (j+1)·Fe/s), down (E, Fe, D) → (E·s, Fe/s, D)."""
    e, d, fe = cfg.n_experts, cfg.d_model, cfg.d_ff_expert
    out = dict(blk)
    for key in ("we_g", "we_u") if cfg.act == "silu" else ("we_i",):
        out[key] = blk[key].reshape(e, d, s, fe // s).transpose(
            0, 2, 1, 3).reshape(e * s, d, fe // s)
    out["we_d"] = blk["we_d"].reshape(e * s, fe // s, d)
    return out


@pytest.mark.parametrize("impl", ["ref", "kernel"])
@pytest.mark.parametrize("split", [2, 4])
@pytest.mark.parametrize("arch", ["grok-1-314b", "qwen3-moe-30b-a3b"])
def test_expert_split_matches_jax_and_unsplit(arch, split, impl):
    """The split-expert layer against the JAX ``moe_mlp`` on the same split
    weights, and against the port's unsplit layer on the weights they
    were rearranged from, within the JAX test's 1e-4; ``"kernel"`` runs
    the grouped GEMM's plain version here (one call a split up, one down
    on the (E, s·Fe/s, D) view).  d_ff_expert is rounded down to a
    multiple of 8 so that every split divides it (reduced grok's 682)."""
    cfg = reduced(ARCHS[arch])
    cfg = dataclasses.replace(cfg, attn_impl=impl,
                              d_ff_expert=cfg.d_ff_expert // 8 * 8)
    split_cfg = dataclasses.replace(cfg, expert_split=split)
    tree = _weights(cfg, 21)
    blk = {k: v[0] for k, v in tree["blocks"].items()}
    sblk = _split_params(blk, cfg, split)
    x = np.random.default_rng(22).standard_normal(
        (2, 16, cfg.d_model), dtype=np.float32) * np.float32(0.3)
    jcfg = JArchConfig(**convert.arch_to_fields(split_cfg))
    want, want_aux = JMOE.moe_mlp({k: jnp.asarray(v) for k, v in
                                   sblk.items()}, jcfg, jnp.asarray(x))
    got, aux = MOE.moe_mlp({k: torch.from_numpy(v) for k, v in sblk.items()},
                           split_cfg, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **GEMM_TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), **GEMM_TOL)
    unsplit, _ = MOE.moe_mlp({k: torch.from_numpy(v) for k, v in blk.items()},
                             cfg, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), unsplit.numpy(), **GEMM_TOL)


def test_qwen3_moe_published_size_layout():
    """qwen3-moe-30b-a3b at its published width and depth: 48 layers of
    128 experts (d 2048, d_ff_expert 768), 30.5 B parameters, 61 GB in
    bf16, which fits one 80 GB card (shapes only; nothing allocated)."""
    cfg = ARCHS["qwen3-moe-30b-a3b"]
    shapes = Model(cfg, "cpu").param_shapes()
    assert shapes["blocks"]["we_g"] == (48, 128, 2048, 768)
    assert shapes["embed"] == (152064, 2048)
    count = sum(int(np.prod(s)) for group in shapes.values()
                for s in (group.values() if isinstance(group, dict)
                          else [group]))
    assert 30.4e9 < count < 30.7e9 and 2 * count < 62e9


# ---------------------------------------------------------------------------
# dispatch, and the hand kernel on the card
# ---------------------------------------------------------------------------

def test_moe_gemm_wrapper_takes_plain_path_only_on_cpu():
    before = tmoe.launch_count
    x, w = torch.ones(4, 8), torch.ones(2, 8, 3)
    off = torch.tensor([0, 2, 4], dtype=torch.int32)
    tops.moe_gemm(x, w, off)
    assert tmoe.launch_count == before
    with pytest.raises(ValueError, match="CUDA"):
        tmoe.cuda_moe_gemm(x, w, off)
    with pytest.raises(ValueError, match="CUDA"):
        tops.moe_gemm(x.to("meta"), w.to("meta"), off.to("meta"))
    assert tmoe.launch_count == before
    tmoe.reset_count()
    assert tmoe.launch_count == 0


@pytest.mark.parametrize("t,d,f,e,want", [
    (768, 2048, 768, 128, "TC"),        # qwen3-moe serve, we_g
    (768, 768, 2048, 128, "TC"),        # we_d
    (10369, 2048, 768, 128, "TC"),      # prefill (with the trash row)
    (256, 64, 128, 4, "TC"),
    (77, 33, 17, 3, "CORE"),            # D and F off the vector width
    (64, 72, 36, 4, "CORE"),            # F off it
    (64, 36, 72, 4, "CORE"),            # D off it
])
def test_moe_route_bf16(t, d, f, e, want):
    # the route reads metadata only: meta tensors, nothing allocated
    x = torch.empty(t, d, dtype=torch.bfloat16, device="meta")
    w = torch.empty(e, d, f, dtype=torch.bfloat16, device="meta")
    assert tmoe.tc_route(x, w) == getattr(tmoe, want)


@pytest.mark.parametrize("t,d,f,e", [(768, 2048, 768, 128), (256, 64, 128, 4),
                                     (77, 33, 17, 3)])
def test_moe_route_f32_takes_cuda_cores(t, d, f, e):
    x = torch.empty(t, d, device="meta")
    w = torch.empty(e, d, f, device="meta")
    assert tmoe.tc_route(x, w) == tmoe.CORE


def test_moe_route_unaligned_start_takes_cuda_cores():
    """A contiguous bf16 x or w that starts off a 16-byte boundary (a
    storage offset off a multiple of 8) goes to the CUDA-core body, which
    reads it element by element."""
    x = torch.zeros(65 * 64 + 4, dtype=torch.bfloat16)[4:].view(65, 64)
    w = torch.zeros(4, 64, 128, dtype=torch.bfloat16)
    assert x.is_contiguous() and tmoe.tc_route(x, w) == tmoe.CORE
    w2 = torch.zeros(4 * 64 * 128 + 2, dtype=torch.bfloat16)[2:].view(
        4, 64, 128)
    assert tmoe.tc_route(x[1:], w2) == tmoe.CORE
    assert tmoe.tc_route(torch.zeros(64, 64, dtype=torch.bfloat16)[8:],
                         w) == tmoe.TC


@pytest.mark.parametrize("t,e,want", [
    (0, 128, 1), (1, 128, 1), (129, 128, 1),      # decode: 1 row an expert
    (769, 128, 1),                                # serve: 6
    (128 * 16 + 1, 128, 2), (128 * 32, 128, 2),
    (128 * 48, 128, 4), (128 * 64, 128, 4),
    (10369, 128, 8),                              # prefill: 81
    (128 * 200, 128, 8),                          # more loops over tiles
    (251, 8, 2), (2080, 16, 8),
])
def test_moe_row_tiles(t, e, want):
    """The tensor-core body's row tile: ⌈T/E/16⌉ m16 tiles rounded up to
    1, 2, 4 or 8."""
    assert tmoe.row_tiles(t, e) == want


def test_moe_and_flash_route_of_the_model_views(monkeypatch):
    """The tensors a bf16 qwen3-moe forward under ``"kernel"`` (reduced
    depth, published head dim 128) hands ``ops.flash_attention`` and
    ``ops.moe_gemm`` take the tensor-core routes, 3 GEMMs a layer; the
    same model in f32 takes the CUDA cores."""
    from repro_torch.kernels import flash_attention as tflash
    seen = []
    real_f, real_m = tops.flash_attention, tops.moe_gemm

    def spy_f(q, k, v, **kw):
        seen.append(("flash", q.dtype, tflash.tc_route(q, k, v)))
        return real_f(q, k, v, **kw)

    def spy_m(x, w, off):
        seen.append(("moe", x.dtype, tmoe.tc_route(x.contiguous(),
                                                   w.contiguous())))
        return real_m(x, w, off)
    monkeypatch.setattr(tops, "flash_attention", spy_f)
    monkeypatch.setattr(tops, "moe_gemm", spy_m)
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, 512, (2, 16))).long()
    for dtype, want in (("bfloat16", tmoe.TC), ("float32", tmoe.CORE)):
        cfg = dataclasses.replace(
            reduced(ARCHS["qwen3-moe-30b-a3b"], d_model=512),
            attn_impl="kernel", dtype=dtype, param_dtype=dtype)
        assert cfg.head_dim == 128 and cfg.d_ff_expert % 8 == 0
        model = Model(cfg, "cpu")
        seen.clear()
        model.forward(model.init(torch.Generator().manual_seed(0)),
                      {"tokens": tokens})
        td = getattr(torch, dtype)
        assert sorted(seen) == sorted(
            [("flash", td, want)] * cfg.n_layers
            + [("moe", td, want)] * (3 * cfg.n_layers))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_moe_gemm_matches_plain(cuda_device, dtype):
    """The kernel against the plain version on the card on the JAX tests'
    sweep, a ragged T, empty experts and qwen3's decode shape; uncovered
    rows are exactly zero."""
    td = getattr(torch, dtype)
    tol = GEMM_TOL if dtype == "float32" else BF16_TOL
    cases = [(256, 64, 128, 4), (512, 128, 64, 8), (128, 32, 32, 3),
             (203, 72, 40, 5), (77, 33, 17, 3), (128, 2048, 768, 128),
             (768, 2048, 768, 128), (768, 768, 2048, 128),
             (648, 2048, 768, 8), (1040, 200, 136, 8)]
    for t, d, f, e in cases:
        x, w, off = (torch.from_numpy(a).to(cuda_device)
                     for a in _gemm_inputs(t, d, f, e, seed=t + e))
        x, w = x.to(td), w.to(td)
        want = tref.ref_moe_gemm(x.float(), w.float(), off)
        before = tmoe.tc_launch_count
        got = tops.moe_gemm(x, w, off)
        assert tmoe.tc_launch_count - before == (
            tmoe.tc_route(x, w) == tmoe.TC)
        torch.testing.assert_close(got.float(), want, **tol)
        if dtype == "bfloat16":         # the previous CUDA-core body
            got = tmoe.cuda_moe_gemm(x, w, off, _route=tmoe.CORE)
            torch.testing.assert_close(got.float(), want, **tol)
    x, w, _ = (torch.from_numpy(a).to(cuda_device)
               for a in _gemm_inputs(128, 32, 16, 3, seed=2))
    off = torch.tensor([16, 40, 40, 100], dtype=torch.int32,
                       device=cuda_device)
    got = tops.moe_gemm(x.to(td), w.to(td), off)
    assert not got[:16].any() and not got[100:].any()
    want = tref.ref_moe_gemm(x.to(td).float(), w.to(td).float(), off)
    torch.testing.assert_close(got[16:100].float(), want[16:100], **tol)

"""The port's prefill as programs (``PrefillProgram``, one a prompt shape,
writing into a ``DecodeProgram``'s cache) against the JAX package's
jitted prefill.

For each served family at the reduced size (2 layers, d 128, vocab 512;
``test_torch_decode_program.py``'s cases) on ``"kernel"`` (the plain
versions on the CPU), and one case on ``"ref"``, the same weights and
prompt (numpy, from a seed) go to ``jax.jit(lambda p, b: model.prefill(
p, b, max_seq))`` and to a ``PrefillProgram`` over a ``DecodeProgram``'s
cache (its body, eagerly, on the CPU): the logits and every cache leaf
within ``tests/test_torch_models.py``'s tolerance.  The program's logits
and cache are also an eager ``Model.prefill`` into a fresh cache bit for
bit, and so is a second prompt of the same shape prefilled into the
cache after decode steps have written it (past a window-16 ring's wrap
and a full cache's last slot): the body zeroes the cache first, as the
reference builds its cache fresh.  Every cache leaf keeps its address.
A second prompt shape adds a key; a repeated one does not.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import ArchConfig as JArchConfig  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.launch.dryrun import ShapeMesh  # noqa: E402
from repro_torch.launch.sharding import sharding_rules  # noqa: E402
from repro_torch.models.model import (DecodeProgram, Model,  # noqa: E402
                                      PrefillProgram)

from test_torch_decode_program import (B, CASES, PROMPT, STEPS,  # noqa: E402
                                       _case, _equal_trees, _inputs)
from test_torch_models import HYBRID_TOL, TOL, _close, _weights  # noqa: E402


def _batches(cfg, seed, prompt=PROMPT):
    """The prompt's inputs for the JAX and the port's models, and the
    tokens that follow it."""
    tokens, extra = _inputs(cfg, seed)
    jb = {"tokens": jnp.asarray(tokens[:, :prompt]),
          **{k: jnp.asarray(v) for k, v in extra.items()}}
    tb = {"tokens": torch.from_numpy(tokens[:, :prompt]).long(),
          **{k: torch.from_numpy(v) for k, v in extra.items()}}
    return jb, tb, tokens


def _ptrs(cache: dict) -> dict:
    return {k: v.data_ptr() for k, v in cache.items()}


CASE_IMPLS = [(c, "kernel") for c in CASES] + [("dense-window16", "ref")]


@pytest.mark.parametrize("case,impl", CASE_IMPLS,
                         ids=[f"{c}-{i}" for c, i in CASE_IMPLS])
def test_prefill_program_matches_jax_jitted_prefill(case, impl):
    cfg, max_seq = _case(case, impl)
    tree = _weights(cfg, 11)
    jm = JModel(JArchConfig(**convert.arch_to_fields(cfg)))
    jp = jax.tree.map(jnp.asarray, tree)
    tm = Model(cfg, "cpu")
    tp = convert.params_from_numpy(cfg, tree, "cpu")
    tol = HYBRID_TOL if cfg.family == "hybrid" else TOL

    decode = DecodeProgram(tm, tp, tm.init_cache(B, max_seq))
    program = PrefillProgram(tm, tp, decode.cache)
    ptrs = _ptrs(decode.cache)
    jb, tb, tokens = _batches(cfg, 12)
    got = program(tb)
    want, jcache = jax.jit(lambda p, b: jm.prefill(p, b, max_seq))(jp, jb)
    _close(got, want, f"{case} {impl}: logits", tol)
    assert decode.cache.keys() == jcache.keys()
    for k, leaf in decode.cache.items():
        _close(leaf, jcache[k], f"{case} {impl}: cache {k}", tol)
    eager, fresh = tm.prefill(tp, tb, max_seq)
    assert torch.equal(got, eager) and _equal_trees(decode.cache, fresh)

    # decode steps write the cache (a ring's wrap, a full cache's clamp)
    offset = cfg.n_image_tokens if cfg.family == "vlm" else 0
    for t in range(PROMPT, PROMPT + STEPS):
        decode(torch.from_numpy(tokens[:, t:t + 1]).long(), t + offset)
    assert not _equal_trees(decode.cache, fresh)
    # a second request of the same shape, into the used cache
    _, tb2, _ = _batches(cfg, 13)
    got2 = program(tb2)
    eager2, fresh2 = tm.prefill(tp, tb2, max_seq)
    assert not torch.equal(got2, got)
    assert torch.equal(got2, eager2), f"{case} {impl}: second logits"
    assert _equal_trees(decode.cache, fresh2), f"{case} {impl}: second cache"
    assert _ptrs(decode.cache) == ptrs
    assert program.shape_keys == {program.key(tb)}
    assert program.replays == 0 and not program.graphs      # the CPU


@pytest.mark.parametrize("case", ["dense-window16", "vlm"])
def test_prompt_shapes_add_keys(case):
    """Prompts of 8, 12 and 8 tokens: two keys, each call bitwise an
    eager prefill into a fresh cache."""
    cfg, max_seq = _case(case, "kernel")
    model = Model(cfg, "cpu")
    params = convert.params_from_numpy(cfg, _weights(cfg, 3), "cpu")
    program = PrefillProgram(model, params, model.init_cache(B, max_seq))
    for seed, prompt in ((4, 8), (5, PROMPT), (6, 8)):
        _, tb, _ = _batches(cfg, seed, prompt)
        got = program(tb)
        eager, fresh = model.prefill(params, tb, max_seq)
        assert torch.equal(got, eager) and _equal_trees(program.cache, fresh)
    keys = program.shape_keys
    assert len(keys) == 2
    assert {k[0][1] for k in keys} == {(B, 8), (B, PROMPT)}
    names = ("tokens", "patches") if cfg.family == "vlm" else ("tokens",)
    assert all(tuple(n for n, _, _ in k) == names for k in keys)


def test_prefill_program_refuses_a_mesh_and_another_batch():
    cfg, max_seq = _case("dense-window16", "ref")
    model = Model(cfg, "cpu")
    params = model.init(torch.Generator().manual_seed(0))
    cache = model.init_cache(B, max_seq)
    with sharding_rules(ShapeMesh({"data": 2, "model": 2})):
        with pytest.raises(RuntimeError, match="mesh"):
            PrefillProgram(model, params, cache)
    program = PrefillProgram(model, params, cache)
    assert program.max_seq == cache["k"].shape[2]
    for bad in (torch.zeros((B + 1, 4), dtype=torch.long),
                torch.zeros((B * 4,), dtype=torch.long)):
        with pytest.raises(ValueError, match="tokens of shape"):
            program({"tokens": bad})
    assert not program.shape_keys
    logits = program({"tokens": torch.zeros((B, 4), dtype=torch.long)})
    assert logits.shape == (B, 1, model.vpad)

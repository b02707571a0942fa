"""The port's decode step as one program (``DecodeProgram``) and its
position as a device scalar, against the JAX package's jitted step.

For each served family at the reduced size (2 layers, d 128, vocab 512)
on both routes, the same weights and tokens (numpy, from a seed) go to
the JAX ``Model`` and the port's: a prompt is prefilled on both (the
port's into ``program.cache``), then teacher-forced steps run through
``jax.jit(lambda p, c, t, pos: model.decode_step(p, c, t, pos))`` with
a traced int32 ``pos`` and through the ``DecodeProgram`` (its body,
eagerly, on the CPU), held to ``tests/test_torch_models.py``'s
tolerance.  Before each step the program's cache is cloned and an eager
``Model.decode_step`` at the host int ``pos`` runs on the clone: the
program's step, at its 0-d int32 position buffer, equals it bit for bit,
logits and cache.  The steps cross a sliding window's ring (window 16,
positions past 16) and a full cache's clamp (positions past W − 1).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import ArchConfig as JArchConfig  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.base import reduced  # noqa: E402
from repro_torch.configs.registry import ARCHS  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.model import DecodeProgram, Model  # noqa: E402

from test_torch_models import HYBRID_TOL, TOL, _close, _weights  # noqa: E402

B, PROMPT, STEPS = 2, 12, 8

# (arch, config changes, max_seq): the family's reduced config; a
# window of 16 whose ring the steps wrap (positions 12..19), and full
# caches of W 16 that the steps pass (the last slot overwritten from
# position 16 on)
CASES = {
    "dense-window16": ("granite-3-2b", dict(sliding_window=16,
                                            long_context_window=16), 24),
    "dense-clamp": ("granite-3-2b", dict(sliding_window=0,
                                         long_context_window=0), 16),
    "dense-qkv-bias": ("starcoder2-3b", {}, 24),
    "vlm": ("llava-next-34b", {}, 24),
    "moe": ("qwen3-moe-30b-a3b", {}, 16),
    "encdec": ("whisper-medium", {}, 16),
    "ssm": ("xlstm-1.3b", {}, 24),
    "hybrid-window16": ("zamba2-7b", {}, 24),
    "hybrid-clamp": ("zamba2-7b", dict(sliding_window=0,
                                       long_context_window=0), 16),
}


def _case(name, impl):
    arch, repl, max_seq = CASES[name]
    cfg = dataclasses.replace(
        reduced(ARCHS[arch], n_layers=2, d_model=128, vocab=512),
        attn_impl=impl)
    return dataclasses.replace(cfg, **repl), max_seq


def _inputs(cfg, seed):
    """Tokens (B, PROMPT + STEPS) and the stub frontends' inputs."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, (B, PROMPT + STEPS), dtype=np.int32)
    extra = {}
    if cfg.family == "vlm":
        extra["patches"] = rng.standard_normal(
            (B, cfg.n_image_tokens, cfg.d_model), dtype=np.float32)
    if cfg.family == "encdec":
        extra["frames"] = rng.standard_normal(
            (B, cfg.n_frames, cfg.d_model), dtype=np.float32)
    return tokens, extra


def _equal_trees(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("impl", ["ref", "kernel"])
@pytest.mark.parametrize("case", list(CASES))
def test_decode_program_matches_jax_jitted_step(case, impl):
    cfg, max_seq = _case(case, impl)
    tree = _weights(cfg, 11)
    tokens, extra = _inputs(cfg, 12)
    jm = JModel(JArchConfig(**convert.arch_to_fields(cfg)))
    jp = jax.tree.map(jnp.asarray, tree)
    tm = Model(cfg, "cpu")
    tp = convert.params_from_numpy(cfg, tree, "cpu")

    pre_j = {"tokens": jnp.asarray(tokens[:, :PROMPT]),
             **{k: jnp.asarray(v) for k, v in extra.items()}}
    pre_t = {"tokens": torch.from_numpy(tokens[:, :PROMPT]).long(),
             **{k: torch.from_numpy(v) for k, v in extra.items()}}
    want_last, jcache = jm.prefill(jp, pre_j, max_seq)
    program = DecodeProgram(tm, tp, tm.init_cache(B, max_seq))
    got_last, cache = tm.prefill(tp, pre_t, max_seq, cache=program.cache)
    assert cache is program.cache
    tol = HYBRID_TOL if cfg.family == "hybrid" else TOL
    _close(got_last, want_last, "prefill", tol)
    if cfg.family != "ssm":
        w = program.cache["k"].shape[2]
        assert w == (min(max_seq, 16) if cfg.sliding_window else max_seq)

    jstep = jax.jit(lambda p, c, t, pos: jm.decode_step(p, c, t, pos))
    offset = cfg.n_image_tokens if cfg.family == "vlm" else 0
    for t in range(PROMPT, PROMPT + STEPS):
        pos = t + offset
        tok = torch.from_numpy(tokens[:, t:t + 1]).long()
        twin = {k: v.clone() for k, v in program.cache.items()}
        eager, _ = tm.decode_step(tp, twin, tok, pos)
        got = program(tok, torch.tensor(pos, dtype=torch.int32))
        assert torch.equal(got, eager), f"{case} {impl}: step at {pos}"
        assert _equal_trees(program.cache, twin), f"cache at {pos}"
        want, jcache = jstep(jp, jcache, jnp.asarray(tokens[:, t:t + 1]),
                             jnp.asarray(pos, jnp.int32))
        _close(got, want, f"{case} {impl}: decode at {pos}", tol)
    if cfg.family != "ssm":
        # the steps passed the window's ring or the full cache's last slot
        assert PROMPT + STEPS + offset > program.cache["k"].shape[2]
    assert program.replays == 0 and program.graph is None   # the CPU


@pytest.mark.parametrize("pos", [5, 15, 16, 23],
                         ids=["inside", "last-slot", "wrap", "wrap-again"])
@pytest.mark.parametrize("window", [16, 0], ids=["ring", "full"])
def test_tensor_position_is_the_int_position_bitwise(window, pos):
    """One step at a 0-d tensor position (int32 and int64) against the
    same step at the host int, each on its own clone of a prefilled
    cache: logits and cache bit for bit, inside the cache, at its last
    slot and past it (a ring's wrap; a full cache's clamp)."""
    cfg, _ = _case("dense-window16" if window else "dense-clamp", "kernel")
    model = Model(cfg, "cpu")
    params = convert.params_from_numpy(cfg, _weights(cfg, 3), "cpu")
    tokens, _ = _inputs(cfg, 4)
    _, cache = model.prefill(
        params, {"tokens": torch.from_numpy(tokens[:, :4]).long()}, 16)
    tok = torch.from_numpy(tokens[:, 4:5]).long()
    runs = []
    for p in (pos, torch.tensor(pos, dtype=torch.int32), torch.tensor(pos)):
        c = {k: v.clone() for k, v in cache.items()}
        runs.append((model.decode_step(params, c, tok, p)[0], c))
    for logits, c in runs[1:]:
        assert torch.equal(logits, runs[0][0])
        assert _equal_trees(c, runs[0][1])


def test_cache_slot_wraps_and_clamps():
    pos = torch.arange(40, dtype=torch.int32)
    assert torch.equal(L.cache_slot(pos, 16, 16), pos % 16)
    assert torch.equal(L.cache_slot(pos, 16, 0), pos.clamp(max=15))
    row = torch.arange(2 * 3, dtype=torch.float32).reshape(2, 1, 3, 1)
    layer = torch.zeros(2, 4, 3, 1)
    L.write_slot(layer, torch.tensor(2), row)
    want = torch.zeros(2, 4, 3, 1)
    want[:, 2] = row[:, 0]
    assert torch.equal(layer, want)


def test_decode_program_refuses_another_token_shape():
    cfg, max_seq = _case("dense-window16", "ref")
    model = Model(cfg, "cpu")
    params = model.init(torch.Generator().manual_seed(0))
    program = DecodeProgram(model, params, model.init_cache(B, max_seq))
    assert tuple(program.token.shape) == (B, 1)
    assert program.pos.dtype == torch.int32 and program.pos.dim() == 0
    for bad in (torch.zeros((B + 1, 1), dtype=torch.long),
                torch.zeros((B, 2), dtype=torch.long),
                torch.zeros((B,), dtype=torch.long)):
        with pytest.raises(ValueError, match="token of shape"):
            program(bad, 3)
    with pytest.raises(ValueError, match="0-d integer tensor"):
        program(torch.zeros((B, 1), dtype=torch.long), torch.tensor([3]))
    logits = program(torch.zeros((B, 1), dtype=torch.long), 3)
    assert logits.shape == (B, 1, model.vpad)

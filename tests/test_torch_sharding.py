"""The port's launch layer against the JAX package: the logical-axis rule
engine (``launch/sharding.py``) decision for decision on shape-only
meshes, ``Model.param_specs`` for every arch, and the ten config
selector modules field for field.  Nothing here needs a process group:
the engine takes a shape-only mesh, as the JAX tests' stand-in is."""
import dataclasses
import importlib
import itertools

import pytest

torch = pytest.importorskip("torch")

from repro.configs import registry as JREG  # noqa: E402
from repro.launch import sharding as JS  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro_torch.configs import registry as TREG  # noqa: E402
from repro_torch.launch import sharding as TS  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402

from repro.configs.base import reduced as jreduced  # noqa: E402
from repro_torch.configs.base import reduced  # noqa: E402


class FakeMesh:
    """Shape-only mesh (``.shape`` a dict, ``.axis_names``)."""

    def __init__(self, **shape):
        self.shape = shape
        self.axis_names = tuple(shape)


MESHES = {"16x16": dict(data=16, model=16),
          "2x16x16": dict(pod=2, data=16, model=16),
          "2x2": dict(data=2, model=2),
          "1x1": dict(data=1, model=1)}
NAMES = sorted(JS.DEFAULT_RULES) + [None]
DIMS = (1, 2, 8, 24, 32, 56, 64, 4096)
# the JAX tests' shapes: 56 and 64 heads, the 5-D decode cache, logits
SHAPES = [((2, 128, 56, 128), ("batch", "seq", "heads", "head_dim")),
          ((2, 128, 64, 128), ("batch", "seq", "heads", "head_dim")),
          ((80, 128, 32768, 8, 128),
           (None, "batch", "kv_seq", "kv_heads", None)),
          ((2, 64, 4096, 4096), ("batch", "heads", "seq_model", None)),
          ((64, 4096), ("batch", "seq")),
          ((256, 4096), ("fleet", "act_seq"))]
ARCHS = sorted(TREG.ARCHS)
SELECTORS = ("granite_3_2b", "grok_1_314b", "llava_next_34b",
             "nemotron_4_340b", "qwen2_72b", "qwen3_moe_30b_a3b",
             "starcoder2_3b", "whisper_medium", "xlstm_1_3b", "zamba2_7b")


def test_default_rules_are_the_reference():
    assert TS.DEFAULT_RULES == JS.DEFAULT_RULES


@pytest.mark.parametrize("mesh", list(MESHES))
def test_rule_engine_decisions_match_jax(mesh):
    """``logical_to_pspec`` and ``resolves`` under ``sharding_rules`` on
    every logical name at a range of widths, alone and in pairs (one mesh
    axis a tensor), and on the JAX tests' shapes."""
    fake = FakeMesh(**MESHES[mesh])
    cases = [((d,), (n,)) for n in NAMES for d in DIMS]
    cases += [((d1, d2), (n1, n2))
              for n1, n2 in itertools.product(NAMES, NAMES)
              for d1, d2 in ((32, 64), (56, 4096), (16, 2))]
    cases += SHAPES
    with JS.sharding_rules(fake), TS.sharding_rules(fake):
        for shape, logical in cases:
            want = tuple(JS.logical_to_pspec(shape, logical))
            assert TS.logical_to_pspec(shape, logical) == want, \
                (shape, logical)
        for n in NAMES[:-1]:
            for d in DIMS:
                assert TS.resolves(d, n) == JS.resolves(d, n), (n, d)
    assert TS.logical_to_pspec((64,), ("batch",)) == ()
    assert not TS.resolves(64, "batch")


def test_placements_follow_the_assignment():
    """A per-dimension assignment as DTensor placements: two mesh axes on
    one dimension both shard it, an axis nobody names replicates."""
    from torch.distributed.tensor import Replicate, Shard
    fake = FakeMesh(pod=2, data=16, model=16)
    assert TS.placements((("pod", "data"), None, "model"), fake) == [
        Shard(0), Shard(0), Shard(2)]
    assert TS.placements((None, "model"), fake) == [
        Replicate(), Replicate(), Shard(1)]
    assert TS.named_sharding((56, 4096), ("heads", "seq"), FakeMesh(
        data=16, model=16)) == [Replicate(), Replicate()]
    x = torch.ones(3)
    with TS.sharding_rules(fake):
        assert TS.shard(x, "batch") is x
        assert TS.current_mesh() is fake
    assert TS.current_mesh() is None


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_jax(arch):
    """``Model.param_specs`` equals the JAX package's for every arch, at
    reduced size (the defs carry the axes; no parameter is built), and
    for the moe family's split-expert layout at published size."""
    cfg, jcfg = reduced(TREG.ARCHS[arch]), jreduced(JREG.ARCHS[arch])
    assert Model(cfg, "cpu").param_specs() == JModel(jcfg).param_specs()
    if cfg.family == "moe":
        split = dataclasses.replace(TREG.ARCHS[arch], expert_split=2)
        jsplit = dataclasses.replace(JREG.ARCHS[arch], expert_split=2)
        assert Model(split, "cpu").param_specs() == \
            JModel(jsplit).param_specs()
    specs = Model(cfg, "cpu").param_specs()
    shapes = Model(cfg, "cpu").param_shapes()

    def same_rank(s, sh):
        if isinstance(s, dict):
            for k in s:
                same_rank(s[k], sh[k])
        else:
            assert len(s) == len(sh)
    same_rank(specs, shapes)


@pytest.mark.parametrize("module", SELECTORS)
def test_config_modules_match_jax(module):
    """Each ``configs/<arch>.py`` selector's ``CONFIG`` and ``SMOKE`` equal
    the JAX module's, field for field."""
    port = importlib.import_module(f"repro_torch.configs.{module}")
    ref = importlib.import_module(f"repro.configs.{module}")
    for name in ("CONFIG", "SMOKE"):
        assert dataclasses.asdict(getattr(port, name)) == \
            dataclasses.asdict(getattr(ref, name)), name

"""The port's dry run on the moe, encdec, hybrid and ssm families'
reduced combos, traced on a (2, 2) fake mesh and held to the JAX dry
run's memory terms (``tests/torch_dryrun_combos.py``).

Three children start together at the first test: grok-1-314b,
qwen3-moe-30b-a3b, whisper-medium and zamba2-7b in one, xlstm-1.3b
(whose sLSTM steps one token at a time) train in another, its prefill
and decode in the third.  Each combo traces with the
model code that serves and trains on the card: the MoE dispatch and
combine on each rank's groups, xLSTM's log-sigmoid gates on each rank's
shards, AdamW whole where a leaf is split along its first dimension.
"""
import functools

import pytest

pytest.importorskip("torch")

from torch_dryrun_combos import (KINDS, check_combo, collect,  # noqa: E402
                                 golden, start)

GROUPS = ((("grok-1-314b", "qwen3-moe-30b-a3b", "whisper-medium",
            "zamba2-7b"), KINDS),
          (("xlstm-1.3b",), ("train_4k",)),
          (("xlstm-1.3b",), ("prefill_32k", "decode_32k")))
ARCHS = ("grok-1-314b", "qwen3-moe-30b-a3b", "whisper-medium", "zamba2-7b",
         "xlstm-1.3b")


@functools.lru_cache(maxsize=None)
def _results() -> dict:
    procs = [start(archs, kinds) for archs, kinds in GROUPS]
    out = {}
    for p in procs:
        out.update(collect(p))
    return out


def test_every_family_traces():
    """Every combo of these archs traces, one rank's program each."""
    r = _results()
    assert sorted(r) == sorted(f"{a}|{s}" for a in ARCHS for s in KINDS)
    for key, v in r.items():
        assert v["ok"] and v["n_devices"] == 4, key
        assert v["flops"] > 0 and v["n_collectives"] > 0, key


@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_combos_match_the_reference(arch):
    ref = golden()["reduced"]
    for shape in KINDS:
        key = f"{arch}|{shape}"
        check_combo(key, _results()[key], ref[key])

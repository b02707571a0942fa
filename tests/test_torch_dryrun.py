"""The port's dry run and roofline against the JAX package's helpers,
and one reduced combo of each kind traced on a (2, 2) fake mesh.

The helpers (``SKIPS``, ``n_micro_for``, ``delta_unit``, ``with_layers``,
``variant_for``, ``input_specs``, ``batch_logical``, ``cache_logical``,
``max_seq_for``) and the roofline arithmetic (``extrapolate``,
``RooflineTerms.build``, ``model_flops``) equal the JAX package's.  The
traced combos run in a subprocess (they start a fake process group):
reduced granite-3-2b, with the SHAPES cut to (seq 128, batch 8) for
train and (256, 4 / 8) for prefill and decode so that the trace stays a
few seconds.  Their FLOPs a device are held to the same steps run whole
on plain tensors, and those to ``model_flops``, within stated ratios.
"""
import dataclasses
import functools
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import registry as JREG  # noqa: E402
from repro.roofline import analysis as JRA  # noqa: E402
from repro_torch.configs import registry as TREG  # noqa: E402
from repro_torch.launch import mesh as TM  # noqa: E402
from repro_torch.roofline import analysis as TRA  # noqa: E402


def _import_jax_dryrun():
    """``repro.launch.dryrun`` appends a 512-device flag to ``XLA_FLAGS`` on
    import; the environment is put back so that later JAX processes of
    this worker are not changed by it."""
    import importlib

    import jax
    jax.devices()
    saved = os.environ.get("XLA_FLAGS")
    try:
        return importlib.import_module("repro.launch.dryrun")
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved


JD = _import_jax_dryrun()
from repro_torch.launch import dryrun as TD  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = sorted(TREG.ARCHS)


def _jax_dtype_name(dt) -> str:
    return np.dtype(dt).name


def test_tables_are_the_reference():
    assert TD.SHAPES == JD.SHAPES
    assert TD.SKIPS == JD.SKIPS
    assert (TD.BIG_OPT_THRESHOLD, TD.MICROBATCH_THRESHOLD) == \
        (JD.BIG_OPT_THRESHOLD, JD.MICROBATCH_THRESHOLD)


@pytest.mark.parametrize("arch", ARCHS)
def test_helpers_match_jax(arch):
    """Every per-(arch, shape) helper, with and without ``opt``."""
    for shape in TD.SHAPES:
        for opt in (False, True):
            cfg = TD.variant_for(TREG.ARCHS[arch], shape, opt=opt)
            jcfg = JD.variant_for(JREG.ARCHS[arch], shape, opt=opt)
            assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
            assert TD.n_micro_for(cfg, shape) == JD.n_micro_for(jcfg, shape)
            assert TD.max_seq_for(cfg, shape) == JD.max_seq_for(jcfg, shape)
            got, want = TD.input_specs(cfg, shape), JD.input_specs(jcfg,
                                                                   shape)
            assert list(got) == list(want)
            for k in got:
                assert got[k].shape == tuple(want[k].shape), k
                assert str(got[k].dtype).replace("torch.", "") == \
                    _jax_dtype_name(want[k].dtype), k
                assert TD.batch_logical(cfg, k) == JD.batch_logical(jcfg, k)
    cfg, jcfg = TREG.ARCHS[arch], JREG.ARCHS[arch]
    assert TD.delta_unit(cfg) == JD.delta_unit(jcfg)
    assert TD.full_depth_units(cfg) == JD.full_depth_units(jcfg)
    for units in (1, 2):
        assert dataclasses.asdict(TD.with_layers(cfg, units, True)) == \
            dataclasses.asdict(JD.with_layers(jcfg, units, True))


def test_cache_logical_matches_jax():
    for key in ("k", "v", "xk", "xv", "m_c", "m_n", "s_h", "s_c", "s_n",
                "state", "tail_state", "other"):
        for ndim in range(3, 7):
            assert TD.cache_logical(key, ndim) == JD.cache_logical(key, ndim)


def test_roofline_arithmetic_matches_jax(monkeypatch):
    """``extrapolate`` and ``model_flops`` equal JAX's; ``RooflineTerms``
    equals JAX's with the JAX module's constants set to the H100's (the
    port's hardware), terms and bottleneck."""
    for v1, v2, l1, l2, lf in ((3.0, 5.0, 1, 2, 40), (7.0, 6.0, 1, 2, 81 / 6),
                               (1e12, 3e12, 1, 2, 96.0)):
        assert TRA.extrapolate(v1, v2, l1, l2, lf) == \
            JRA.extrapolate(v1, v2, l1, l2, lf)
    for arch in ARCHS:
        for shape, (seq, batch, _) in TD.SHAPES.items():
            assert TRA.model_flops(TREG.ARCHS[arch], shape, seq, batch) == \
                JRA.model_flops(JREG.ARCHS[arch], shape, seq, batch)
    monkeypatch.setattr(JRA, "PEAK_FLOPS_BF16", TM.PEAK_FLOPS_BF16)
    monkeypatch.setattr(JRA, "HBM_BW", TM.HBM_BW)
    monkeypatch.setattr(JRA, "ICI_BW", TM.NVLINK_BW)
    for f, b, c in ((1e15, 1e9, 1e6), (1e9, 1e12, 1e6), (1e9, 1e6, 1e12)):
        assert dataclasses.asdict(TRA.RooflineTerms.build(f, b, c)) == \
            dataclasses.asdict(JRA.RooflineTerms.build(f, b, c))
    assert (TM.PEAK_FLOPS_BF16, TM.HBM_BW, TM.NVLINK_BW, TM.HBM_BYTES) == \
        (989e12, 3.35e12, 450e9, 80e9)


def test_collective_bytes_totals_the_record():
    """The port's record in place of HLO text: per kind and total, loop
    bodies scaled by the trip count, as ``collective_bytes`` scales the
    JAX package's parsed while bodies."""
    rec = [TRA.Collective("entry", "all-gather", "bfloat16", (4, 8), 64),
           TRA.Collective("while_body", "all-reduce", "float32", (8,), 32),
           TRA.Collective("entry", "reduce-scatter", "float32", (2,), 8)]
    got = TRA.collective_bytes(rec, body_trip_count=3)
    assert got == {"all-gather": 64.0, "all-reduce": 96.0,
                   "reduce-scatter": 8.0, "all-to-all": 0.0,
                   "collective-permute": 0.0, "total": 168.0}
    assert set(TRA.COLLECTIVES) == set(JRA.COLLECTIVES)


_COMBOS = textwrap.dedent("""
    import json
    import torch
    from torch.distributed.tensor import DTensor
    from repro_torch.configs.base import reduced
    from repro_torch.configs.registry import ARCHS
    from repro_torch.launch import dryrun as D
    from repro_torch.roofline import analysis as RA
    D.SHAPES.update(train_4k=(128, 8, "train"), prefill_32k=(256, 4, "prefill"),
                    decode_32k=(256, 8, "decode"))
    mesh = D.fake_mesh((2, 2), ("data", "model"))

    def plain(a):
        # a DTensor stand-in as a plain meta tensor of its global shape
        if isinstance(a, dict):
            return {k: plain(v) for k, v in a.items()}
        if isinstance(a, tuple):
            vals = [plain(v) for v in a]
            return type(a)(*vals) if hasattr(a, "_fields") else tuple(vals)
        if isinstance(a, DTensor):
            return torch.empty(a.shape, dtype=a.dtype, device="meta"
                               ).requires_grad_(a.requires_grad)
        return a

    out = {}
    for shape in ("train_4k", "prefill_32k", "decode_32k"):
        cfg = D.variant_for(reduced(ARCHS["granite-3-2b"]), shape)
        out[shape] = D.compile_combo(cfg, shape, mesh)
        # the same step on plain tensors, no rules: the whole step's FLOPs
        step, args = D.build(cfg, shape, mesh)
        rec = D.StepRecorder()
        with torch.set_grad_enabled(D.SHAPES[shape][2] == "train"), rec:
            step(*plain(args))
        seq, batch, _ = D.SHAPES[shape]
        out[shape]["unsharded_flops"] = rec.flops
        out[shape]["model_flops"] = RA.model_flops(cfg, shape, seq, batch)
    print("DRYRUN " + json.dumps(out))
""")


@functools.lru_cache(maxsize=None)
def _combos() -> dict:
    """The combos' results, from one subprocess for this module's tests."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")
               + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-c", _COMBOS], env=env,
                          capture_output=True, text=True, timeout=600,
                          cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = next(x for x in proc.stdout.splitlines()
                if x.startswith("DRYRUN "))
    return json.loads(line[len("DRYRUN "):])


def test_reduced_combos_trace_on_a_fake_mesh():
    """Reduced granite's train (AdamW), prefill and decode steps traced on
    a (2, 2) fake mesh: each completes, with FLOPs, bytes, collectives and
    a peak at least the arguments, per device; the arguments fit 80 GB,
    and the peak carries its note (DTensor's layout, no fit verdict)."""
    for shape, r in _combos().items():
        assert r["ok"], shape
        assert r["n_devices"] == 4
        assert r["flops"] > 0 and r["bytes_accessed"] > 0, shape
        assert r["n_collectives"] > 0 and \
            r["collective_bytes"]["total"] > 0, shape
        m = r["memory"]
        assert m["peak_bytes"] >= m["argument_bytes"] > 0, shape
        assert m["arguments_fit_80gb"], shape
        assert m["peak_note"] == TD.PEAK_NOTE, shape


# the traced FLOPs a device, times the 4 ranks, over the unsharded step's:
# at least 1 (no work lost), and below 4, which every rank counting the
# whole step would give (DTensor's layout of the port's step repeats
# work where it gathers activations to Replicate: 2.43 train, 1.00
# prefill, 2.75 decode at this size, torch 2.13)
DUPLICATION = (1.0, 3.0)
# model_flops (6·N·tokens train, 2·N·tokens serving) over the unsharded
# step's traced FLOPs: the attention scores and values, which
# model_flops leaves out, take the rest (0.90, 0.90, 0.99 here)
MODEL_SHARE = (0.85, 1.0)


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_traced_flops_against_the_unsharded_step(shape):
    """The dry run's FLOPs a device held to the same step run whole on
    plain tensors (the same counter), and that step's FLOPs to
    ``model_flops``, each within its stated ratio."""
    r = _combos()[shape]
    dup = r["flops"] * r["n_devices"] / r["unsharded_flops"]
    share = r["model_flops"] / r["unsharded_flops"]
    assert DUPLICATION[0] <= dup < DUPLICATION[1], dup
    assert MODEL_SHARE[0] <= share <= MODEL_SHARE[1], share

"""The port's dry run on reduced combos, held to the JAX reference's
golden (``tests/golden/torch_port_dryrun.json``).

Each arch's train_4k, prefill_32k and decode_32k steps are traced on a
(2, 2) fake mesh, at ``configs.base.reduced`` size with the SHAPES cut
as the golden's, in a child process (the fake process group is
process-wide); :func:`start` launches one child for a set of archs and
kinds, and :func:`collect` reads its results.  :func:`check_combo` holds
one combo's memory to the reference's:

* ``argument_bytes`` exactly (a step's arguments are what it reads, as
  a jit keeps only those);
* each output's local bytes exactly, but for the outputs named in
  :data:`RESHARDED`, which XLA places otherwise than the step does; the
  reference's ``output_bytes`` is its outputs' bytes plus an 8-byte
  pointer an output (the result tuple);
* ``alias_bytes`` exactly where no donated output is in
  :data:`RESHARDED`; where one is, XLA cannot give that output its
  donated buffer, so its alias is the smaller;
* the plan's arguments, outputs and aliases equal to the traced ones,
  its temp bytes within :data:`REDUCED_BAND` of the reference's, and
  the verdict ``fits_80gb``.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "golden", "torch_port_dryrun.json")
KINDS = ("train_4k", "prefill_32k", "decode_32k")

# the plan's temp bytes over XLA's on every reduced combo (0.57–2.88
# measured; a reduced step's temps are a few MB, where the fused
# program's scheduling moves more than at full size)
REDUCED_BAND = (0.5, 3.0)

# outputs XLA places otherwise than the port's step, by the golden's
# paths: the dense archs' prefill caches (a 16-slot sliding-window ring)
# whole along their slots where cache_logical splits them; xLSTM's and
# Zamba2's states, and the slstm input and output projections, the
# zamba2 decay and skip vectors (with their moments), split over the
# model axis as well
RESHARDED = {
    **{f"{a}|prefill_32k": ("[1]['k']", "[1]['v']")
       for a in ("granite-3-2b", "nemotron-4-340b", "qwen2-72b",
                 "starcoder2-3b")},
    "xlstm-1.3b|train_4k": tuple(
        f"{pre}['slstm']['{w}']" for pre in ("[1]", "[2].mu", "[2].nu")
        for w in ("w_in", "w_out")),
    "xlstm-1.3b|prefill_32k": ("[1]['m_c']", "[1]['s_c']", "[1]['s_h']",
                               "[1]['s_n']"),
    "xlstm-1.3b|decode_32k": ("[1]['m_c']", "[1]['m_n']", "[1]['s_c']",
                              "[1]['s_h']", "[1]['s_n']"),
    "zamba2-7b|train_4k": tuple(
        f"{pre}['mamba']['{w}']" for pre in ("[1]", "[2].mu", "[2].nu")
        for w in ("a_log", "d_skip", "dt_bias")),
    "zamba2-7b|prefill_32k": ("[1]['state']",),
    "zamba2-7b|decode_32k": ("[1]['state']",),
}

_CHILD = textwrap.dedent("""
    import json, sys
    import torch
    from torch.distributed.tensor import DTensor
    from repro_torch.configs.base import reduced
    from repro_torch.configs.registry import ARCHS
    from repro_torch.launch import dryrun as D
    from repro_torch.roofline import analysis as RA
    golden = json.load(open(sys.argv[1]))
    D.SHAPES.update({k: tuple(v) for k, v in golden["reduced_shapes"].items()})
    mesh = D.fake_mesh(tuple(golden["reduced_mesh"]), ("data", "model"))

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
    for arch in sys.argv[3:]:
        for shape in sys.argv[2].split(","):
            cfg = D.variant_for(reduced(ARCHS[arch]), shape)
            r = D.compile_combo(cfg, shape, mesh)
            if arch == "granite-3-2b":
                # the same step on plain tensors, no rules: its FLOPs
                step, args = D.build(cfg, shape, mesh)
                rec = D.StepRecorder()
                with torch.set_grad_enabled(D.SHAPES[shape][2] == "train"), \\
                        rec:
                    step(*plain(args))
                seq, batch, _ = D.SHAPES[shape]
                r["unsharded_flops"] = rec.flops
                r["model_flops"] = RA.model_flops(cfg, shape, seq, batch)
            out[f"{arch}|{shape}"] = r
    print("DRYRUN " + json.dumps(out))
""")


def golden() -> dict:
    with open(GOLDEN) as f:
        return json.load(f)


def start(archs, kinds=KINDS) -> subprocess.Popen:
    """A child tracing ``archs``' reduced combos of ``kinds``."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")
               + os.pathsep + os.environ.get("PYTHONPATH", ""))
    return subprocess.Popen(
        [sys.executable, "-c", _CHILD, GOLDEN, ",".join(kinds), *archs],
        env=env, cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def collect(proc: subprocess.Popen) -> dict:
    out, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-3000:]
    line = next(x for x in out.splitlines() if x.startswith("DRYRUN "))
    return json.loads(line[len("DRYRUN "):])


def check_combo(key: str, r: dict, ref: dict) -> None:
    """One traced combo against its golden entry (see the module's
    docstring)."""
    assert r["ok"], key
    m, plan, want = r["memory"], r["plan"], ref["memory"]
    leaves = ref["output_leaves"]
    assert m["argument_bytes"] == want["argument_bytes"], key
    assert len(m["output_leaf_bytes"]) == len(leaves), key
    differ = {path for (path, b), got in zip(leaves, m["output_leaf_bytes"])
              if b != got}
    named = set(RESHARDED.get(key, ()))
    assert differ == named, (key, differ)
    assert want["output_bytes"] == sum(b for _, b in leaves) \
        + 8 * len(leaves), key
    donated = [p for p in named if not p.startswith("[0]")
               and (key.endswith("train_4k") or key.endswith("decode_32k"))]
    if donated:
        assert m["alias_bytes"] > want["alias_bytes"], key
    else:
        assert m["alias_bytes"] == want["alias_bytes"], key
    for term in ("argument_bytes", "output_bytes", "alias_bytes"):
        assert plan[term] == m[term], (key, term)
    ratio = m["temp_bytes"] / want["temp_bytes"]
    assert REDUCED_BAND[0] <= ratio <= REDUCED_BAND[1], (key, ratio)
    assert m["temp_bytes"] == plan["temp_bytes"] == sum(
        plan["terms"].values()), key
    assert m["total_bytes"] == m["argument_bytes"] + m["temp_bytes"], key
    assert m["fits_80gb"], key

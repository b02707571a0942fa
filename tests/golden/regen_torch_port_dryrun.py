"""Regenerate the PyTorch port's dry-run golden from the JAX reference,
on the CPU.

    PYTHONPATH=src python tests/golden/regen_torch_port_dryrun.py
    PYTHONPATH=src python tests/golden/regen_torch_port_dryrun.py --check
    PYTHONPATH=src python tests/golden/regen_torch_port_dryrun.py \\
        --combo granite-3-2b train_4k

``repro.launch.dryrun.compile_combo`` compiles each step on host devices
and reads XLA's ``memory_analysis()``: argument, output, temp and alias
bytes a device (``total_bytes`` = argument + temp).  The file holds

* ``reduced``: the 10 archs × train_4k, prefill_32k, decode_32k at
  ``configs.base.reduced`` size, the shapes cut to ``REDUCED_SHAPES``, on
  a (2, 2) ``("data", "model")`` mesh of 4 host devices: the memory
  terms, and each output's local bytes in tree order (``output_leaves``:
  XLA chooses the outputs' shardings, and adds an 8-byte pointer an
  output to ``output_bytes`` for the result tuple);
* ``full``: the same 30 combos at published size on the 16×16
  production mesh: the memory terms.

``tests/test_torch_dryrun.py`` holds the port's dry run and its memory
plan to this file without compiling.  ``--check`` recomputes everything
(about three minutes) and fails (exit 1) if it differs, without
rewriting the file; ``--combo ARCH SHAPE`` prints one reduced combo's
entry as JSON (the test's live check that the file is current).
"""
import json
import math
import pathlib
import sys

PATH = pathlib.Path(__file__).parent / "torch_port_dryrun.json"
REDUCED_SHAPES = {"train_4k": (128, 8, "train"),
                  "prefill_32k": (256, 4, "prefill"),
                  "decode_32k": (256, 8, "decode")}
KINDS = ("train_4k", "prefill_32k", "decode_32k")


def _mesh(shape: tuple):
    import jax
    import numpy as np
    from jax.sharding import Mesh
    n = math.prod(shape)
    kw = {}
    if getattr(jax.sharding, "AxisType", None) is not None:
        kw["axis_types"] = (jax.sharding.AxisType.Auto,) * len(shape)
    return Mesh(np.array(jax.devices()[:n]).reshape(shape),
                ("data", "model"), **kw)


def _output_leaves(cfg, shape_name: str, mesh) -> list:
    """Each output's path and local bytes, as the compiled step places it."""
    import jax
    import numpy as np
    from repro.launch import dryrun as JD
    from repro.launch.sharding import sharding_rules
    kind = JD.SHAPES[shape_name][2]
    donate = {"train": (0, 1), "decode": (1,), "prefill": ()}[kind]
    with sharding_rules(mesh):
        step, specs, shs = JD.build(cfg, shape_name, mesh)
        compiled = jax.jit(step, in_shardings=shs,
                           donate_argnums=donate).lower(*specs).compile()
    outs = jax.tree_util.tree_flatten_with_path(jax.eval_shape(step,
                                                               *specs))[0]
    out_sh = jax.tree.leaves(compiled.output_shardings)
    return [[jax.tree_util.keystr(path),
             math.prod(sh.shard_shape(s.shape)) * np.dtype(s.dtype).itemsize]
            for (path, s), sh in zip(outs, out_sh)]


def reduced_entry(arch: str, shape_name: str) -> dict:
    from repro.configs.base import reduced
    from repro.configs.registry import ARCHS
    from repro.launch import dryrun as JD
    JD.SHAPES.update(REDUCED_SHAPES)
    mesh = _mesh((2, 2))
    cfg = JD.variant_for(reduced(ARCHS[arch]), shape_name)
    return {"memory": JD.compile_combo(cfg, shape_name, mesh)["memory"],
            "output_leaves": _output_leaves(cfg, shape_name, mesh)}


def full_entry(arch: str, shape_name: str) -> dict:
    from repro.configs.registry import ARCHS
    from repro.launch import dryrun as JD
    from repro.launch.mesh import make_production_mesh
    cfg = JD.variant_for(ARCHS[arch], shape_name)
    return {"memory": JD.compile_combo(cfg, shape_name,
                                       make_production_mesh())["memory"]}


def build() -> dict:
    # importing repro.launch.dryrun gives this process 512 host devices
    from repro.configs.registry import ARCHS
    from repro.launch import dryrun as JD
    saved = dict(JD.SHAPES)
    out = {"reduced_shapes": {k: list(v) for k, v in REDUCED_SHAPES.items()},
           "reduced_mesh": [2, 2], "full_mesh": [16, 16],
           "reduced": {}, "full": {}}
    for arch in sorted(ARCHS):
        for shape in KINDS:
            out["reduced"][f"{arch}|{shape}"] = reduced_entry(arch, shape)
            print("reduced", arch, shape, flush=True)
    JD.SHAPES.clear()
    JD.SHAPES.update(saved)
    for arch in sorted(ARCHS):
        for shape in KINDS:
            out["full"][f"{arch}|{shape}"] = full_entry(arch, shape)
            print("full", arch, shape, flush=True)
    return out


def main() -> None:
    args = sys.argv[1:]
    if args[:1] == ["--combo"]:
        print("GOLDEN " + json.dumps(reduced_entry(args[1], args[2])))
        return
    data = build()
    if args == ["--check"]:
        old = json.loads(PATH.read_text())
        if old != data:
            print("torch_port_dryrun.json differs from the JAX reference")
            raise SystemExit(1)
        print("torch_port_dryrun.json is current")
        return
    PATH.write_text(json.dumps(data, indent=1) + "\n")
    print(f"wrote {PATH}")


if __name__ == "__main__":
    main()

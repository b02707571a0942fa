"""Regenerate the PyTorch port's model golden files from the JAX reference.

    PYTHONPATH=src python tests/golden/regen_torch_port_model.py [NAME ...]
    PYTHONPATH=src python tests/golden/regen_torch_port_model.py --check

Each file holds one model at its published width with its depth cut, in
float32, with weights drawn by ``repro_torch.convert.random_numpy_params``
from a numpy seed, run through the JAX ``Model`` on the route its entry
names as ``attn_impl``: ``"pallas"`` (interpret mode on the CPU: the
flash-attention kernel in ``forward``, the flash-decode kernel in
``decode_step``) or ``"ref"``:

* ``torch_port_model.json``: granite-3-2b (d_model 2048, 32/8 heads,
  hd 64, d_ff 8192, vocab 49155 padded to 49408) cut to 2 layers;
  forward on (B 2, S 128);
* ``torch_port_zamba2.json``: zamba2-7b (d_model 3584, Mamba2 heads
  112 × 64 with a 64-wide state, the shared block's 32/32 heads at
  hd 112, d_ff 14336, vocab 32000) cut to 8 layers — one group of 6
  Mamba2 layers, the shared block, and a 2-layer tail; forward on
  (B 2, S 256), so the JAX chunked scan crosses a chunk boundary
  (about 4 GB of f32 weights);
* ``torch_port_qwen3moe.json``: qwen3-moe-30b-a3b (d_model 2048, 32/4
  heads, hd 128, 128 experts of d_ff 768, top-8, capacity factor 1.25,
  vocab 151936 padded to 152064) cut to 2 layers; forward on (B 2,
  S 128), so T 256 gives a capacity of 21 and pairs drop; the prefill's
  T 192 gives 16 and each decode step's T 2 gives 1 (about 7.5 GB of
  f32 weights).  The JAX MoE runs its dense-dispatch einsums;
* ``torch_port_whisper.json``: whisper-medium (d_model 1024, 16/16
  heads, hd 64, d_ff 4096, vocab 51865 padded to 52224, 1,500 frames)
  cut to 2 encoder and 2 decoder layers, on ``"ref"``: the JAX
  ``"pallas"`` route cannot take 1,500 frames (its flash wrapper runs
  blocks of min(128, S) rows and asserts that they divide S, and
  1500 % 128 = 92), so the reference's plain route makes the golden;
  frames N(0, 1) from ``frame_seed``; forward on (B 2, S 64);
* ``torch_port_train.json`` (a training golden): granite-3-2b cut to 2
  layers, on ``"ref"`` (the only route the JAX package trains on),
  ``steps`` AdamW steps (``lr``) from the numpy weights on
  ``FastSyntheticLM`` batches of ``data_seed`` (B 2 × S 64): each step's
  loss, the global norm of step 0's gradient (f64 over every leaf), and
  each final parameter leaf's f64 sum and sum of squares.

The model files keep what ``chip_smoke.py`` holds the port to on the
card, which has no JAX:

* ``forward``: the top-8 ids and values and the f64 sum of the
  real-vocabulary logits at a few positions;
* ``prefill`` of the first 96 tokens (max_seq 128), then 8 greedy
  ``decode_step``s: the prefill's top-8, and per step the greedy token
  with its top-1 and top-2 logits.

The tokens are stored in the file, so only the weights depend on the
seed.  NAME picks files by their stem (``torch_port_zamba2``); all by
default.  ``--check`` recomputes and fails (exit 1) if any number moved
by more than 1e-5, without rewriting the file.
"""
import json
import pathlib
import sys

DIR = pathlib.Path(__file__).parent
# file name → what it holds (every field is written into the file)
GOLDENS = {
    "torch_port_model.json": dict(
        arch="granite-3-2b", n_layers=2, dtype="float32",
        weight_seed=20241230, token_seed=7, batch=2, seq=128, prompt=96,
        max_seq=128, decode_steps=8, top=8, positions=[0, 1, 63, 95, 127],
        attn_impl="pallas"),
    "torch_port_zamba2.json": dict(
        arch="zamba2-7b", n_layers=8, dtype="float32",
        weight_seed=20241231, token_seed=8, batch=2, seq=256, prompt=96,
        max_seq=128, decode_steps=8, top=8,
        positions=[0, 1, 95, 127, 128, 255], attn_impl="pallas"),
    "torch_port_qwen3moe.json": dict(
        arch="qwen3-moe-30b-a3b", n_layers=2, dtype="float32",
        weight_seed=20241232, token_seed=9, batch=2, seq=128, prompt=96,
        max_seq=128, decode_steps=8, top=8, positions=[0, 1, 63, 95, 127],
        attn_impl="pallas"),
    "torch_port_whisper.json": dict(
        arch="whisper-medium", n_layers=2, enc_layers=2, dtype="float32",
        weight_seed=20241233, token_seed=10, frame_seed=11, batch=2,
        seq=64, prompt=48, max_seq=64, decode_steps=8, top=8,
        positions=[0, 1, 31, 47, 63], attn_impl="ref"),
}
# file name → a training golden (every field is written into the file)
TRAIN_GOLDENS = {
    "torch_port_train.json": dict(
        arch="granite-3-2b", n_layers=2, dtype="float32", attn_impl="ref",
        weight_seed=20241234, data_seed=12, batch=2, seq=64, steps=4,
        lr=3e-3),
}
# the JAX package names the kernel route "pallas"; the port "kernel"
_PORT_IMPL = {"pallas": "kernel", "ref": "ref"}


def config(spec: dict):
    """A golden's config, in the port's terms (the entry's route as the
    port names it)."""
    import dataclasses

    from repro_torch.configs.registry import ARCHS
    depth = {k: spec[k] for k in ("n_layers", "enc_layers") if k in spec}
    return dataclasses.replace(
        ARCHS[spec["arch"]], dtype=spec["dtype"], param_dtype=spec["dtype"],
        attn_impl=_PORT_IMPL[spec["attn_impl"]], **depth)


def _top(row, k):
    import numpy as np
    ids = np.argsort(-row, kind="stable")[:k]
    return [int(i) for i in ids], [float(row[i]) for i in ids]


def _to_jax(tree: dict) -> dict:
    """The numpy tree as JAX arrays, each numpy leaf dropped once copied
    (one copy of the weights in memory at a time, not two)."""
    import jax.numpy as jnp
    out = {}
    for name in list(tree):
        val = tree.pop(name)
        out[name] = _to_jax(val) if isinstance(val, dict) \
            else jnp.asarray(val)
        del val
    return out


def _compute(spec: dict) -> dict:
    import jax.numpy as jnp
    import numpy as np

    from repro.configs.base import ArchConfig
    from repro.models.model import Model
    from repro_torch import convert

    cfg = config(spec)
    jcfg = ArchConfig(**convert.arch_to_fields(cfg))
    model = Model(jcfg)
    params = _to_jax(convert.random_numpy_params(cfg, spec["weight_seed"]))
    rng = np.random.default_rng(spec["token_seed"])
    tokens = rng.integers(0, cfg.vocab, (spec["batch"], spec["seq"]),
                          dtype=np.int32)
    k, vocab = spec["top"], cfg.vocab
    extra = {}
    if cfg.family == "encdec":
        extra["frames"] = jnp.asarray(np.random.default_rng(
            spec["frame_seed"]).standard_normal(
                (spec["batch"], cfg.n_frames, cfg.d_model), dtype=np.float32))

    logits, _ = model.forward(params, {"tokens": jnp.asarray(tokens),
                                       **extra})
    logits = np.asarray(logits)
    fwd = []
    for b in range(spec["batch"]):
        for p in spec["positions"]:
            ids, vals = _top(logits[b, p], k)
            fwd.append(dict(b=b, pos=p, ids=ids, values=vals,
                            checksum=float(logits[b, p, :vocab].astype(
                                np.float64).sum())))

    prompt = spec["prompt"]
    last, cache = model.prefill(
        params, {"tokens": jnp.asarray(tokens[:, :prompt]), **extra},
        spec["max_seq"])
    last = np.asarray(last)[:, 0]
    pre = [dict(zip(("ids", "values"), _top(last[b], k)))
           for b in range(spec["batch"])]
    tok = last.argmax(-1).astype(np.int32)
    steps = []
    for t in range(spec["decode_steps"]):
        step, cache = model.decode_step(params, cache,
                                        jnp.asarray(tok[:, None]),
                                        jnp.asarray(prompt + t, jnp.int32))
        row = np.asarray(step)[:, 0]
        tops = [_top(row[b], 2) for b in range(spec["batch"])]
        steps.append(dict(fed=[int(x) for x in tok],
                          top1=[ids[0] for ids, _ in tops],
                          top1_value=[vals[0] for _, vals in tops],
                          top2_value=[vals[1] for _, vals in tops]))
        tok = row.argmax(-1).astype(np.int32)
    return dict(spec, tokens=tokens.tolist(), forward=fwd, prefill=pre,
                decode=steps)


def _compute_train(spec: dict) -> dict:
    import jax
    import numpy as np

    from repro.configs.base import ArchConfig
    from repro.data.pipeline import FastSyntheticLM
    from repro.models.model import Model
    from repro.train.optimizer import AdamW
    from repro_torch import convert

    cfg = config(spec)
    model = Model(ArchConfig(**convert.arch_to_fields(cfg)))
    params = _to_jax(convert.random_numpy_params(cfg, spec["weight_seed"]))
    opt = AdamW(lr=spec["lr"])
    state = opt.init(params)
    value_and_grad = jax.jit(jax.value_and_grad(model.loss))
    update = jax.jit(opt.update)
    data = FastSyntheticLM(vocab=cfg.vocab, seq_len=spec["seq"],
                           batch=spec["batch"],
                           seed=spec["data_seed"]).batches()
    losses, grad_norm = [], None
    for i in range(spec["steps"]):
        loss, grads = value_and_grad(params, next(data))
        if i == 0:
            grad_norm = float(np.sqrt(sum(
                np.square(np.asarray(g, np.float64)).sum()
                for g in jax.tree.leaves(grads))))
        params, state = update(grads, state, params)
        losses.append(float(loss))
    sums = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        a = np.asarray(leaf, np.float64)
        sums[".".join(p.key for p in path)] = dict(
            sum=float(a.sum()), sumsq=float(np.square(a).sum()),
            numel=int(a.size))
    return dict(spec, losses=losses, grad_norm=grad_norm, param_sums=sums)


def _numbers(tree):
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _numbers(tree[key])
    elif isinstance(tree, list):
        for v in tree:
            yield from _numbers(v)
    else:
        yield tree


def main() -> None:
    args = sys.argv[1:]
    check = "--check" in args
    names = [a for a in args if a != "--check"]
    stale = []
    jobs = [(f, s, _compute) for f, s in GOLDENS.items()] + \
        [(f, s, _compute_train) for f, s in TRAIN_GOLDENS.items()]
    for fname, spec, compute in jobs:
        if names and pathlib.Path(fname).stem not in names:
            continue
        path = DIR / fname
        fresh = compute(spec)
        if not check:
            path.write_text(json.dumps(fresh, indent=1, sort_keys=True)
                            + "\n")
            print("wrote", path)
            continue
        golden = json.loads(path.read_text())
        old, new = list(_numbers(golden)), list(_numbers(fresh))
        if len(old) != len(new) or any(
                (a != b) if isinstance(a, (int, str)) else abs(a - b) > 1e-5
                for a, b in zip(old, new)):
            stale.append(path)
        else:
            print("golden file is fresh:", path)
    if stale:
        print("golden files are stale — rerun without --check and commit:",
              *stale)
        sys.exit(1)


if __name__ == "__main__":
    main()

"""Regenerate the PyTorch port's model golden file from the JAX reference.

    PYTHONPATH=src python tests/golden/regen_torch_port_model.py
    PYTHONPATH=src python tests/golden/regen_torch_port_model.py --check

granite-3-2b at its full width (d_model 2048, 32/8 heads, hd 64, d_ff
8192, vocab 49155 padded to 49408) cut to 2 layers, in float32, with
weights drawn by ``repro_torch.convert.random_numpy_params`` from a
numpy seed, run through the JAX ``Model`` with ``attn_impl="pallas"``
(interpret mode on the CPU: the flash-attention kernel in ``forward``,
the flash-decode kernel in ``decode_step``).  The file keeps what
``chip_smoke.py`` holds the port to on the card, which has no JAX:

* ``forward`` on (B 2, S 128) tokens: the top-8 ids and values and the
  f64 sum of the real-vocabulary logits at a few positions;
* ``prefill`` of the first 96 tokens (max_seq 128), then 8 greedy
  ``decode_step``s: the prefill's top-8, and per step the greedy token
  with its top-1 and top-2 logits.

The tokens are stored in the file, so only the weights depend on the
seed.  ``--check`` recomputes and fails (exit 1) if any number moved by
more than 1e-5, without rewriting the file.
"""
import json
import pathlib
import sys

PATH = pathlib.Path(__file__).parent / "torch_port_model.json"
COMMON = dict(arch="granite-3-2b", n_layers=2, dtype="float32",
              weight_seed=20241230, token_seed=7, batch=2, seq=128,
              prompt=96, max_seq=128, decode_steps=8, top=8,
              positions=[0, 1, 63, 95, 127])


def config():
    """The golden model's config, in the port's terms (``"kernel"``)."""
    import dataclasses

    from repro_torch.configs.registry import ARCHS
    return dataclasses.replace(
        ARCHS[COMMON["arch"]], n_layers=COMMON["n_layers"],
        dtype=COMMON["dtype"], param_dtype=COMMON["dtype"],
        attn_impl="kernel")


def _top(row, k):
    import numpy as np
    ids = np.argsort(-row, kind="stable")[:k]
    return [int(i) for i in ids], [float(row[i]) for i in ids]


def _compute() -> dict:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from repro.configs.base import ArchConfig
    from repro.models.model import Model
    from repro_torch import convert

    cfg = config()
    jcfg = ArchConfig(**convert.arch_to_fields(cfg))
    model = Model(jcfg)
    params = jax.tree.map(jnp.asarray, convert.random_numpy_params(
        cfg, COMMON["weight_seed"]))
    rng = np.random.default_rng(COMMON["token_seed"])
    tokens = rng.integers(0, cfg.vocab, (COMMON["batch"], COMMON["seq"]),
                          dtype=np.int32)
    k, vocab = COMMON["top"], cfg.vocab

    logits, _ = model.forward(params, {"tokens": jnp.asarray(tokens)})
    logits = np.asarray(logits)
    fwd = []
    for b in range(COMMON["batch"]):
        for p in COMMON["positions"]:
            ids, vals = _top(logits[b, p], k)
            fwd.append(dict(b=b, pos=p, ids=ids, values=vals,
                            checksum=float(logits[b, p, :vocab].astype(
                                np.float64).sum())))

    prompt = COMMON["prompt"]
    last, cache = model.prefill(
        params, {"tokens": jnp.asarray(tokens[:, :prompt])},
        COMMON["max_seq"])
    last = np.asarray(last)[:, 0]
    pre = [dict(zip(("ids", "values"), _top(last[b], k)))
           for b in range(COMMON["batch"])]
    tok = last.argmax(-1).astype(np.int32)
    steps = []
    for t in range(COMMON["decode_steps"]):
        step, cache = model.decode_step(params, cache,
                                        jnp.asarray(tok[:, None]),
                                        jnp.asarray(prompt + t, jnp.int32))
        row = np.asarray(step)[:, 0]
        tops = [_top(row[b], 2) for b in range(COMMON["batch"])]
        steps.append(dict(fed=[int(x) for x in tok],
                          top1=[ids[0] for ids, _ in tops],
                          top1_value=[vals[0] for _, vals in tops],
                          top2_value=[vals[1] for _, vals in tops]))
        tok = row.argmax(-1).astype(np.int32)
    return dict(COMMON, tokens=tokens.tolist(), forward=fwd,
                prefill=pre, decode=steps)


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
    fresh = _compute()
    if "--check" in sys.argv[1:]:
        golden = json.loads(PATH.read_text())
        old, new = list(_numbers(golden)), list(_numbers(fresh))
        if len(old) != len(new) or any(
                (a != b) if isinstance(a, (int, str)) else abs(a - b) > 1e-5
                for a, b in zip(old, new)):
            print("golden file is stale — rerun without --check and commit")
            sys.exit(1)
        print("golden file is fresh:", PATH)
        return
    PATH.write_text(json.dumps(fresh, indent=1, sort_keys=True) + "\n")
    print("wrote", PATH)


if __name__ == "__main__":
    main()

"""numpy ↔ port structures: the port's data boundary.

:func:`from_numpy` turns any NamedTuple of numpy arrays (matched by field
name, nested queues and estimator state included) into the port's
``FleetSignals`` / ``Profiles`` / ``PolicyParams`` / ``EdgeState`` on a
device; :func:`to_numpy` goes the other way.  Dtypes are the reference's:
float32, int32 and bool, and anything else raises.

For the serve path, :func:`arch_from_fields` / :func:`arch_to_fields`
convert model configs, and :func:`params_from_numpy` /
:func:`params_to_numpy` carry a JAX ``Model.init`` parameter tree (as
numpy) to and from the port's parameters, for every ported family (the
moe family's ``router`` and expert tensors included: they follow the
model's layout like any other leaf).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import sched
from repro_torch.sim import fleet

_DTYPES = {np.dtype(np.float32): torch.float32,
           np.dtype(np.int32): torch.int32,
           np.dtype(np.bool_): torch.bool}

# nested NamedTuple fields, by (parent class, field)
_NESTED = {(fleet.EdgeState, "eq"): sched.EdgeQueue,
           (fleet.EdgeState, "cq"): sched.CloudQueue,
           (fleet.EdgeState, "adapt"): sched.AdaptState}


def _tensor(a, device: torch.device) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype not in _DTYPES:
        raise TypeError(f"from_numpy: unsupported dtype {arr.dtype} (want "
                        f"float32, int32 or bool)")
    return torch.tensor(arr).to(device)


def from_numpy(cls, tree, device="cuda"):
    """``cls`` (a port NamedTuple class) built from ``tree``'s fields of
    the same names, each placed on ``device``."""
    dev = resolve_device(device)
    out = {}
    for name in cls._fields:
        val = getattr(tree, name)
        sub = _NESTED.get((cls, name))
        out[name] = from_numpy(sub, val, dev) if sub is not None \
            else _tensor(val, dev)
    return cls(**out)


def to_numpy(tree):
    """The same NamedTuple with every tensor leaf as a host numpy array."""
    if isinstance(tree, tuple):
        return type(tree)(*(to_numpy(v) for v in tree))
    return tree.detach().cpu().numpy()


# ---------------------------------------------------------------------------
# model configs and parameters (the serve path)
# ---------------------------------------------------------------------------

# the JAX package names the kernel path "pallas"; the port names it "kernel"
_ATTN_TO_PORT = {"ref": "ref", "pallas": "kernel"}
_ATTN_TO_REF = {v: k for k, v in _ATTN_TO_PORT.items()}


def arch_from_fields(fields) -> "ArchConfig":
    """A port :class:`~repro_torch.configs.base.ArchConfig` from the
    fields of a JAX package config (a dataclass or a dict of its fields),
    with ``attn_impl`` mapped from ``"pallas"`` to ``"kernel"``."""
    import dataclasses

    from repro_torch.configs.base import ArchConfig
    if dataclasses.is_dataclass(fields):
        fields = dataclasses.asdict(fields)
    fields = dict(fields, attn_impl=_ATTN_TO_PORT[fields["attn_impl"]])
    return ArchConfig(**fields)


def arch_to_fields(cfg) -> dict:
    """The fields of a port config as the JAX package names them
    (``attn_impl`` ``"kernel"`` → ``"pallas"``)."""
    import dataclasses
    fields = dataclasses.asdict(cfg)
    fields["attn_impl"] = _ATTN_TO_REF[fields["attn_impl"]]
    return fields


def params_from_numpy(cfg, tree, device="cuda", dtype=None) -> dict:
    """The port's model parameters from a JAX ``Model.init`` tree handed
    over as numpy (stacked blocks, the same names), each leaf checked
    against the port's shape and placed on ``device`` in ``dtype``
    (default: ``cfg.param_dtype``)."""
    from repro_torch.models.model import Model
    model = Model(cfg, device)
    dtype = model.pdtype if dtype is None else dtype

    def build(shapes, sub, path):
        if set(sub) != set(shapes):
            raise ValueError(f"params_from_numpy: {path or 'params'} has "
                             f"{sorted(sub)}, want {sorted(shapes)}")
        out = {}
        for name, shape in shapes.items():
            if isinstance(shape, dict):
                out[name] = build(shape, sub[name], f"{path}{name}.")
                continue
            arr = np.asarray(sub[name]).astype(np.float32)
            if arr.shape != tuple(shape):
                raise ValueError(f"params_from_numpy: {path}{name} has shape"
                                 f" {arr.shape}, want {tuple(shape)}")
            out[name] = torch.from_numpy(arr).to(device=model.device,
                                                 dtype=dtype)
        return out
    return build(model.param_shapes(), tree, "")


def params_to_numpy(params) -> dict:
    """The same tree with every tensor as a host float32 numpy array."""
    if isinstance(params, dict):
        return {k: params_to_numpy(v) for k, v in params.items()}
    return params.detach().float().cpu().numpy()



def random_numpy_params(cfg, seed: int) -> dict:
    """A parameter tree for ``cfg`` made with numpy from ``seed`` (float32,
    the ``Model.init`` scheme: unit norms and D skips, zero biases and
    ``a_log``, an N(0, 0.02²) embedding, N(0, 1)/sqrt(fan_in) matrices),
    drawn leaf by leaf in sorted order.  Both packages can take it, so it
    is how the tests and the golden files give the JAX model and the port
    the same weights."""
    from repro_torch.models.model import Model, init_constant
    model = Model(cfg, "cpu")
    rng = np.random.default_rng(seed)

    def normal(shape, std):
        return rng.standard_normal(shape, dtype=np.float32) * np.float32(std)

    tree = {"embed": normal((model.vpad, cfg.d_model), 0.02),
            "final_norm": np.ones(cfg.d_model, np.float32)}
    if not cfg.tie_embeddings:
        tree["lm_head"] = normal((cfg.d_model, model.vpad),
                                 1.0 / np.sqrt(cfg.d_model))
    for group, (defs, n) in sorted(model.layout().items()):
        tree[group] = {}
        for name, shape in sorted(defs.items()):
            full = (n, *shape) if n else shape
            const = init_constant(name)
            if const is not None:
                tree[group][name] = np.full(full, const, np.float32)
            else:
                fan_in = np.prod(shape[:-1]) if len(shape) > 1 else shape[0]
                tree[group][name] = normal(full, 1.0 / np.sqrt(fan_in))
    return tree

"""Minimal dependency-free checkpointing (npz + JSON tree description).
Port of ``repro.train.checkpoint``, in its file format.

A tree is NamedTuples, dicts (keys in sorted order), tensors, numpy
arrays and scalars; ``None`` holds no leaf.  ``save`` writes
``path.npz`` with one ``leaf_i`` per leaf in that flatten order — the
reference's ``jax.tree.flatten`` order — and ``path.tree.json``.  So a
checkpoint written by the JAX package loads here, and one written here
loads there.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch


def _flatten(tree) -> tuple[list, str]:
    """Leaves in the reference's order and a description of the tree."""
    if tree is None:
        return [], "None"
    if isinstance(tree, dict):
        leaves, parts = [], []
        for k in sorted(tree):
            sub, desc = _flatten(tree[k])
            leaves += sub
            parts.append(f"{k!r}: {desc}")
        return leaves, "{" + ", ".join(parts) + "}"
    if isinstance(tree, tuple):
        leaves, parts = [], []
        for name, v in zip(tree._fields, tree):
            sub, desc = _flatten(v)
            leaves += sub
            parts.append(f"{name}={desc}")
        return leaves, f"{type(tree).__name__}({', '.join(parts)})"
    return [tree], "*"


def _unflatten(like, it):
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _unflatten(like[k], it) for k in sorted(like)}
    if isinstance(like, tuple):
        return type(like)(*(_unflatten(v, it) for v in like))
    return next(it)


def _numpy(x) -> np.ndarray:
    """A leaf as numpy; numpy has no bfloat16, so a bf16 tensor is
    written as the float32 of its values (exact)."""
    if not isinstance(x, torch.Tensor):
        return np.asarray(x)
    x = x.detach().cpu()
    return (x.float() if x.dtype == torch.bfloat16 else x).numpy()


def save(path: str, tree) -> None:
    leaves, desc = _flatten(tree)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path + ".npz",
             **{f"leaf_{i}": _numpy(x) for i, x in enumerate(leaves)})
    with open(path + ".tree.json", "w") as f:
        json.dump({"treedef": desc, "n": len(leaves)}, f)


def load(path: str, like) -> object:
    """Restore into the structure of ``like`` (shapes must match); the
    leaves come back as numpy arrays."""
    data = np.load(path + ".npz")
    leaves_like, _ = _flatten(like)
    loaded = [data[f"leaf_{i}"] for i in range(len(leaves_like))]
    for a, b in zip(loaded, leaves_like):
        want = tuple(b.shape) if hasattr(b, "shape") else np.shape(b)
        if tuple(a.shape) != tuple(want):
            raise ValueError(f"shape mismatch {a.shape} vs {want}")
    return _unflatten(like, iter(loaded))

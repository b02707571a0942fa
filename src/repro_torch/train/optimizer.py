"""AdamW as plain functions on tensors (no ``torch.optim``).

Port of ``repro.train.optimizer``, in its order of operations: the
moments in f32 (``b·m + (1 − b)·g``), then ``mhat / (sqrt(vhat) + eps)
+ wd·p`` in f32, then one cast back to each tensor's dtype.
``torch.optim.AdamW`` rounds in another order (it decays the parameter
first and folds the bias corrections into the step size), so it is not
used.  Moments are stored in ``moment_dtype`` (bf16 for the largest
configs in the reference, f32 otherwise).

Parameter trees are nested dicts of tensors, as ``Model.init`` builds
them.  Unlike the reference's functional update, :meth:`AdamW.update`
writes the new parameters and moments into the given tensors (no second
copy of the weights and moments on the card) and returns them; the
step count it returns is a new tensor (the captured train step,
``train.loop.TrainProgram``, copies it into the state's own).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch
from torch.distributed.tensor import DTensor

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class AdamWState(NamedTuple):
    step: torch.Tensor          # int32 scalar: updates taken
    mu: dict
    nu: dict


def tree_map(fn, *trees):
    """``fn`` over the tensor leaves of nested dicts of one structure, in
    :func:`tree_leaves`' order."""
    if isinstance(trees[0], dict):
        return {k: tree_map(fn, *(t[k] for t in trees))
                for k in sorted(trees[0])}
    return fn(*trees)


def tree_leaves(tree) -> list:
    """The tensor leaves of a nested dict, keys in sorted order (the
    reference's flatten order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def _slices(*ts: torch.Tensor):
    """Leaves of one shape (gradient, moments, parameter) a slice of
    dimension 0 at a time when they are 3-D or more (a stacked leaf a
    layer at a time), so the f32 temporaries of an update stay a slice's
    size; whole where a DTensor among them is split along dimension 0
    (DTensor cannot unbind a split).  The update is elementwise, so the
    two give the same numbers."""
    if ts[0].dim() < 3 or any(
            isinstance(t, DTensor) and any(p.is_shard(0)
                                           for p in t.placements)
            for t in ts):
        return (ts,)
    return zip(*(t.unbind(0) for t in ts))


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    moment_dtype: str = "float32"

    def init(self, params) -> AdamWState:
        dt = _DTYPES[self.moment_dtype]

        def zeros(p):
            return torch.zeros(p.shape, dtype=dt, device=p.device)
        dev = tree_leaves(params)[0].device
        return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                          mu=tree_map(zeros, params),
                          nu=tree_map(zeros, params))

    @torch.no_grad()
    def update(self, grads, state: AdamWState, params):
        """One AdamW step: (params, new state), the parameters and moments
        updated in place."""
        step = state.step + 1
        stepf = step.float()
        # the f32 betas made on the device (no host-to-device copy in the
        # step, so a CUDA graph can capture it)
        bc1 = 1 - torch.full((), self.b1, dtype=torch.float32,
                             device=stepf.device) ** stepf
        bc2 = 1 - torch.full((), self.b2, dtype=torch.float32,
                             device=stepf.device) ** stepf
        for g, m, v, p in zip(*map(tree_leaves, (grads, state.mu, state.nu,
                                                 params))):
            for gs, ms, vs, ps in _slices(g, m, v, p):
                self._update_leaf(gs, ms, vs, ps, bc1, bc2)
        return params, AdamWState(step=step, mu=state.mu, nu=state.nu)

    def _update_leaf(self, g, m, v, p, bc1, bc2) -> None:
        b1, b2 = self.b1, self.b2
        g32 = g.float()
        m32 = m.float() * b1 + g32 * (1 - b1)
        v32 = v.float() * b2 + g32.square() * (1 - b2)
        mhat = m32 / bc1
        vhat = v32 / bc2
        delta = mhat / (vhat.sqrt() + self.eps) + \
            self.weight_decay * p.float()
        p.copy_(p.float() - self.lr * delta)
        m.copy_(m32)
        v.copy_(v32)

"""Training loop over the model zoo.  Port of ``repro.train.loop``.

``make_train_step`` differentiates ``Model.loss`` with
``torch.autograd.grad`` (the counterpart of ``jax.value_and_grad``) and
applies :class:`~repro_torch.train.optimizer.AdamW`.  The step runs
eagerly: it is not captured as a CUDA graph.  The kernel route is
forward-only (``kernels/ops.py``), as the reference's ``"pallas"`` route
is, so a config with ``attn_impl="kernel"`` fails on the card at its
first kernel launch; it trains on ``"ref"``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.data.pipeline import FastSyntheticLM
from repro_torch.models.model import Model
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.optimizer import AdamW, AdamWState, tree_leaves
from repro_torch.train.optimizer import tree_map


@dataclasses.dataclass
class TrainState:
    params: dict
    opt_state: AdamWState
    step: int = 0


def make_train_step(model: Model, opt: AdamW) -> Callable:
    """``step(params, opt_state, batch) → (loss, params, opt_state)``: the
    loss and its gradient with respect to every parameter, then one AdamW
    update (parameters and moments written in place)."""
    def step(params, opt_state, batch):
        leaves = tree_leaves(params)
        for t in leaves:
            t.requires_grad_(True)
        loss = model.loss(params, batch)
        grads = iter(torch.autograd.grad(loss, leaves))
        grads = tree_map(lambda _: next(grads), params)
        params, opt_state = opt.update(grads, opt_state, params)
        return loss.detach(), params, opt_state
    return step


def batch_tensors(cfg: ArchConfig, raw: dict, device) -> dict:
    """A pipeline batch on ``device``, with the stub frontends' zero
    inputs the reference's loop feeds: ``frames`` for encdec, ``patches``
    for vlm."""
    b, _ = raw["tokens"].shape
    out = {k: torch.from_numpy(raw[k]).long().to(device)
           for k in ("tokens", "labels")}
    if cfg.family == "encdec":
        out["frames"] = torch.zeros((b, cfg.n_frames, cfg.d_model),
                                    device=device)
    if cfg.family == "vlm":
        out["patches"] = torch.zeros((b, cfg.n_image_tokens, cfg.d_model),
                                     device=device)
    return out


def train(cfg: ArchConfig, *, steps: int = 100, batch: int = 8,
          seq_len: int = 128, lr: float = 3e-3, seed: int = 0,
          log_every: int = 20, checkpoint_path: Optional[str] = None,
          log=print, device="cuda",
          generator: Optional[torch.Generator] = None
          ) -> tuple[TrainState, list[float]]:
    """Train ``cfg`` from ``Model.init(generator)`` (default: a generator
    on ``device`` seeded with ``seed``) on ``FastSyntheticLM`` batches of
    ``seed``; returns the final state and the per-step losses, and writes
    the parameters to ``checkpoint_path`` in the reference's format."""
    dev = resolve_device(device)
    model = Model(cfg, dev)
    opt = AdamW(lr=lr)
    gen = generator if generator is not None \
        else torch.Generator(device=dev).manual_seed(seed)
    params = model.init(gen)
    opt_state = opt.init(params)
    step_fn = make_train_step(model, opt)
    data = FastSyntheticLM(vocab=cfg.vocab, seq_len=seq_len, batch=batch,
                           seed=seed).batches()
    losses = []
    t0 = time.time()
    for i in range(steps):
        b = batch_tensors(cfg, next(data), dev)
        loss, params, opt_state = step_fn(params, opt_state, b)
        losses.append(float(loss))
        if i % log_every == 0 or i == steps - 1:
            log(f"step {i:4d} loss {losses[-1]:.4f} "
                f"({(time.time() - t0) / (i + 1):.2f}s/step)")
    state = TrainState(params=params, opt_state=opt_state, step=steps)
    if checkpoint_path:
        ckpt.save(checkpoint_path, params)
        log(f"checkpoint → {checkpoint_path}.npz")
    return state, losses

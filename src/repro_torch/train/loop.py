"""Training loop over the model zoo.  Port of ``repro.train.loop``.

``make_train_step`` differentiates ``Model.loss`` with
``torch.autograd.grad`` (the counterpart of ``jax.value_and_grad``) and
applies :class:`~repro_torch.train.optimizer.AdamW`, eagerly.
:class:`TrainProgram` is the reference's jitted step: on the card its
first step runs eagerly (the warm-up, checked for host syncs) and the
step is then captured as one CUDA graph (loss, gradient and AdamW),
which every later step replays on static batch buffers; on the CPU its
step body runs eagerly.  ``train`` steps through a ``TrainProgram``.
The kernel route is forward-only (``kernels/ops.py``), as the
reference's ``"pallas"`` route is, so a config with
``attn_impl="kernel"`` fails on the card at its first kernel launch; it
trains on ``"ref"``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import torch

from repro_torch import resolve_device, warm_and_capture
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
    program: Optional["TrainProgram"] = None    # the step train() ran


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


class TrainProgram:
    """The train step as one program: ``program(raw)`` copies a pipeline
    batch (numpy ``tokens`` and ``labels``) into static buffers, takes
    one step of ``Model.loss`` → ``torch.autograd.grad`` → ``AdamW.update``
    on ``params`` and ``opt_state`` (both written in place, the step
    count into ``opt_state.step`` itself) and returns the loss, a scalar
    tensor.  The static buffers are made from the first batch
    (:func:`batch_tensors`, with the stub frontends' zero ``frames`` or
    ``patches``), so every batch has the first one's shape.

    On the card the first call is the warm step: the body runs eagerly on
    a side stream under ``torch.cuda.set_sync_debug_mode("error")`` (it
    builds what is built lazily and fails on any host sync in the step)
    and is a real step, the first.  The body is then captured, into the
    graph's own memory pool, where the gradients and activations live;
    every later call replays it and clones the loss out of the graph's
    output.  A capture that fails raises: there is no eager path on the
    card.  On the CPU every call runs the body eagerly.

    ``capture_s`` and ``instantiate_s`` are what the capture cost,
    ``nodes`` the graph's node count, ``replays`` the replayed steps."""

    def __init__(self, model: Model, opt: AdamW, params: dict,
                 opt_state: AdamWState):
        self.model, self.opt = model, opt
        self.params, self.opt_state = params, opt_state
        self.leaves = tree_leaves(params)
        for t in self.leaves:
            t.requires_grad_(True)
        self.static: Optional[dict] = None
        self.graph = None
        self._loss = None
        self.replays = 0
        self.nodes = 0
        self.capture_s = self.instantiate_s = 0.0

    def body(self) -> torch.Tensor:
        """One step on the static batch; returns the loss."""
        loss = self.model.loss(self.params, self.static)
        grads = iter(torch.autograd.grad(loss, self.leaves))
        grads = tree_map(lambda _: next(grads), self.params)
        _, state = self.opt.update(grads, self.opt_state, self.params)
        self.opt_state.step.copy_(state.step)
        return loss.detach()

    def __call__(self, raw: dict) -> torch.Tensor:
        dev = self.model.device
        if self.static is None:
            self.static = batch_tensors(self.model.cfg, raw, dev)
        else:
            for k in ("tokens", "labels"):
                src = torch.from_numpy(raw[k])
                if src.shape != self.static[k].shape:
                    raise ValueError(
                        f"TrainProgram: {k} of shape {tuple(src.shape)}, "
                        f"the program's is {tuple(self.static[k].shape)}")
                self.static[k].copy_(src)
        if dev.type != "cuda":
            return self.body()
        if self.graph is None:
            cap = warm_and_capture(self.body, dev)
            self.graph, self._loss = cap.graph, cap.out
            self.capture_s, self.instantiate_s = (cap.capture_s,
                                                  cap.instantiate_s)
            self.nodes = cap.nodes
            return cap.warm
        self.graph.replay()
        self.replays += 1
        return self._loss.clone()


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
    ``seed`` through a :class:`TrainProgram` (captured on the card);
    returns the final state (with the program) and the per-step losses,
    and writes the parameters to ``checkpoint_path`` in the reference's
    format."""
    dev = resolve_device(device)
    model = Model(cfg, dev)
    opt = AdamW(lr=lr)
    gen = generator if generator is not None \
        else torch.Generator(device=dev).manual_seed(seed)
    params = model.init(gen)
    opt_state = opt.init(params)
    program = TrainProgram(model, opt, params, opt_state)
    data = FastSyntheticLM(vocab=cfg.vocab, seq_len=seq_len, batch=batch,
                           seed=seed).batches()
    losses = []
    t0 = time.time()
    for i in range(steps):
        losses.append(float(program(next(data))))
        if i % log_every == 0 or i == steps - 1:
            log(f"step {i:4d} loss {losses[-1]:.4f} "
                f"({(time.time() - t0) / (i + 1):.2f}s/step)")
    state = TrainState(params=params, opt_state=opt_state, step=steps,
                       program=program)
    if checkpoint_path:
        ckpt.save(checkpoint_path, params)
        log(f"checkpoint → {checkpoint_path}.npz")
    return state, losses

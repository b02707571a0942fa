"""Training launcher: ``python -m repro_torch.launch.train --arch
granite-3-2b``.  Port of ``repro.launch.train``.

Trains the *reduced* family variant end to end (data pipeline → AdamW →
checkpoint) on ``--device`` (the card by default; ``--device cpu`` runs
on the host).  ``--full`` builds the published config (bf16 parameters,
f32 moments, remat), for the card.  On the card the step is captured
(``train.loop.TrainProgram``: a warm step, then one CUDA graph of loss,
gradient and AdamW replayed every later step); on the host it runs
eagerly.
"""
from __future__ import annotations

import argparse

from repro_torch.configs.base import reduced
from repro_torch.configs.registry import ARCHS
from repro_torch.train.loop import train


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-2b", choices=sorted(ARCHS))
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--full", action="store_true",
                    help="use the full published config (on the card)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = ARCHS[args.arch] if args.full else reduced(ARCHS[args.arch])
    state, losses = train(cfg, steps=args.steps, batch=args.batch,
                          seq_len=args.seq, lr=args.lr,
                          checkpoint_path=args.ckpt, device=args.device)
    print(f"final loss {losses[-1]:.4f} after {state.step} steps")


if __name__ == "__main__":
    main()

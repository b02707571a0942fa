"""Serving launcher: the paper's scheduler over live model inference.

``python -m repro_torch.launch.serve --policy GEMS --duration 15``
registers three zoo models as the Ocularone DNNs (HV/DEV/BP roles),
measures their p95 latencies, and streams frame-rate tasks through the
chosen policy on the port's :class:`~repro_torch.serve.engine.
ServeEngine` — the §8.8 field validation without a drone.  Port of
``repro.launch.serve``.

The roles are the JAX launcher's reduced models (2 layers, d_model 192,
f32) on the card; ``--attn-impl kernel`` routes their attention and
their norms through the hand-written flash-attention and RMSNorm
kernels, and ``--device cpu`` runs everything on the host.
``build_roles(full_size=True)`` serves them at their published widths
and depths in bf16 (``chip_smoke.py`` does).

``--backend fleet`` schedules the same frame stream, from the same
measured profiles, on the online control plane
(:class:`repro_torch.serve.controller.FleetController`, on ``--device``)
window by window, with per-tick decision records, flight-recorder tails
and checkpointed crash restart (``--checkpoint``); ``--snapshot-out``
writes the final ``metrics_snapshot()`` as JSON.  The first SIGINT or
SIGTERM drains: the stream stops at the next poll, buffered ticks are
stepped, the final checkpoint and snapshot are written.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import signal
import time

import numpy as np

from repro_torch.configs.base import reduced
from repro_torch.configs.registry import ARCHS
from repro_torch.core.schedulers import ALL_POLICIES, make_policy
from repro_torch.core.task import ModelProfile
from repro_torch.serve.engine import ServableModel, ServeEngine, run_stream

# role → (arch, share of the edge, deadline multiple of p95, β, K, K̂)
ROLES = {"HV": ("starcoder2-3b", 0.7, 3.0, 125, 1, 25),
         "DEV": ("granite-3-2b", 0.4, 5.0, 100, 1, 26),
         "BP": ("xlstm-1.3b", 0.3, 8.0, 40, 2, 43)}


def role_config(arch: str, *, full_size: bool = False,
                attn_impl: str = "ref"):
    """A role's model config: the JAX launcher's reduced variant (2 layers,
    d_model 192, vocab 512, f32) or the published one (bf16)."""
    cfg = ARCHS[arch]
    if not full_size:
        cfg = reduced(cfg, n_layers=2, d_model=192, vocab=512)
    return dataclasses.replace(cfg, attn_impl=attn_impl)


def probe_p95(model: ServableModel, iters: int = 20) -> float:
    """Warm up + measure a servable model's p95 latency [ms].

    The first call hits any residual build cost, so the percentile is
    taken over ``iters`` steady-state invocations.
    """
    ts = []
    for _ in range(iters):
        t0 = time.monotonic()
        model.run()
        ts.append((time.monotonic() - t0) * 1e3)
    return float(np.percentile(ts, 95))


def build_roles(cloud_concurrency: int = 4, *, device="cuda",
                full_size: bool = False, attn_impl: str = "ref"
                ) -> tuple[dict[str, ServableModel], dict[str, float]]:
    """Register the Ocularone DNN roles and calibrate their profiles.

    Returns ``(models, fps)``: servable models re-profiled from their
    measured p95 (deadline, edge/cloud latencies) and each role's target
    frame rate.  ``cloud_concurrency`` is accepted for the JAX launcher's
    signature and unused here, as there.
    """
    models, fps = {}, {}
    for name, (arch, share, dlm, beta, ke, kc) in ROLES.items():
        cfg = role_config(arch, full_size=full_size, attn_impl=attn_impl)
        prof = ModelProfile(name=name, beta=beta, deadline=1.0, t_edge=1.0,
                            t_cloud=1.0, cost_edge=ke, cost_cloud=kc,
                            qoe_beta=100.0, qoe_alpha=0.9,
                            qoe_window=5_000.0)
        sm = ServableModel.from_arch(prof, cfg, batch=1, seq=64,
                                     device=device)
        t95 = probe_p95(sm)
        fps[name] = min(60.0, share * 1000.0 / t95)
        prof = dataclasses.replace(prof, deadline=dlm * t95 + 30.0,
                                   t_edge=t95, t_cloud=t95 * 0.7 + 60.0)
        models[name] = dataclasses.replace(sm, profile=prof)
        print(f"{name}: p95 {t95:.1f} ms, {fps[name]:.1f} FPS, "
              f"deadline {prof.deadline:.0f} ms", flush=True)
    return models, fps


def serve_fleet(args, models: dict, fps: dict) -> dict:
    """``--backend fleet``: the frame stream through a
    :class:`~repro_torch.serve.controller.FleetController`; returns the
    final snapshot."""
    from repro_torch.serve.controller import FleetController, drive_stream
    ctl = FleetController(
        [m.profile for m in models.values()], args.policy,
        n_edges=args.edges, cloud_slots=args.cloud_concurrency,
        checkpoint_path=args.checkpoint, device=args.device)
    # graceful shutdown: the first SIGINT/SIGTERM stops the stream at the
    # next poll; drive_stream still flushes buffered ticks and writes the
    # final checkpoint, and the snapshot is written as on a normal exit.
    # A second signal interrupts hard.
    interrupted = []

    def _graceful(signum, frame):
        if interrupted:
            raise KeyboardInterrupt
        interrupted.append(signum)
        print(f"signal {signum}: draining — final checkpoint and snapshot "
              f"on the way (repeat to force-quit)", flush=True)

    previous = {s: signal.signal(s, _graceful)
                for s in (signal.SIGINT, signal.SIGTERM)}
    try:
        snap = drive_stream(ctl, fps, args.duration * 1e3,
                            stop=lambda: bool(interrupted))
    finally:
        for s, h in previous.items():
            signal.signal(s, h)
    if args.snapshot_out:
        with open(args.snapshot_out, "w") as f:
            json.dump(snap, f, indent=2, default=float)
    print(json.dumps(
        {k: snap[k] for k in ("policy", "completed", "missed", "dropped",
                              "completion_rate", "windows_run",
                              "step_latency_ms")},
        indent=2, default=float), flush=True)
    return snap


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--policy", default="GEMS", choices=list(ALL_POLICIES))
    ap.add_argument("--duration", type=float, default=15.0)
    ap.add_argument("--cloud-concurrency", type=int, default=4)
    ap.add_argument("--backend", default="thread",
                    choices=("thread", "fleet"),
                    help="thread = ServeEngine with live forward passes; "
                         "fleet = the FleetController tick program")
    ap.add_argument("--edges", type=int, default=2,
                    help="[fleet] number of edges in the fleet")
    ap.add_argument("--checkpoint", default=None,
                    help="[fleet] checkpoint path stem for crash restart")
    ap.add_argument("--snapshot-out", default=None,
                    help="[fleet] write the final metrics_snapshot() JSON")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--attn-impl", default="ref", choices=("ref", "kernel"),
                    help="kernel = every op of the models' path that has a "
                         "hand-written CUDA kernel (flash attention, flash "
                         "decode, RMSNorm, the Mamba2 selective scan); ref = "
                         "plain PyTorch.  CPU tensors take the plain "
                         "versions either way")
    args = ap.parse_args(argv)

    models, fps = build_roles(args.cloud_concurrency, device=args.device,
                              attn_impl=args.attn_impl)
    if args.backend == "fleet":
        serve_fleet(args, models, fps)
        return
    engine = ServeEngine(make_policy(args.policy), models,
                         cloud_concurrency=args.cloud_concurrency)
    result = run_stream(engine, fps, args.duration * 1e3)
    print(result.summary())


if __name__ == "__main__":
    main()

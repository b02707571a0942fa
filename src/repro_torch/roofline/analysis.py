"""Roofline terms of a dry-run step (no card needed).

Port of ``repro.roofline.analysis``.  Terms per (arch × shape × mesh),
all **per device** (the dry run traces one rank's program):

    compute_s    = FLOPs / PEAK_FLOPS_BF16
    memory_s     = bytes / HBM_BW
    collective_s = collective_bytes / NVLINK_BW

on the H100 constants of :mod:`repro_torch.launch.mesh` (NVIDIA H100
80GB HBM3, 700 W; NVLink's rate a direction stands where the JAX package
has the TPU's ICI link).  Every collective byte is charged at that
NVLink rate, though a 16×16 or 2×16×16 mesh spans 32 or 64 nodes of 8
cards and most of its links cross nodes at a lower rate, so
``collective_s`` is a lower bound (:data:`COLLECTIVE_NOTE`).  The delta method is kept: the step is traced
at two small layer counts L₁ < L₂ and ``base + L·per_layer`` is
extrapolated to the full depth.

The JAX package parses the collectives out of XLA's optimized HLO text.
The port has no HLO: the dry run records every collective the step's
DTensor redistributions and ``torch.distributed`` calls issue on the
fake process group (kind, dtype, shape of its result, as
:class:`Collective`), and :func:`collective_bytes` totals that record
per kind, with ``"total"``.
"""
from __future__ import annotations

import dataclasses

from repro_torch.launch.mesh import HBM_BW, NVLINK_BW, PEAK_FLOPS_BF16

COLLECTIVE_NOTE = ("collective bytes charged at NVLink's 450 GB/s a "
                   "direction; most links of a 256- or 512-card mesh cross "
                   "8-card nodes at a lower rate, so collective_s is a "
                   "lower bound")

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")


@dataclasses.dataclass
class Collective:
    computation: str        # where it was issued ("entry" for the step)
    kind: str               # one of COLLECTIVES
    dtype: str
    shape: tuple[int, ...]  # of its result
    bytes: int


def collective_bytes(record: list[Collective],
                     body_trip_count: int = 1) -> dict:
    """Total bytes of a recorded step's collectives, per kind and
    ``"total"``; those issued inside a loop body (``computation``
    containing ``"body"`` or ``"while"``) scaled by its trip count."""
    per_kind: dict[str, float] = {k: 0.0 for k in COLLECTIVES}
    total = 0.0
    for c in record:
        mult = body_trip_count if ("body" in c.computation
                                   or "while" in c.computation) else 1
        per_kind[c.kind] += c.bytes * mult
        total += c.bytes * mult
    per_kind["total"] = total
    return per_kind


@dataclasses.dataclass
class RooflineTerms:
    flops: float               # per device
    hbm_bytes: float           # per device
    coll_bytes: float          # per device
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str

    @classmethod
    def build(cls, flops: float, hbm_bytes: float,
              coll_bytes: float) -> "RooflineTerms":
        c = flops / PEAK_FLOPS_BF16
        m = hbm_bytes / HBM_BW
        n = coll_bytes / NVLINK_BW
        names = {"compute": c, "memory": m, "collective": n}
        return cls(flops, hbm_bytes, coll_bytes, c, m, n,
                   bottleneck=max(names, key=names.get))


def extrapolate(v1: float, v2: float, l1: int, l2: int,
                l_full: float) -> float:
    """base + L·per_layer through (l1, v1), (l2, v2) evaluated at l_full."""
    per = (v2 - v1) / (l2 - l1)
    base = v1 - per * l1
    return max(base + per * l_full, 0.0)


def model_flops(cfg, shape_name: str, seq: int, batch: int) -> float:
    """Analytic MODEL_FLOPS: 6·N·D for training, 2·N_active·D for serving
    (decode: D = batch tokens per step)."""
    n = cfg.active_param_count()
    if shape_name.startswith("train"):
        return 6.0 * n * seq * batch
    if shape_name.startswith("prefill"):
        return 2.0 * n * seq * batch
    return 2.0 * n * batch          # decode: one token per sequence

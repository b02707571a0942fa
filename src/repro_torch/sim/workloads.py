"""Workload generators (paper §8.1, §8.3, §8.7); a copy of
``repro.sim.workloads``, drawing the same seeded streams.

Each drone streams video; the splitter cuts 1 s segments, and the task
creator emits one task per registered DNN model per segment, inserted in a
*randomized order* (§3.3) to avoid favoring any model.

Standard QoS workloads: {2,3,4} drones × {Passive, Active} over 300 s →
2400–7200 tasks per base station (matching §8.3's counts).  GEMS QoE
workloads WL1/WL2 use the Table-2 profiles with α ∈ {0.9, 1.0}.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.task import ACTIVE, PASSIVE, TABLE1, ModelProfile, table2
from repro_torch.sim.engine import Arrival

DEFAULT_DURATION_MS = 300_000.0
SEGMENT_MS = 1_000.0


def task_stream(models: list[ModelProfile], n_drones: int,
                duration_ms: float = DEFAULT_DURATION_MS,
                segment_ms: float = SEGMENT_MS,
                seed: int = 0) -> list[Arrival]:
    """One task per (drone, segment, model), model order shuffled/segment."""
    rng = np.random.default_rng(seed)
    arrivals: list[Arrival] = []
    n_segments = int(duration_ms / segment_ms)
    for d in range(n_drones):
        # drones are not frame-synchronized: random phase within a segment
        phase = float(rng.uniform(0, segment_ms))
        for s in range(n_segments):
            t = s * segment_ms + phase
            if t >= duration_ms:
                continue
            order = rng.permutation(len(models))
            for k in order:
                arrivals.append(Arrival(time=t, model=models[int(k)], drone=d))
    return arrivals


def standard(workload: str, duration_ms: float = DEFAULT_DURATION_MS,
             seed: int = 0) -> list[Arrival]:
    """Paper workloads ``{2,3,4}D-{P,A}``, e.g. ``"4D-A"`` (§8.3)."""
    drones = int(workload[0])
    kind = workload.split("-")[1]
    names = PASSIVE if kind == "P" else ACTIVE
    models = [TABLE1[n] for n in names]
    return task_stream(models, drones, duration_ms, seed=seed)


STANDARD_WORKLOADS = ("2D-P", "2D-A", "3D-P", "3D-A", "4D-P", "4D-A")


def gems_workload(name: str, alpha: float,
                  n_drones: int = 3,
                  duration_ms: float = DEFAULT_DURATION_MS,
                  seed: int = 0) -> list[Arrival]:
    """GEMS QoE workloads WL1/WL2 (§8.7, Table 2), α ∈ {0.9, 1.0}."""
    models = table2(name, alpha)
    return task_stream(models, n_drones, duration_ms, seed=seed)

"""Policy flag table of the scheduler registry (paper §8.2 baselines,
DEM/DEMS/DEMS-A, GEMS and the beyond-paper GEMS-B).

A copy of ``repro.core.schedulers._POLICIES``; the fleet port derives
its :class:`~repro_torch.sim.fleet.FleetPolicy` flag sets from it.
"""
from __future__ import annotations

_POLICIES = {
    "EDF":     dict(use_cloud=False, edge_feasibility_check=False),
    "HPF":     dict(use_cloud=False, edge_feasibility_check=False,
                    edge_priority="hpf"),
    "CLD":     dict(use_edge=False),
    "EDF-E+C": dict(),
    "SJF-E+C": dict(edge_priority="sjf", cloud_accepts_negative=True),
    "SOTA1":   dict(sota1=True),
    "SOTA2":   dict(edge_priority="sjf", sota2=True),
    "DEM":     dict(migration=True),
    "DEMS":    dict(migration=True, stealing=True),
    "DEMS-A":  dict(migration=True, stealing=True, adaptive=True),
    "GEMS":    dict(migration=True, stealing=True, gems=True),
    "GEMS-A":  dict(migration=True, stealing=True, gems=True, adaptive=True),
    # Beyond-paper: GEMS-B reschedules only while the QoE window is still
    # winnable (remaining arrivals could lift α̂ to α).
    "GEMS-B":  dict(migration=True, stealing=True, gems=True,
                    gems_budget=True),
}

ALL_POLICIES = tuple(_POLICIES)

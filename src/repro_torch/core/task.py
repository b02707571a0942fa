"""Task and utility model of the paper's workloads (paper §4, Tables 1
and 2).

A copy of ``repro.core.task``: the port keeps its own so that it never
imports the JAX package.  Each model carries a benefit ``β_i``, a
deadline duration ``δ_i``, expected execution latencies on the edge
(``t_i``) and cloud (``t̂_i``) and per-task monetary costs ``K_i``
(edge) / ``K̂_i`` (cloud).  A :class:`Task` is one execution of a model
on one video segment; its realized QoS utility follows Eqn 1
(γ^E = β−K on time at the edge, −K late; γ^C = β−K̂ / −K̂ on the cloud;
0 dropped).  All times are in milliseconds.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional


class Outcome(enum.Enum):
    """Terminal state of a task (paper Eqn 1 cases)."""

    EDGE_SUCCESS = "edge_success"
    EDGE_MISS = "edge_miss"
    CLOUD_SUCCESS = "cloud_success"
    CLOUD_MISS = "cloud_miss"
    DROPPED = "dropped"


@dataclasses.dataclass(frozen=True)
class ModelProfile:
    """Static profile of a registered DNN model μ_i (paper Table 1 / 2)."""

    name: str
    beta: float          # QoS benefit β_i
    deadline: float      # deadline duration δ_i  [ms]
    t_edge: float        # expected edge latency t_i  [ms]
    t_cloud: float       # expected cloud latency t̂_i  [ms]
    cost_edge: float     # per-task edge cost K_i
    cost_cloud: float    # per-task cloud cost K̂_i
    qoe_beta: float = 0.0    # QoE window benefit β̄_i (Eqn 2)
    qoe_alpha: float = 0.0   # required completion rate α_i in a window
    qoe_window: float = 20_000.0  # window duration ω_i  [ms]

    @property
    def gamma_edge(self) -> float:
        """Expected utility of an on-time edge execution, γ^E = β − K."""
        return self.beta - self.cost_edge

    @property
    def gamma_cloud(self) -> float:
        """Expected utility of an on-time cloud execution, γ^C = β − K̂."""
        return self.beta - self.cost_cloud

    @property
    def hpf_rank(self) -> float:
        """Utility-per-edge-time rank used by the HPF baseline (§8.2)."""
        return self.gamma_edge / self.t_edge

    def steal_rank(self) -> float:
        """Work-stealing rank (§5.3): (γ^E − γ^C) / t_i."""
        return (self.gamma_edge - self.gamma_cloud) / self.t_edge


@dataclasses.dataclass
class Task:
    """One inference task τ_i^j."""

    uid: int
    model: ModelProfile
    created: float               # t'_j  [ms] — segment creation time
    drone: int = 0
    # -- scheduling state ----------------------------------------------
    deadline_ext: float = 0.0    # SOTA1 deadline buffer (scheduling only)
    steal_only: bool = False     # negative-cloud-utility task parked on the
                                 # cloud queue purely to be stolen (§5.3)
    gems_rescheduled: bool = False
    stolen: bool = False
    migrated: bool = False
    # -- result ---------------------------------------------------------
    outcome: Optional[Outcome] = None
    finished: Optional[float] = None  # completion timestamp [ms]

    @property
    def abs_deadline(self) -> float:
        """Absolute deadline t'_j + δ_i (also the EDF priority, §5.1)."""
        return self.created + self.model.deadline

    @property
    def sched_deadline(self) -> float:
        """Deadline used for *scheduling* decisions (SOTA1 may extend it)."""
        return self.abs_deadline + self.deadline_ext

    def utility(self) -> float:
        """Realized QoS utility γ_i^j (Eqn 1)."""
        m = self.model
        if self.outcome is Outcome.EDGE_SUCCESS:
            return m.gamma_edge
        if self.outcome is Outcome.EDGE_MISS:
            return -m.cost_edge
        if self.outcome is Outcome.CLOUD_SUCCESS:
            return m.gamma_cloud
        if self.outcome is Outcome.CLOUD_MISS:
            return -m.cost_cloud
        return 0.0

    @property
    def success(self) -> bool:
        return self.outcome in (Outcome.EDGE_SUCCESS, Outcome.CLOUD_SUCCESS)


def migration_score(m: ModelProfile, cloud_feasible: bool) -> float:
    """DEM migration score S_i^j (Eqn 3).

    S = γ^E − γ^C   if the task would finish on time on the cloud and
                    γ^C > 0 (cheap to hand over — small score);
    S = γ^E         otherwise (handing it over forfeits its whole value).
    """
    if cloud_feasible and m.gamma_cloud > 0:
        return m.gamma_edge - m.gamma_cloud
    return m.gamma_edge


# Table 1 — Jetson Nano / AWS Lambda profiles for the six Ocularone DNNs.
#                      name   β     δ      t     t̂     K   K̂
TABLE1 = {
    "HV":  ModelProfile("HV", 125,  650, 174, 398, 1,  25),
    "DEV": ModelProfile("DEV", 100, 750, 172, 429, 1,  26),
    # Table 1 lists K̂=15 for MD but its γ^C column says 50 = 75−25; the
    # γ columns drive every heuristic, so K̂=25 (15 is a typo).
    "MD":  ModelProfile("MD",  75,  850, 142, 589, 1,  25),
    "BP":  ModelProfile("BP",  40,  900, 244, 542, 2,  43),   # γ^C = −3 !
    "CD":  ModelProfile("CD", 175, 1000, 563, 878, 4, 152),
    "DEO": ModelProfile("DEO", 250, 950, 739, 832, 6, 210),
}

PASSIVE = ("HV", "DEV", "MD", "BP")
ACTIVE = ("HV", "DEV", "MD", "BP", "CD", "DEO")


def table2(workload: str, alpha: float) -> list[ModelProfile]:
    """Table 2 — GEMS QoE workloads WL1 / WL2 on the alternate edge/cloud.

    QoS β and costs K, K̂ are retained from Table 1; β̄, δ, t, t̂ come from
    Table 2; ω = 20 s for all models (§6.1).
    """
    def mk(name: str, qoe_beta: float, dl: float, te: float,
           tc: float) -> ModelProfile:
        return dataclasses.replace(
            TABLE1[name], deadline=dl, t_edge=te, t_cloud=tc,
            qoe_beta=qoe_beta, qoe_alpha=alpha, qoe_window=20_000.0)

    if workload == "WL1":
        return [mk("HV", 360, 400, 100, 200), mk("DEV", 420, 600, 300, 400),
                mk("MD", 480, 1000, 200, 300), mk("CD", 600, 800, 650, 750)]
    if workload == "WL2":
        return [mk("HV", 360, 400, 100, 200), mk("DEV", 420, 600, 300, 400),
                mk("MD", 480, 800, 200, 300), mk("CD", 600, 1000, 750, 950)]
    raise ValueError(f"unknown GEMS workload {workload!r}")


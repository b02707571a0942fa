"""Scheduling policies: DEMS family (§5) and the seven baselines (§8.2).

A copy of ``repro.core.schedulers``.  The fleet port derives its
:class:`~repro_torch.sim.fleet.FleetPolicy` flag sets from the
``_POLICIES`` table; the serve engine consults a :class:`Policy` — a
small strategy object that owns *decision logic only* (queues, executors
and clocks live in ``repro_torch.serve.engine``).  Policies, by paper
name: EDF, HPF, CLD, EDF-E+C, SJF-E+C, SOTA1 (Kalmia+D3), SOTA2
(Dedas), DEM, DEMS, DEMS-A, GEMS, GEMS-A and the beyond-paper GEMS-B.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core.task import Task, migration_score


@dataclasses.dataclass
class CloudAccept:
    """Outcome of offering a task to the cloud scheduler."""

    accept: bool
    trigger: float = 0.0       # earliest dispatch time (trigger-time queue)
    steal_only: bool = False   # parked only so the edge may steal it


@dataclasses.dataclass
class Policy:
    name: str
    use_edge: bool = True
    use_cloud: bool = True
    edge_feasibility_check: bool = True   # reject infeasible edge inserts
    migration: bool = False               # DEM scoring (§5.2)
    stealing: bool = False                # work stealing + trigger times (§5.3)
    adaptive: bool = False                # DEMS-A latency adaptation (§5.4)
    gems: bool = False                    # GEMS window rescheduling (§6)
    gems_budget: bool = False             # GEMS-B: skip rescheduling once the
                                          # window is unrecoverable
    cloud_accepts_negative: bool = False  # SJF-E+C sends γ^C<0 tasks anyway
    edge_priority: str = "edf"            # "edf" | "hpf" | "sjf"
    sota1: bool = False
    sota2: bool = False
    cloud_margin: float = 50.0            # trigger-time safety margin [ms]
    urgent_deadline: float = 700.0        # SOTA1 urgency threshold [ms]

    # ------------------------------------------------------------------
    # Edge queue ordering
    # ------------------------------------------------------------------
    def edge_key(self, task: Task) -> float:
        if self.edge_priority == "edf":
            return task.sched_deadline          # §5.1: priority t'_j + δ_i
        if self.edge_priority == "hpf":
            return -task.model.hpf_rank         # §8.2 greedy utility rate
        if self.edge_priority == "sjf":
            return task.model.t_edge            # SJF / Dedas ordering
        raise ValueError(self.edge_priority)

    # ------------------------------------------------------------------
    # Cloud admission (§5.1 / §5.3)
    # ------------------------------------------------------------------
    def offer_cloud(self, task: Task, now: float,
                    t_cloud: float) -> CloudAccept:
        """Cloud scheduler admission check for ``task`` at time ``now``;
        ``t_cloud`` is the *current* expected cloud latency for the model
        (static, or DEMS-A-adapted)."""
        if not self.use_cloud:
            return CloudAccept(False)
        m = task.model
        feasible = now + t_cloud <= task.abs_deadline
        if not feasible:
            return CloudAccept(False)
        if m.gamma_cloud <= 0 and not self.cloud_accepts_negative:
            if not self.stealing:
                return CloudAccept(False)
            # §5.3: park negative-utility tasks to be stolen; trigger is the
            # latest time the task could still start on the *edge*.
            trigger = task.abs_deadline - m.t_edge
            if trigger < now:
                return CloudAccept(False)
            return CloudAccept(True, trigger=trigger, steal_only=True)
        if self.stealing:
            trigger = max(now, task.abs_deadline - t_cloud - self.cloud_margin)
            return CloudAccept(True, trigger=trigger)
        return CloudAccept(True, trigger=now)   # FIFO, dispatch immediately

    # ------------------------------------------------------------------
    # Migration scoring (§5.2, Eqn 3)
    # ------------------------------------------------------------------
    @staticmethod
    def migration_decision(new: Task, victims: list[Task], now: float,
                           t_cloud_of) -> bool:
        """True → insert ``new`` on the edge and migrate ``victims`` to the
        cloud; False → redirect ``new`` itself to the cloud.  A victim's
        score uses Eqn 3 with its *current* cloud feasibility."""
        def score(t: Task) -> float:
            feas = now + t_cloud_of(t.model) <= t.abs_deadline
            return migration_score(t.model, feas)

        s_new = score(new)
        s_victims = sum(score(v) for v in victims)
        return s_victims < s_new


@dataclasses.dataclass
class AdaptiveEstimator:
    """DEMS-A sliding-window cloud-latency estimator for one model (§5.4).

    Keeps a circular buffer of the last ``w`` observed cloud durations.
    When their average exceeds the current estimate by ``eps`` the estimate
    is raised to the average.  If the inflated estimate causes tasks to be
    skipped for longer than the cooling period ``t_cp``, reset to the
    static default and re-probe.
    """

    static: float
    w: int = 10
    eps: float = 10.0
    t_cp: float = 10_000.0
    current: float = dataclasses.field(default=0.0)
    _buf: list[float] = dataclasses.field(default_factory=list)
    _idx: int = 0
    _cooling_start: Optional[float] = None

    def __post_init__(self) -> None:
        if self.current == 0.0:
            self.current = self.static

    def observe(self, duration: float) -> None:
        if len(self._buf) < self.w:
            self._buf.append(duration)
        else:
            self._buf[self._idx] = duration
            self._idx = (self._idx + 1) % self.w
        avg = sum(self._buf) / len(self._buf)
        if avg - self.current > self.eps:
            self.current = avg

    def on_sent(self) -> None:
        self._cooling_start = None

    def on_skip(self, now: float) -> None:
        """A task was skipped because ``current`` predicts a deadline miss."""
        if self.current <= self.static:
            return
        if self._cooling_start is None:
            self._cooling_start = now
        elif now - self._cooling_start >= self.t_cp:
            self.current = self.static          # point-of-no-return reset
            self._cooling_start = None

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


def make_policy(name: str, **overrides) -> Policy:
    if name not in _POLICIES:
        raise ValueError(f"unknown policy {name!r}; choose from {ALL_POLICIES}")
    kw = dict(_POLICIES[name])
    kw.update(overrides)
    return Policy(name=name, **kw)

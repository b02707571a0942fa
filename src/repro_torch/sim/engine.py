"""Per-model outcome counters and run results of a scheduling run.

The part of ``repro.sim.engine`` the serve engine needs (``ModelStats``,
``Results``); the discrete-event simulator and ``FleetOracle`` are not
ported yet.  Time unit: milliseconds.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class ModelStats:
    generated: int = 0
    edge_success: int = 0
    cloud_success: int = 0
    edge_miss: int = 0
    cloud_miss: int = 0
    dropped: int = 0
    stolen: int = 0
    migrated: int = 0
    gems_rescheduled: int = 0
    qos_utility: float = 0.0
    edge_utility: float = 0.0
    cloud_utility: float = 0.0
    qoe_utility: float = 0.0
    windows_met: int = 0
    windows_total: int = 0

    @property
    def completed(self) -> int:
        return self.edge_success + self.cloud_success


@dataclasses.dataclass
class Results:
    policy: str
    duration: float
    per_model: dict[str, ModelStats]
    edge_busy: float = 0.0

    def _sum(self, attr: str) -> float:
        return sum(getattr(s, attr) for s in self.per_model.values())

    @property
    def generated(self) -> int: return int(self._sum("generated"))
    @property
    def completed(self) -> int: return int(self._sum("completed"))
    @property
    def completion_rate(self) -> float:
        return self.completed / max(self.generated, 1)
    @property
    def qos_utility(self) -> float: return self._sum("qos_utility")
    @property
    def edge_utility(self) -> float: return self._sum("edge_utility")
    @property
    def cloud_utility(self) -> float: return self._sum("cloud_utility")
    @property
    def qoe_utility(self) -> float: return self._sum("qoe_utility")
    @property
    def total_utility(self) -> float:
        return self.qos_utility + self.qoe_utility
    @property
    def stolen(self) -> int: return int(self._sum("stolen"))
    @property
    def migrated(self) -> int: return int(self._sum("migrated"))
    @property
    def gems_rescheduled(self) -> int: return int(self._sum("gems_rescheduled"))
    @property
    def edge_utilization(self) -> float:
        return self.edge_busy / max(self.duration, 1e-9)

    def summary(self) -> str:
        return (f"{self.policy:8s} tasks={self.completed}/{self.generated} "
                f"({100 * self.completion_rate:.1f}%) QoS={self.qos_utility:.0f} "
                f"QoE={self.qoe_utility:.0f} total={self.total_utility:.0f} "
                f"edge_util={100 * self.edge_utilization:.0f}% "
                f"stolen={self.stolen} migrated={self.migrated} "
                f"gems={self.gems_rescheduled}")

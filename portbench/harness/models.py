"""The model table a traffic mix lists, handed alike to the program and
to the reference (both read the same attributes)."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelRow:
    """One DNN model of the paper's Table 1 or Table 2: QoS benefit β,
    deadline δ, edge and cloud latencies t and t̂ (ms), per-task costs K
    and K̂, and the QoE window terms β̄, α and ω."""

    name: str
    beta: float
    deadline: float
    t_edge: float
    t_cloud: float
    cost_edge: float
    cost_cloud: float
    qoe_beta: float = 0.0
    qoe_alpha: float = 0.0
    qoe_window: float = 20_000.0

    @property
    def gamma_edge(self) -> float:
        return self.beta - self.cost_edge

    @property
    def gamma_cloud(self) -> float:
        return self.beta - self.cost_cloud

    def steal_rank(self) -> float:
        return (self.gamma_edge - self.gamma_cloud) / self.t_edge


def model_rows(mix: dict) -> list:
    """The mix's ``models`` entries as :class:`ModelRow` objects."""
    return [ModelRow(**row) for row in mix["models"]]

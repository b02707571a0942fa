"""The yardstick's arithmetic for a kernel's least time: bytes each input
read once and each output written once, at the card's published peak."""
from __future__ import annotations

# NVIDIA H100 SXM data sheet: 80 GB of HBM3 at 3.35 TB/s (at the full
# power limit of 700 W)
H100_HBM_BYTES_PER_S = 3.35e12


def argext_bytes(rows: int, entries: int) -> int:
    """One call of the masked arg-extremum on a ``(rows, entries)`` tile:
    f32 scores and a bool mask read, an int32 index and an f32 value a row
    written."""
    return rows * entries * (4 + 1) + rows * (4 + 4)


def bound_s(nbytes: float, bytes_per_s: float = H100_HBM_BYTES_PER_S
            ) -> float:
    """The least seconds to move ``nbytes`` at the card's memory rate (the
    selection does no arithmetic worth a bound of its own)."""
    return nbytes / bytes_per_s

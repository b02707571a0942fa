"""Chaos engine: deterministic fault schedules for both simulators (a
copy of ``repro.faults``)."""
from repro_torch.faults.compile import (bw_cap_fn, crash_windows,
                                        edge_up_dense, flood_events,
                                        link_up_dense, partition_windows,
                                        perturb_telemetry, theta_overlay_fn)
from repro_torch.faults.spec import (Brownout, EdgeCrash, FaultSpec, Flood,
                                     Jamming, Partition, TelemetryChaos)

__all__ = [
    "Brownout", "EdgeCrash", "FaultSpec", "Flood", "Jamming", "Partition",
    "TelemetryChaos", "bw_cap_fn", "crash_windows", "edge_up_dense",
    "flood_events", "link_up_dense", "partition_windows",
    "perturb_telemetry", "theta_overlay_fn",
]

"""The median, over the window's polls, of poll's host time less the
step latency the controller recorded for that poll's window: the window
SignalWindowBuilder.emit_window and the readback of the counters."""
import numpy as np

UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "control plane"
MOVES = "decision_p95_ms"


def read(obs: dict):
    ms = obs.get("ctl_host_ms") if obs.get("driver") == "stream" else None
    return float(np.median(ms)) if ms else None

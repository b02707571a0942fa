"""The median, over the traced run's windows, of the device span between
CUDA events recorded around step_chunk, over the window's ticks."""
import numpy as np

UNIT = "ms"
BETTER = "lower"
SOURCE = "device_trace"
LAYER = "tick program"
MOVES = "decision_p95_ms"


def read(obs: dict):
    ms = obs.get("tick_device_ms") if obs.get("driver") == "stream" \
        else None
    return float(np.median(ms)) if ms else None

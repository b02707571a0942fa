"""The share of the traced run's unprofiled window (mission restarts
included) in which the device ran nothing the program was asked for:
1 less the CUDA-event spans around every poll's step, summed, over the
window's host-clock seconds."""
UNIT = "%"
BETTER = "lower"
SOURCE = "device_trace"
LAYER = "device"
MOVES = "decision_p95_ms"


def read(obs: dict):
    if obs.get("driver") != "stream" or "event_busy_s" not in obs \
            or not obs.get("window_s"):
        return None
    return 100.0 * (1.0 - obs["event_busy_s"] / obs["window_s"])

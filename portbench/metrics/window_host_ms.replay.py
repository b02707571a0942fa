"""The median host time until FleetProgram.step_chunk returns for one
window of the traced run (the copies in, the replay's launch and the
clones out, enqueued), over each mission's first windows: later ones
wait for room in the device's queue, and time the device instead."""
import numpy as np

UNIT = "ms"
BETTER = "lower"
SOURCE = "host_clock"
LAYER = "fleet entry"
MOVES = "edge_ticks_per_s"


def read(obs: dict):
    ms = obs.get("window_host_ms") if obs.get("driver") == "replay" \
        else None
    return float(np.median(ms)) if ms else None

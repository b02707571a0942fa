"""Stream: the 95th percentile, over every poll of the window, of the
host clock from the call of FleetController.poll to its return of the
decision records, after the card's work."""
import numpy as np

UNIT = "ms"
BETTER = "lower"
SOURCE = "host_clock"


def read(obs: dict):
    ms = obs.get("poll_ms") if obs.get("driver") == "stream" else None
    return float(np.percentile(ms, 95)) if ms else None

"""Replay: every simulated (tick, edge) cell of every mission in the
window over the window's whole host-clock time (mission restarts
inside; the window ends with a mission and a sync)."""
UNIT = "edge-ticks/s"
BETTER = "higher"
SOURCE = "host_clock"


def read(obs: dict):
    if obs.get("driver") != "replay" or not obs.get("window_s"):
        return None
    return obs["edge_ticks"] / obs["window_s"]

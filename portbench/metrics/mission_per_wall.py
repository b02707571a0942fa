"""Stream: mission seconds scheduled over the window's host-clock
seconds, submit calls included (1 is the pace of the drones)."""
UNIT = "s/s"
BETTER = "higher"
SOURCE = "host_clock"


def read(obs: dict):
    if obs.get("driver") != "stream" or not obs.get("window_s"):
        return None
    return obs["mission_s"] / obs["window_s"]

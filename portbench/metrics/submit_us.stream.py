"""The host time of all submit calls of the window over the tasks
submitted."""
UNIT = "us"
BETTER = "lower"
SOURCE = "host_clock"
LAYER = "control plane"
MOVES = "mission_per_wall"


def read(obs: dict):
    if obs.get("driver") != "stream" or not obs.get("submits"):
        return None
    return obs["submit_s"] / obs["submits"] * 1e6

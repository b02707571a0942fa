"""Set-up: the host clock from the process's start to the first timed
window (imports, CUDA, the kernels' load or build, the seed's inputs
placed on the card, the warm windows and every graph's capture)."""
UNIT = "s"
BETTER = "lower"
SOURCE = "host_clock"


def read(obs: dict):
    return obs.get("setup_s")

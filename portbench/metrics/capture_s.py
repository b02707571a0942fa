"""Capture and instantiation seconds of every graph made in set-up, from
the program's capture records (CompileCounter over set-up)."""
UNIT = "s"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "program cache and capture"
MOVES = "setup_s"


def read(obs: dict):
    return obs["capture_s"] if obs.get("captures") else None

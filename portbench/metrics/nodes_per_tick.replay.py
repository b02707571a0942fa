"""CUDA-graph nodes over ticks, over every graph the program cache holds
after set-up: a count, the same in every run."""
UNIT = "nodes"
BETTER = "lower"
SOURCE = "program_counter"
LAYER = "tick program"
MOVES = "edge_ticks_per_s"


def read(obs: dict):
    nodes, ticks = obs.get("graph_nodes") or (0, 0)
    if obs.get("driver") != "replay" or not ticks:
        return None
    return nodes / ticks

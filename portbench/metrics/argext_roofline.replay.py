"""The selection kernel's least time over its measured time: the mean,
over the calls a captured window holds, of each call's bytes (inputs read
once, outputs written once) at the H100's published 3.35 TB/s, over the
mean duration of the profiled sub-window's masked_argext records."""
from portbench.harness import roofline

UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
LAYER = "selection kernel"
MOVES = "edge_ticks_per_s"


def read(obs: dict):
    prof, shapes = obs.get("profile"), obs.get("argext_shapes")
    if obs.get("driver") != "replay" or not prof or not shapes:
        return None
    us = prof["durations_us"]("masked_argext")
    if not us:
        return None
    least = sum(roofline.bound_s(roofline.argext_bytes(*s))
                for s in shapes) / len(shapes)
    return 100.0 * least / (sum(us) / len(us) / 1e6)

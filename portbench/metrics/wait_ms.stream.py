"""The median, over the run's polls, of the program's ``ctl.wait`` span:
the controller's synchronize after the window's replay, the card's time
for the window less what the host enqueued meanwhile."""
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "tick program"
MOVES = "decision_p95_ms"


def read(obs: dict):
    if obs.get("driver") != "stream":
        return None
    try:
        from repro_torch.obs.prof import span_table
    except ImportError:          # a program without the span table
        return None
    row = span_table("ctl.wait").get("ctl.wait")
    return row["median_s"] * 1e3 if row else None

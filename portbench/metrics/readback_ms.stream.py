"""The median, over the run's polls, of the program's ``ctl.record``
span: the window's TickCounters to the host, the decision records and
the histogram sums."""
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "control plane"
MOVES = "decision_p95_ms"


def read(obs: dict):
    if obs.get("driver") != "stream":
        return None
    try:
        from repro_torch.obs.prof import span_table
    except ImportError:          # a program without the span table
        return None
    row = span_table("ctl.record").get("ctl.record")
    return row["median_s"] * 1e3 if row else None

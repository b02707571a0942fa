"""The median, over the run's replayed windows, of the program's
``fleet.clone_out`` span: the state and the counters cloned out of the
graph's memory."""
UNIT = "us"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "fleet entry"
MOVES = "decision_p95_ms"


def read(obs: dict):
    if obs.get("driver") != "stream":
        return None
    try:
        from repro_torch.obs.prof import span_table
    except ImportError:          # a program without the span table
        return None
    row = span_table("fleet.clone_out").get("fleet.clone_out")
    return row["median_s"] * 1e6 if row else None

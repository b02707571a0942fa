"""The median, over the run's replayed windows, of the program's
``fleet.launch`` span: the host's ``CUDAGraph.replay()`` call."""
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
    row = span_table("fleet.launch").get("fleet.launch")
    return row["median_s"] * 1e6 if row else None

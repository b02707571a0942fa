"""The median, over the run's polls (the warm mission's and the profiled
ones with the window's), of the program's ``ctl.emit`` span:
SignalWindowBuilder.emit_window making one window of signals."""
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
    row = span_table("ctl.emit").get("ctl.emit")
    return row["median_s"] * 1e3 if row else None

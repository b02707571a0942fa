"""The seconds of every eager first window of a new shape key (the
program's ``fleet.first`` spans, summed over the run): the warm-up a
graph's capture needs, all in set-up."""
UNIT = "s"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "program cache and capture"
MOVES = "setup_s"


def read(obs: dict):
    if not obs.get("driver"):
        return None
    try:
        from repro_torch.obs.prof import span_table
    except ImportError:          # a program without the span table
        return None
    row = span_table("fleet.first").get("fleet.first")
    return row["total_s"] if row else None

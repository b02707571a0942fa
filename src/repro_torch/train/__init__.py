"""Training-side utilities of the port (so far the checkpoint format)."""

"""Training: the checkpoint format, AdamW and the train loop."""

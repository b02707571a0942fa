"""The training data pipeline of the port."""

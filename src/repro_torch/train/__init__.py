"""The training loop."""

"""The four examples of the JAX package's ``examples/``, on the port's API:
``python -m repro_torch.examples.<name> [--device cpu] [--steps N]``."""

"""PyTorch and CUDA port of the ElasticZO serving stack for one NVIDIA H100.

The JAX package ``repro`` is the reference; this package imports nothing
of it. Entry points run on the card unless the caller passes
``device="cpu"``, where every kernel takes its plain PyTorch version.
"""

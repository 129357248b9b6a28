"""PyTorch and CUDA port of the ElasticZO serving stack for one NVIDIA H100.

The JAX package ``repro`` is the reference; this package imports nothing
of it. Entry points run on the card unless the caller passes
``device="cpu"``, where every kernel takes its plain PyTorch version.
"""
import os

# core/api.py::deterministic runs the harness, the fleet's fp32 probes and
# the chip checks with deterministic algorithms, whose cuBLAS products need
# a fixed workspace configuration; cuBLAS reads it once, at the process's
# first product, so it is set when the package is imported (a value the
# caller set is kept)
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

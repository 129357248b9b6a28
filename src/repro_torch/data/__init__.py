"""Deterministic synthetic datasets (pure numpy)."""

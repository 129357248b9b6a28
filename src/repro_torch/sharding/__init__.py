"""Sharding over a mesh of ranks: the rules (``rules.py``), per-leaf
specs and shard descriptors (``params.py``) and the collectives of a
sharded step (``collectives.py``)."""

"""Config registry: ``get_arch(name)`` over the architectures in ``archs``,
``get_shape(name)`` over the production shapes, and the dry run's cell
matrix (``repro/configs/__init__.py``)."""
from .base import (ATTN, MAMBA, RWKV, LaneConfig, ModelConfig, ShapeConfig,
                   SHAPES, TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K,
                   pad_to, reduced)
from .archs import ARCHS
from .fleet import ByzantineSpec, FleetConfig, GossipConfig, RobustConfig
from .serve import ServeConfig


def get_arch(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]


def get_shape(name: str) -> ShapeConfig:
    if name not in SHAPES:
        raise KeyError(f"unknown shape {name!r}; available: {sorted(SHAPES)}")
    return SHAPES[name]


def cell_matrix():
    """All (arch, shape) dry-run cells with skip annotations.

    Returns a list of (arch_name, shape_name, run: bool, reason: str).
    """
    cells = []
    for a in ARCHS.values():
        for s in SHAPES.values():
            if s.long_context and not a.subquadratic:
                cells.append((a.name, s.name, False,
                              "pure full-attention arch; 500k dense KV cache "
                              "excluded per assignment (docs/design.md §6)"))
            else:
                cells.append((a.name, s.name, True, ""))
    return cells

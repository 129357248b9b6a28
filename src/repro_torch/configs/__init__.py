"""Config registry: ``get_arch(name)`` over the architectures in ``archs``."""
from .base import (ATTN, MAMBA, RWKV, LaneConfig, ModelConfig, ShapeConfig,
                   pad_to, reduced)
from .archs import ARCHS
from .fleet import ByzantineSpec, FleetConfig, GossipConfig, RobustConfig
from .serve import ServeConfig


def get_arch(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]

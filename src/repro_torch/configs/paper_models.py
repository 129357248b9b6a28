"""The paper's LeNet-5 configuration.

A copy of ``LeNet5Config`` from ``repro/configs/paper_models.py`` (the
port imports nothing of the JAX package). PointNet waits for a later
slice.
"""
from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class LeNet5Config:
    name: str = "lenet5"
    in_shape: Tuple[int, int, int] = (28, 28, 1)
    conv_channels: Tuple[int, int] = (6, 16)
    kernel: int = 5
    fc_dims: Tuple[int, int, int] = (120, 84, 10)   # fc1, fc2, classifier
    num_classes: int = 10
    # layer list used for the partition point C (paper Fig. 1 top):
    #   conv1, conv2, fc1, fc2, fc3   (5 trainable layers)
    num_trainable_layers: int = 5


LENET5 = LeNet5Config()

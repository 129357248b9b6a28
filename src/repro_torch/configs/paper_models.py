"""The paper's own models: LeNet-5 (MNIST-like) and PointNet (point clouds).

A copy of ``repro/configs/paper_models.py`` (the port imports nothing of
the JAX package): the faithful-reproduction targets of Tables 1-2 and
Figs. 2-7, defined apart from the LM ``ModelConfig`` since they are small
networks.
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


@dataclass(frozen=True)
class PointNetConfig:
    name: str = "pointnet"
    num_points: int = 1024
    # feature extraction: 5 pointwise FC layers (64,64,64,128,1024) + maxpool,
    # classification head: 3 FC (512, 256, num_classes)   (paper Fig. 1 bottom)
    feat_dims: Tuple[int, ...] = (64, 64, 64, 128, 1024)
    head_dims: Tuple[int, ...] = (512, 256)
    num_classes: int = 40
    num_trainable_layers: int = 8


LENET5 = LeNet5Config()
POINTNET = PointNetConfig()
# Smaller synthetic-data variant (8-class parametric shapes) used by tests.
POINTNET_SYN = PointNetConfig(num_classes=8, num_points=256)

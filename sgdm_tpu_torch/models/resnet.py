"""ResNet-50 / ResNet-101 trunks: the SimCLR, VISSL and supervised backbones.

The port's copy of `sgdm_tpu/models/resnet.py`, as NCHW modules under
torchvision's parameter names (``conv1``, ``bn1``, ``layer{s}.{i}.conv1`` …
``layer{s}.{i}.downsample.{0,1}``), so the trunk of a torchvision or
pl_bolts SimCLR state dict loads with ``load_state_dict(strict=True)``:

  * 7×7/2 conv → BN → ReLU → 3×3/2 max pool → bottleneck stages ([3, 4, 6, 3]
    for ResNet-50, [3, 4, 23, 3] for ResNet-101) → global average pool →
    [B, 2048];
  * BatchNorm is inference only (`FrozenBN`: running statistics, eps 1e-5,
    in train mode too); the JAX package folds it into a scale and a bias at
    load, which gives the same values up to rounding.

`load_simclr_torch_weights` reads a pl_bolts SimCLR checkpoint
(``state_dict['encoder.*']``) or a bare torchvision state dict,
`load_vissl_torch_weights` a VISSL one (``classy_state_dict … trunk.
_feature_blocks.*``, or SwAV's flat ``module.*`` with its projection head
and prototypes): each returns the trunk's entries under the port's names;
everything else (``fc``, heads) is dropped, as the JAX loaders drop it.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["FrozenBN", "Bottleneck", "ResNet50", "resnet101", "load_simclr_torch_weights",
           "load_vissl_torch_weights", "trunk_state"]


class FrozenBN(nn.BatchNorm2d):
    """Inference BatchNorm: the running statistics in any mode."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                            False, 0.0, self.eps)


def _conv_bn(cin: int, cout: int, kernel: int = 1, stride: int = 1, padding: int = 0):
    return nn.Conv2d(cin, cout, kernel, stride, padding, bias=False), FrozenBN(cout)


class Bottleneck(nn.Module):
    def __init__(self, cin: int, planes: int, stride: int = 1, downsample: bool = False):
        super().__init__()
        self.conv1, self.bn1 = _conv_bn(cin, planes)
        self.conv2, self.bn2 = _conv_bn(planes, planes, 3, stride, 1)
        self.conv3, self.bn3 = _conv_bn(planes, planes * 4)
        self.downsample = (nn.Sequential(*_conv_bn(cin, planes * 4, 1, stride))
                           if downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        skip = self.downsample(x) if self.downsample is not None else x
        return F.relu(out + skip)


class ResNet50(nn.Module):
    """x [B, 3, H, W] (ImageNet-normalised) → pooled features [B, 2048];
    bottleneck-generic in ``stage_sizes``, as the JAX class."""

    feat_dim = 2048

    def __init__(self, stage_sizes: Sequence[int] = (3, 4, 6, 3)):
        super().__init__()
        self.stage_sizes = tuple(stage_sizes)
        self.conv1, self.bn1 = _conv_bn(3, 64, 7, 2, 3)
        cin, planes = 64, 64
        for stage, blocks in enumerate(self.stage_sizes):
            layers = []
            for i in range(blocks):
                stride = 2 if (stage > 0 and i == 0) else 1
                layers.append(Bottleneck(cin, planes, stride, downsample=(i == 0)))
                cin = planes * 4
            setattr(self, f"layer{stage + 1}", nn.Sequential(*layers))
            planes *= 2

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        for stage in range(len(self.stage_sizes)):
            x = getattr(self, f"layer{stage + 1}")(x)
        return x.mean(dim=(2, 3))


def resnet101() -> ResNet50:
    """The torchvision ResNet-101 trunk (VISSL's SimCLR RN101)."""
    return ResNet50(stage_sizes=(3, 4, 23, 3))


def trunk_state(sd) -> dict[str, torch.Tensor]:
    """The entries of a torchvision-named state dict that the trunk has
    (``conv1``, ``bn1``, ``layer*``), as float tensors."""
    return {k: v for k, v in sd.items() if k.split(".")[0] in ("conv1", "bn1")
            or k.startswith("layer")}


def load_simclr_torch_weights(path: str) -> dict[str, torch.Tensor]:
    """A pl_bolts SimCLR checkpoint (or a torchvision state dict) → the
    trunk's state dict: the ``encoder.`` prefix stripped, heads dropped."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt.get("state_dict", ckpt)
    sd = {k[len("encoder."):]: v for k, v in sd.items() if k.startswith("encoder.")} or sd
    return trunk_state(sd)


def load_vissl_torch_weights(path: str) -> dict[str, torch.Tensor]:
    """A VISSL / SwAV ResNet checkpoint → the trunk's state dict: the
    consolidated layout (``classy_state_dict.base_model.model.trunk.
    _feature_blocks.*``) or the SwAV one (flat ``module.*``, its projection
    head and prototypes dropped), as the JAX loader reads them."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt
    if isinstance(ckpt, dict) and "classy_state_dict" in ckpt:
        sd = ckpt["classy_state_dict"]["base_model"]["model"]["trunk"]
    elif isinstance(ckpt, dict) and "state_dict" in ckpt:
        sd = ckpt["state_dict"]
    flat = {}
    for k, v in sd.items():
        for pre in ("module.", "_feature_blocks."):
            if k.startswith(pre):
                k = k[len(pre):]
        flat[k] = v
    return trunk_state(flat)

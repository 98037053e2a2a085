"""InceptionV3 (FID variant) as a PyTorch module: the eval feature extractor.

The port's counterpart of `sgdm_tpu/eval/inception.py`: the
`pt_inception-2015-12-05` network that clean-fid, pytorch-fid and
torch-fidelity wrap, NCHW, inference only, BatchNorm folded at load time.

  * the FID-specific differences from torchvision's InceptionV3 are kept:
    1008-way logits, every A, C and E-1 branch pool an average that divides
    by the real elements of the window (``count_include_pad=False``), and
    the *max*-pooled branch pool of the second E block (Mixed_7c);
  * outputs ``pool3`` [B, 2048] (FID, PRDC), ``logits`` [B, 1008] (IS) and
    ``spatial`` [B, 2023]: the first 7 channels of the 17×17 Mixed_6e map
    for sFID, flattened in the JAX package's NHWC order;
  * the modules carry the flax names, so a parameter maps mechanically:
    ``Mixed_6e/branch7x7_2/conv/kernel`` is ``Mixed_6e.branch7x7_2.conv.weight``
    (`models.convert.inception_from_flax`) and ``…/bn_scale`` is
    ``….bn_scale``.

Weights: `load_torch_weights` folds a ``pt_inception`` state dict.  Without
one, `random_params(seed)` builds the port's own deterministic random
network with flax's default initialisers from a `torch.Generator`.  JAX's
draws cannot be made without JAX, so the random networks of the two
packages differ, and so do their random-weight FIDs: neither is comparable
to the other or to a published FID.
"""

from __future__ import annotations

import math
from pathlib import Path

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

__all__ = ["FIDInceptionV3", "load_torch_weights", "random_params", "build_inception"]

_BN_EPS = 1e-3


class ConvBN(nn.Module):
    """Conv (no bias) → × ``bn_scale`` + ``bn_bias`` (the folded BatchNorm) → ReLU."""

    def __init__(self, cin: int, cout: int, kernel, stride=1, padding=0):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride=stride, padding=padding, bias=False)
        self.bn_scale = nn.Parameter(torch.ones(cout))
        self.bn_bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        return F.relu(x * self.bn_scale[:, None, None] + self.bn_bias[:, None, None])


def _avg_pool(x: torch.Tensor) -> torch.Tensor:
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=False)


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int):
        super().__init__()
        self.branch1x1 = ConvBN(cin, 64, 1)
        self.branch5x5_1 = ConvBN(cin, 48, 1)
        self.branch5x5_2 = ConvBN(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = ConvBN(cin, 64, 1)
        self.branch3x3dbl_2 = ConvBN(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = ConvBN(96, 96, 3, padding=1)
        self.branch_pool = ConvBN(cin, pool_features, 1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(_avg_pool(x))
        return torch.cat([b1, b5, b3, bp], 1)


class InceptionB(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3 = ConvBN(cin, 384, 3, stride=2)
        self.branch3x3dbl_1 = ConvBN(cin, 64, 1)
        self.branch3x3dbl_2 = ConvBN(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = ConvBN(96, 96, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3(x)
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([b3, bd, F.max_pool2d(x, 3, stride=2)], 1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, c7: int):
        super().__init__()
        self.branch1x1 = ConvBN(cin, 192, 1)
        self.branch7x7_1 = ConvBN(cin, c7, 1)
        self.branch7x7_2 = ConvBN(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = ConvBN(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = ConvBN(cin, c7, 1)
        self.branch7x7dbl_2 = ConvBN(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = ConvBN(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = ConvBN(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = ConvBN(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = ConvBN(cin, 192, 1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_1(x)
        for m in (self.branch7x7dbl_2, self.branch7x7dbl_3, self.branch7x7dbl_4,
                  self.branch7x7dbl_5):
            bd = m(bd)
        bp = self.branch_pool(_avg_pool(x))
        return torch.cat([b1, b7, bd, bp], 1)


class InceptionD(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3_1 = ConvBN(cin, 192, 1)
        self.branch3x3_2 = ConvBN(192, 320, 3, stride=2)
        self.branch7x7x3_1 = ConvBN(cin, 192, 1)
        self.branch7x7x3_2 = ConvBN(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = ConvBN(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = ConvBN(192, 192, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = self.branch7x7x3_4(self.branch7x7x3_3(self.branch7x7x3_2(self.branch7x7x3_1(x))))
        return torch.cat([b3, b7, F.max_pool2d(x, 3, stride=2)], 1)


class InceptionE(nn.Module):
    def __init__(self, cin: int, use_max_pool: bool = False):
        super().__init__()
        self.use_max_pool = use_max_pool  # the FID variant's second E block max-pools
        self.branch1x1 = ConvBN(cin, 320, 1)
        self.branch3x3_1 = ConvBN(cin, 384, 1)
        self.branch3x3_2a = ConvBN(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = ConvBN(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = ConvBN(cin, 448, 1)
        self.branch3x3dbl_2 = ConvBN(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = ConvBN(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = ConvBN(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = ConvBN(cin, 192, 1)

    def forward(self, x):
        b1 = self.branch1x1(x)
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], 1)
        if self.use_max_pool:
            bp = F.max_pool2d(x, 3, stride=1, padding=1)
        else:
            bp = _avg_pool(x)
        return torch.cat([b1, b3, bd, self.branch_pool(bp)], 1)


class FIDInceptionV3(nn.Module):
    """``forward(x)`` → dict(pool3 [B, 2048], logits [B, 1008], spatial [B, 2023]).

    Input: [B, 3, 299, 299] float32 in [-1, 1]."""

    def __init__(self):
        super().__init__()
        self.Conv2d_1a_3x3 = ConvBN(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = ConvBN(32, 32, 3)
        self.Conv2d_2b_3x3 = ConvBN(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = ConvBN(64, 80, 1)
        self.Conv2d_4a_3x3 = ConvBN(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280)
        self.Mixed_7c = InceptionE(2048, use_max_pool=True)
        self.fc = nn.Linear(2048, 1008)

    def forward(self, x: torch.Tensor) -> dict[str, torch.Tensor]:
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = F.max_pool2d(x, 3, stride=2)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = F.max_pool2d(x, 3, stride=2)
        for m in (self.Mixed_5b, self.Mixed_5c, self.Mixed_5d, self.Mixed_6a, self.Mixed_6b,
                  self.Mixed_6c, self.Mixed_6d, self.Mixed_6e):
            x = m(x)
        # sFID: the first 7 channels of the 17×17 map, flattened as NHWC (the
        # JAX package's order; the Fréchet distance does not depend on it)
        spatial = x[:, :7].permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        x = self.Mixed_7c(self.Mixed_7b(self.Mixed_7a(x)))
        pool3 = x.mean(dim=(2, 3))
        return {"pool3": pool3, "logits": self.fc(pool3), "spatial": spatial}


# ----------------------------------------------------------------------
# weights
# ----------------------------------------------------------------------

def load_torch_weights(path: str | Path) -> dict[str, torch.Tensor]:
    """A ``pt_inception-2015-12-05-*.pth`` state dict → the state dict of
    `FIDInceptionV3`, BatchNorm (eps 1e-3) folded into ``bn_scale`` /
    ``bn_bias`` in float32 numpy as `sgdm_tpu/eval/inception.py` folds it;
    the training-time auxiliary head (``AuxLogits.*``) is skipped."""
    sd = torch.load(str(path), map_location="cpu", weights_only=False)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    out: dict[str, torch.Tensor] = {}
    prefixes = sorted({k.rsplit(".", 2)[0] for k in sd
                       if ".conv.weight" in k and not k.startswith("AuxLogits.")})
    for prefix in prefixes:
        gamma = sd[f"{prefix}.bn.weight"].numpy()
        beta = sd[f"{prefix}.bn.bias"].numpy()
        mean = sd[f"{prefix}.bn.running_mean"].numpy()
        var = sd[f"{prefix}.bn.running_var"].numpy()
        scale = gamma / np.sqrt(var + _BN_EPS)
        out[f"{prefix}.conv.weight"] = sd[f"{prefix}.conv.weight"].detach().float().clone()
        out[f"{prefix}.bn_scale"] = torch.from_numpy(np.ascontiguousarray(scale))
        out[f"{prefix}.bn_bias"] = torch.from_numpy(np.ascontiguousarray(beta - mean * scale))
    out["fc.weight"] = sd["fc.weight"].detach().float().clone()
    out["fc.bias"] = sd["fc.bias"].detach().float().clone()
    return out


# flax's variance_scaling truncated normal: the std of N(0, 1) cut at ±2
_TRUNC_STD = 0.87962566103423978


def random_params(seed: int = 0) -> dict[str, torch.Tensor]:
    """The port's deterministic random network (no weights file): flax's
    default initialisers drawn from a CPU `torch.Generator` seeded with
    ``seed`` — conv and ``fc`` kernels ``lecun_normal`` (a normal truncated
    at ±2 standard deviations, std √(1/fan_in) / 0.8796), ``fc`` bias 0,
    ``bn_scale`` 1, ``bn_bias`` 0.  Not JAX's draws (module docstring)."""
    gen = torch.Generator().manual_seed(seed)
    out: dict[str, torch.Tensor] = {}
    with torch.device("meta"):
        shapes = {k: tuple(p.shape) for k, p in FIDInceptionV3().state_dict().items()}
    for key, shape in shapes.items():
        if key.endswith("bn_scale"):
            out[key] = torch.ones(shape)
        elif key.endswith("bn_bias") or key == "fc.bias":
            out[key] = torch.zeros(shape)
        else:
            std = math.sqrt(1.0 / math.prod(shape[1:])) / _TRUNC_STD
            out[key] = nn.init.trunc_normal_(torch.empty(shape), 0.0, std, -2 * std, 2 * std,
                                             generator=gen)
    return out


def build_inception(state_dict: dict[str, torch.Tensor],
                    device: str | torch.device = "cpu") -> FIDInceptionV3:
    """`FIDInceptionV3` holding ``state_dict`` (every key, no other) on
    ``device``, in eval mode without gradients; the module is built on the
    meta device, so no initialiser runs."""
    with torch.device("meta"):
        model = FIDInceptionV3()
    model.load_state_dict({k: v.to(device=device, dtype=torch.float32)
                           for k, v in state_dict.items()}, assign=True)
    return model.eval().requires_grad_(False)

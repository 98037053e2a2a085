"""SSL backbones with one interface: the feature extractor's encoder.

The port's copy of `sgdm_tpu/selfsup/ssl_backbone.py` for the ViT family
(DINO ViT-S/B at patch 16 or 8, and the MAE / MSN ViTs through the same
network): ``feat_dim``, `transform_batch` (to float in [0, 1], JAX's
antialiased bilinear resize to ``image_size`` when the height differs, the
ImageNet normalisation) and the encoders (`batch_encode_feat`: the CLS
token; `batch_encode_tokens`: CLS + the patch grid resampled to S×S;
`batch_encode_cls_attention`: the last block's CLS → patch attention).

Everything runs on ``device`` in float32 with TF32 off (the JAX package's
precision here; ``SGDM_FEAT_DTYPE=bfloat16`` puts the ViT's linear layers
in bfloat16); features come back float32.  Checkpoints are torch.hub
DINO state dicts found by name under ``SGDM_SSL_CKPT_DIR`` or torch hub's
checkpoint directory, or given as ``ckpt_path``.  Without one the
backbone is the port's own seeded random ViT (not the JAX package's
draws), loudly flagged as not pretrained.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np
import torch

from ..device import no_tf32, resolve_device
from ..models.convert import load_dino_torch_weights
from ..models.vit import VisionTransformer, vit_base, vit_small
from ..utils.logging import logger
from ..utils.resize import resize

__all__ = ["get_ssl_backbone", "SSLBackbone", "IMAGENET_MEAN", "IMAGENET_STD",
           "tencrop_batch", "random_vit_state", "HostCopy"]

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)

_CKPT_NAMES = {
    "dino_vits16": "dino_deitsmall16_pretrain.pth",
    "dino_vits8": "dino_deitsmall8_pretrain.pth",
    "dino_vitb16": "dino_vitbase16_pretrain.pth",
    "dino_vitb8": "dino_vitbase8_pretrain.pth",
}

_VITS = {
    "dino_vits16": (vit_small, 16), "dino_vits8": (vit_small, 8),
    "dino_vitb16": (vit_base, 16), "dino_vitb8": (vit_base, 8),
    "mae_vitb16": (vit_base, 16), "msn_vits16": (vit_small, 16), "msn_vitb16": (vit_base, 16),
}
# the JAX table's other names, and what brings them
_NOT_PORTED = {
    "dino_xcit_m24_p8": "the XCiT backbone", "vissl_simclr": "the VISSL ResNet backbones",
    "vissl_deepclusterv2": "the VISSL ResNet backbones",
    "vissl_jigsaw": "the VISSL ResNet backbones", "simclr_rn50": "the ResNet-50 backbones",
    "rn50": "the ResNet-50 backbones",
}


class SSLBackbone:
    """feat_dim / transform_batch / batch_encode_* on ``device``."""

    def __init__(self, name: str, model: VisionTransformer, image_size: int = 224,
                 device: str | torch.device = "cuda"):
        self.name = name
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.image_size = image_size
        self.feat_dim = model.embed_dim
        self._mean = torch.as_tensor(IMAGENET_MEAN, device=self.device)
        self._std = torch.as_tensor(IMAGENET_STD, device=self.device)

    def transform_batch(self, imgs_uint8) -> torch.Tensor:
        """uint8 [B, H, W, 3] (numpy or tensor) → float32 [B, 3, S, S] on the
        device: /255, resized to ``image_size`` (when H differs), normalised."""
        x = torch.as_tensor(imgs_uint8)
        if self.device.type == "cuda" and x.device.type == "cpu":
            # staged through pinned memory: the copy does not wait for the card
            x = x.pin_memory()
        x = x.to(self.device, non_blocking=True).float() / 255.0
        size = self.image_size
        if x.shape[1] != size:
            x = resize(x, (x.shape[0], size, size, x.shape[3]), method="bilinear")
        return ((x - self._mean) / self._std).permute(0, 3, 1, 2)

    def encode(self, batch: torch.Tensor, out: str = "cls"):
        """The ViT's ``out`` on a transformed batch (float32, TF32 off)."""
        with torch.no_grad(), no_tf32():
            return self.model(batch, out=out)

    def batch_encode_feat(self, batch: torch.Tensor, *,
                          as_numpy: bool = True) -> np.ndarray | torch.Tensor:
        """CLS-token features [B, feat_dim] float32.  ``as_numpy=False``
        returns the device tensor without waiting for it, so the caller can
        overlap host work with the device's (`selfsup.feat_extractor`)."""
        out = self.encode(batch, "cls").float()
        return out.cpu().numpy() if as_numpy else out

    def batch_encode_tokens(self, batch: torch.Tensor, resampled_size: int = 14) -> np.ndarray:
        """Per-token features [B, 1 + S², feat_dim]: CLS + the patch grid
        resampled to S×S with JAX's linear (the 'withpatches' feat file)."""
        toks = self.encode(batch, "tokens").float()
        cls, patches = toks[:, :1], toks[:, 1:]
        b, n, d = patches.shape
        g = int(round(float(n) ** 0.5))
        s = resampled_size
        grid = patches.reshape(b, g, g, d)
        if g != s:
            grid = resize(grid, (b, s, s, d), method="linear")
        return torch.cat([cls, grid.reshape(b, s * s, d)], dim=1).cpu().numpy()

    def batch_encode_cls_attention(self, batch: torch.Tensor) -> np.ndarray:
        """Last-block CLS → patch attention [B, heads, n_patches]."""
        attn = self.encode(batch, "attn_last").float()
        return attn[:, :, 0, 1:].cpu().numpy()


class HostCopy:
    """A device tensor on its way to the host: on the card, a copy into
    pinned memory queued behind the work that makes it, and an event;
    `numpy` waits for that event only.  A CPU tensor is its own copy."""

    def __init__(self, t: torch.Tensor):
        if t.device.type == "cuda":
            self._host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self._host.copy_(t, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host, self._event = t, None

    def numpy(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        return self._host.numpy()


def _find_ckpt(name: str, ckpt_path: str | None) -> str | None:
    if ckpt_path:
        if Path(ckpt_path).exists():
            return ckpt_path
        # an EXPLICIT path must not silently degrade to the seeded random backbone
        raise FileNotFoundError(f"ssl checkpoint for {name!r} not found: {ckpt_path}")
    fname = _CKPT_NAMES.get(name)
    for root in [os.environ.get("SGDM_SSL_CKPT_DIR"),
                 os.path.expanduser("~/.cache/torch/hub/checkpoints")]:
        if root and fname and (Path(root) / fname).exists():
            return str(Path(root) / fname)
    return None


def random_vit_state(model: VisionTransformer, seed: int = 0) -> dict[str, torch.Tensor]:
    """A seeded random state dict of ``model``'s shapes, as flax initialises
    the JAX package's ViT: kernels N(0, 1/fan_in), biases and the CLS token
    zero, LayerNorms one / zero, the position embedding N(0, 0.02²)."""
    gen = torch.Generator().manual_seed(seed)
    state = {}
    for key, p in model.state_dict().items():
        if key == "pos_embed":
            v = 0.02 * torch.randn(p.shape, generator=gen)
        elif key.endswith("bias") or key == "cls_token":
            v = torch.zeros(p.shape)
        elif p.ndim == 1:                                   # LayerNorm scales
            v = torch.ones(p.shape)
        else:
            v = torch.randn(p.shape, generator=gen) / float(np.sqrt(np.prod(p.shape[1:])))
        state[key] = v
    return state


def get_ssl_backbone(name: str = "dino_vitb16", image_size: int = 224,
                     ckpt_path: str | None = None, seed: int = 0,
                     compute_dtype: str | None = None,
                     device: str | torch.device = "cuda") -> SSLBackbone:
    """The ViT names of the JAX package's table; ``compute_dtype`` (env
    ``SGDM_FEAT_DTYPE``) float32 by default.  The ResNet, XCiT, VISSL,
    ``timm_*`` names and ``.msgpack`` encoders raise `NotImplementedError`
    naming their ROADMAP item."""
    device = resolve_device(device)
    compute_dtype = compute_dtype or os.environ.get("SGDM_FEAT_DTYPE") or "float32"
    vit_dtype = torch.bfloat16 if str(compute_dtype) in ("bf16", "bfloat16") else torch.float32
    if ckpt_path and str(ckpt_path).endswith(".msgpack"):
        raise NotImplementedError("native .msgpack encoders come with the MSN / MAE slice "
                                  "(ROADMAP §1 item 8)")
    if name.startswith("timm_") or name in _NOT_PORTED:
        what = "the timm backbones" if name.startswith("timm_") else _NOT_PORTED[name]
        raise NotImplementedError(f"ssl backbone {name!r}: {what} are not ported yet "
                                  "(ROADMAP §1 item 8)")
    if name not in _VITS:
        raise ValueError(f"unknown ssl backbone {name}; have {list(_VITS) + list(_NOT_PORTED)}")
    build, patch = _VITS[name]
    model = build(patch, dtype=vit_dtype)
    path = _find_ckpt(name, ckpt_path)
    if path:
        logger.info(f"loading {name} weights from {path}")
        model.load_state_dict(load_dino_torch_weights(path), strict=True)
        if name.startswith("dino_"):
            # first-use golden check (utils.weight_verify: the sidecar when present)
            from ..utils.weight_verify import verify_dino_load

            verify_dino_load(path, model)
    else:
        logger.warning(
            f"No checkpoint for {name} (set SGDM_SSL_CKPT_DIR). Using the port's "
            f"DETERMINISTIC RANDOM backbone: features are self-consistent but not pretrained.")
        model.load_state_dict(random_vit_state(model, seed))
    return SSLBackbone(name, model, image_size=image_size, device=device)


def tencrop_batch(imgs_uint8: np.ndarray, crop_frac: float = 0.875) -> np.ndarray:
    """Classic TenCrop: 4 corners + center, each plus its horizontal flip.

    uint8 [B, H, W, 3] → uint8 [B, 10, ch, cw, 3] (torchvision TenCrop
    semantics; the tencrop feature-extractor variant)."""
    b, h, w, _ = imgs_uint8.shape
    ch, cw = int(h * crop_frac), int(w * crop_frac)
    tops = [0, 0, h - ch, h - ch, (h - ch) // 2]
    lefts = [0, w - cw, 0, w - cw, (w - cw) // 2]
    crops = []
    for t, l in zip(tops, lefts):
        c = imgs_uint8[:, t:t + ch, l:l + cw]
        crops.append(c)
        crops.append(c[:, :, ::-1])
    return np.stack(crops, axis=1)

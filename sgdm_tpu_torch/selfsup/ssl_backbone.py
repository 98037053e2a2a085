"""SSL backbones with one interface: the feature extractor's encoder.

The port's copy of `sgdm_tpu/selfsup/ssl_backbone.py`: every name of its
builder table (DINO ViT-S/B at patch 16 or 8 and the MAE / MSN ViTs on the
same network; ``dino_xcit_m24_p8``, `models/xcit.py`; the ResNet trunks of
`models/resnet.py`: ``rn50`` and ``simclr_rn50`` (ResNet-50),
``vissl_deepclusterv2`` and ``vissl_jigsaw`` (ResNet-50), ``vissl_simclr``
(ResNet-101)) and the ``timm_*`` adapter: ``feat_dim``, `transform_batch`
(to float in [0, 1], JAX's antialiased bilinear resize to ``image_size``
when the height differs, the ImageNet normalisation) and the encoders
(`batch_encode_feat`: the CLS token, or the pooled ResNet feature;
`batch_encode_tokens`: CLS + the patch grid resampled to S×S;
`batch_encode_cls_attention`: the last block's CLS → patch attention; the
last two raise `TypeError` for a ResNet, as the JAX package's do).

Everything runs on ``device`` in float32 with TF32 off (the JAX package's
precision here; ``SGDM_FEAT_DTYPE=bfloat16`` puts the ViT's and XCiT's
linear layers in bfloat16); features come back float32.  Checkpoints are
found by name under ``SGDM_SSL_CKPT_DIR`` or torch hub's checkpoint
directory, or given as ``ckpt_path``, and read by the loader of their
family (`models.convert.load_dino_torch_weights`,
`models.xcit.load_xcit_torch_weights`, `models.resnet.
load_simclr_torch_weights` for ``rn50`` / ``simclr_rn50``,
`load_vissl_torch_weights` for ``vissl_*``), then loaded strictly.  Without
one the backbone is the port's own seeded random network (not the JAX
package's draws), loudly flagged as not pretrained.  A ``.msgpack``
``ckpt_path`` is an encoder the SSL pre-trainers exported (either package's
`save_encoder_ckpt`): its architecture comes from the ``.json`` beside it.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np
import torch

from ..device import no_tf32, resolve_device
from ..models.convert import load_dino_torch_weights
from ..models.resnet import ResNet50, load_simclr_torch_weights, load_vissl_torch_weights, resnet101
from ..models.vit import VisionTransformer, vit_base, vit_small
from ..models.xcit import load_xcit_torch_weights, xcit_medium_24_p8
from ..utils.logging import logger
from ..utils.resize import resize

__all__ = ["get_ssl_backbone", "SSLBackbone", "IMAGENET_MEAN", "IMAGENET_STD",
           "tencrop_batch", "random_vit_state", "random_state", "HostCopy"]

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)

_CKPT_NAMES = {
    "dino_vits16": "dino_deitsmall16_pretrain.pth",
    "dino_vits8": "dino_deitsmall8_pretrain.pth",
    "dino_vitb16": "dino_vitbase16_pretrain.pth",
    "dino_vitb8": "dino_vitbase8_pretrain.pth",
    "dino_xcit_m24_p8": "dino_xcit_medium_24_p8_pretrain.pth",
    # the three VISSL zoo checkpoints
    "vissl_simclr": "model_final_checkpoint_phase999.torch",
    "vissl_deepclusterv2": "deepclusterv2_800ep_pretrain.pth.tar",
    "vissl_jigsaw": "converted_vissl_rn50_jigsaw_in1k_goyal19.torch",
    "simclr_rn50": "simclr_imagenet.ckpt",
    "rn50": "resnet50-0676ba61.pth",  # torchvision IMAGENET1K_V1
}

_VITS = {
    "dino_vits16": (vit_small, 16), "dino_vits8": (vit_small, 8),
    "dino_vitb16": (vit_base, 16), "dino_vitb8": (vit_base, 8),
    "mae_vitb16": (vit_base, 16), "msn_vits16": (vit_small, 16), "msn_vitb16": (vit_base, 16),
}
# name -> (builder, loader) of the non-ViT names
_OTHERS = {
    "vissl_simclr": (resnet101, load_vissl_torch_weights),
    "vissl_deepclusterv2": (ResNet50, load_vissl_torch_weights),
    "vissl_jigsaw": (ResNet50, load_vissl_torch_weights),
    "simclr_rn50": (ResNet50, load_simclr_torch_weights),
    "rn50": (ResNet50, load_simclr_torch_weights),
    "dino_xcit_m24_p8": (xcit_medium_24_p8, load_xcit_torch_weights),
}


class SSLBackbone:
    """feat_dim / transform_batch / batch_encode_* on ``device``."""

    def __init__(self, name: str, model: torch.nn.Module, image_size: int = 224,
                 device: str | torch.device = "cuda"):
        self.name = name
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.image_size = image_size
        self.feat_dim = model.feat_dim
        self._is_resnet = isinstance(model, ResNet50)
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
        """The network's ``out`` on a transformed batch (float32, TF32 off);
        a ResNet has only its pooled feature (``cls``)."""
        if self._is_resnet and out != "cls":
            raise TypeError(f"{self.name}: a ResNet backbone has no {out!r} output")
        with torch.no_grad(), no_tf32():
            return self.model(batch) if self._is_resnet else self.model(batch, out=out)

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


def _load_native_backbone(name: str, path: str, image_size: int,
                          device: torch.device) -> SSLBackbone:
    """An encoder the MSN / MAE trainers exported: flax msgpack weights in the
    JAX `VisionTransformer`'s layout and a ``.json`` meta of its architecture."""
    import json

    from .pretrain_common import load_encoder_ckpt

    meta = json.loads(Path(str(path) + ".json").read_text())
    model = VisionTransformer(patch_size=meta["patch_size"], embed_dim=meta["embed_dim"],
                              depth=meta["depth"], num_heads=meta["num_heads"],
                              pretrain_img_size=meta["pretrain_img_size"])
    model.load_state_dict(load_encoder_ckpt(path, model), strict=True)
    logger.info(f"loaded native {meta.get('method', '?')} encoder from {path}")
    return SSLBackbone(name, model, image_size=image_size, device=device)


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


def random_state(model: torch.nn.Module, seed: int = 0) -> dict[str, torch.Tensor]:
    """A seeded random state dict of ``model``'s shapes: `random_vit_state`
    for a ViT; else kernels N(0, 1/fan_in), biases zero, an XCiT's CLS token
    N(0, 0.02²), and every other entry (BatchNorm statistics and affine,
    LayerNorms, the XCiT's η scales and temperatures) at the module's
    initial value, as flax initialises the JAX package's."""
    if isinstance(model, VisionTransformer):
        return random_vit_state(model, seed)
    gen = torch.Generator().manual_seed(seed)
    state = {}
    for key, p in model.state_dict().items():
        if key == "cls_token":
            v = 0.02 * torch.randn(p.shape, generator=gen)
        elif key.endswith("bias"):
            v = torch.zeros(p.shape)
        elif p.ndim >= 2:
            v = torch.randn(p.shape, generator=gen) / float(np.sqrt(np.prod(p.shape[1:])))
        else:
            v = p.detach().clone()
        state[key] = v
    return state


class _TimmBackbone:
    """The ``timm_{arch}`` adapter: ``forward_features``, globally average
    pooled for a conv net (the CLS token for a token sequence), with the
    backbone interface; torch interpolate (bilinear) to ``image_size``."""

    def __init__(self, arch: str, image_size: int = 224, device: str | torch.device = "cuda"):
        import timm

        pretrained = "random" not in arch
        self.device = resolve_device(device)
        self.model = timm.create_model(arch.replace("_random", ""),
                                       pretrained=pretrained).eval().to(self.device)
        self.image_size = image_size
        self.feat_dim = (getattr(self.model, "embed_dim", None)
                         or self.model.feature_info[-1]["num_chs"])

    def transform_batch(self, imgs_uint8) -> torch.Tensor:
        x = torch.as_tensor(np.asarray(imgs_uint8)).to(self.device).float().permute(0, 3, 1, 2)
        x = torch.nn.functional.interpolate(x / 255.0, size=(self.image_size, self.image_size),
                                            mode="bilinear", align_corners=False)
        mean = torch.as_tensor(IMAGENET_MEAN, device=self.device).view(1, 3, 1, 1)
        std = torch.as_tensor(IMAGENET_STD, device=self.device).view(1, 3, 1, 1)
        return (x - mean) / std

    def batch_encode_feat(self, batch: torch.Tensor) -> np.ndarray:
        with torch.no_grad():
            feat = self.model.forward_features(batch)
            if feat.dim() == 4:            # a conv feature map → global average pool
                feat = feat.mean(dim=[2, 3])
            elif feat.dim() == 3:          # a token sequence → CLS
                feat = feat[:, 0]
        return feat.float().cpu().numpy()


def _timm_backbone(name: str, image_size: int, device) -> _TimmBackbone:
    try:
        import timm  # noqa: F401
    except ImportError as e:
        raise ImportError(
            f"ssl backbone '{name}' needs the `timm` package, which is not installed. "
            "Install timm, or use a native backbone (dino_*/mae_*/msn_*/simclr_rn50/rn50/"
            "vissl_*/dino_xcit_m24_p8).") from e
    return _TimmBackbone(name.replace("timm_", "", 1), image_size=image_size, device=device)


def get_ssl_backbone(name: str = "dino_vitb16", image_size: int = 224,
                     ckpt_path: str | None = None, seed: int = 0,
                     compute_dtype: str | None = None,
                     device: str | torch.device = "cuda") -> SSLBackbone:
    """Every name of the JAX package's table; ``compute_dtype`` (env
    ``SGDM_FEAT_DTYPE``) float32 by default, bfloat16 for the ViT and XCiT
    linear layers.  A ``.msgpack`` ``ckpt_path`` loads a natively pre-trained
    encoder (float32, whatever the name); an unknown name raises `ValueError`."""
    device = resolve_device(device)
    compute_dtype = compute_dtype or os.environ.get("SGDM_FEAT_DTYPE") or "float32"
    vit_dtype = torch.bfloat16 if str(compute_dtype) in ("bf16", "bfloat16") else torch.float32
    if ckpt_path and str(ckpt_path).endswith(".msgpack"):
        return _load_native_backbone(name, _find_ckpt(name, ckpt_path), image_size, device)
    if name.startswith("timm_"):
        return _timm_backbone(name, image_size, device)
    if name in _VITS:
        build, patch = _VITS[name]
        model, loader = build(patch, dtype=vit_dtype), load_dino_torch_weights
    elif name in _OTHERS:
        build, loader = _OTHERS[name]
        model = build(dtype=vit_dtype) if name == "dino_xcit_m24_p8" else build()
    else:
        raise ValueError(f"unknown ssl backbone {name}; have {list(_VITS) + list(_OTHERS)}")
    path = _find_ckpt(name, ckpt_path)
    if path:
        logger.info(f"loading {name} weights from {path}")
        model.load_state_dict(loader(path), strict=True)
        if name.startswith("dino_") and name in _VITS:
            # first-use golden check (utils.weight_verify: the sidecar when present)
            from ..utils.weight_verify import verify_dino_load

            verify_dino_load(path, model)
    else:
        logger.warning(
            f"No checkpoint for {name} (set SGDM_SSL_CKPT_DIR). Using the port's "
            f"DETERMINISTIC RANDOM backbone: features are self-consistent but not pretrained.")
        model.load_state_dict(random_state(model, seed))
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

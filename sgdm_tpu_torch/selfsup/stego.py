"""STEGO segmentation inference: the ``stego_dir`` mask PNGs of COCO-Stuff64.

The port's copy of `sgdm_tpu/selfsup/stego.py`:

  * `DinoFeaturizer`: the frozen DINO ViT's patch tokens → a 1×1 linear
    head (``cluster1``) plus a nonlinear one (``cluster2``: 1×1, ReLU, 1×1)
    → a ``dim``-wide code a patch, channels last [B, h, w, dim], under the
    names of STEGO's ``LitUnsupervisedSegmenter.net`` (``model.*`` is the
    trunk, torch.hub DINO's names);
  * `cluster_probe_log_probs`: ``log_softmax(α · <norm(code), norm(centre)>)``
    with α = 2 at inference;
  * `StegoInference.predict_mask`, one image at a time as the JAX package:
    crop to a multiple of the patch, ImageNet normalisation, the code
    averaged with that of the flipped image, JAX's bilinear resize
    (`utils/resize.py`) to the crop, the log-probs, the dense CRF on the
    host (`native.dense_crf`), argmax, and the last row / column repeated
    back to the original size;
  * `generate_mask_dir` / `main`: images read by `utils/image.read_image`,
    8-bit grey ``<stem>.png`` masks written by `utils/png.write_png`.

A STEGO ``.ckpt`` (``state_dict``: ``net.model.*``, ``net.cluster1.0.*``,
``net.cluster2.{0,2}.*``, ``cluster_probe.clusters``) gives the head, the
centres and the trunk; without one the head and the centres are the port's
own seeded random ones (not the JAX package's draws), flagged, and the
trunk is read from ``dino_ckpt_path`` or seeded too.  The network runs on
``device`` in float32 with TF32 off; the CRF on the host.

    python -m sgdm_tpu_torch.selfsup.stego --image_dir IMGS --out_dir MASKS \\
        [--ckpt S.ckpt] [--dino_ckpt D.pth] [--n_classes 27] [--dim 70] \\
        [--arch vit_small] [--patch_size 8] [--no_crf] [--device cuda]
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import no_tf32, resolve_device
from ..models.convert import dino_state, load_dino_torch_weights
from ..models.vit import VisionTransformer, vit_base, vit_small
from ..native import dense_crf
from ..utils.image import read_image
from ..utils.logging import logger
from ..utils.png import write_png
from ..utils.resize import resize
from .ssl_backbone import IMAGENET_MEAN, IMAGENET_STD, random_state

__all__ = ["DinoFeaturizer", "cluster_probe_log_probs", "StegoInference", "main"]

IMAGE_SUFFIXES = (".jpg", ".jpeg", ".png")


def _pointwise(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """A 1×1 convolution on channels-last ``x``."""
    return F.linear(x, conv.weight[:, :, 0, 0], conv.bias)


class DinoFeaturizer(nn.Module):
    """DINO trunk + clusterer heads → per-patch code [B, h, w, dim]."""

    def __init__(self, dim: int = 70, backbone: VisionTransformer | None = None,
                 nonlinear: bool = True):
        super().__init__()
        self.model = backbone if backbone is not None else vit_small(8)
        n_feats = self.model.embed_dim
        self.dim, self.nonlinear = dim, nonlinear
        self.cluster1 = nn.Sequential(nn.Conv2d(n_feats, dim, 1))
        if nonlinear:
            self.cluster2 = nn.Sequential(nn.Conv2d(n_feats, n_feats, 1), nn.ReLU(),
                                          nn.Conv2d(n_feats, dim, 1))

    def features(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, 3, H, W] (ImageNet-normalised) → the trunk's patch tokens
        [B, H/p, W/p, C]."""
        p = self.model.patch_size
        b, _, hh, ww = x.shape
        tokens = self.model(x, out="tokens")
        return tokens[:, 1:].reshape(b, hh // p, ww // p, -1)

    def head(self, feat: torch.Tensor) -> torch.Tensor:
        code = _pointwise(self.cluster1[0], feat)
        if self.nonlinear:
            hidden = F.relu(_pointwise(self.cluster2[0], feat))
            code = code + _pointwise(self.cluster2[2], hidden)
        return code

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.head(self.features(x))


def cluster_probe_log_probs(code: torch.Tensor, clusters: torch.Tensor,
                            alpha: float = 2.0) -> torch.Tensor:
    """log_softmax(α · <norm(code), norm(cluster)>) over the clusters, [B, h, w, n]."""
    cn = clusters / torch.linalg.norm(clusters, dim=1, keepdim=True)
    fn = code / torch.linalg.norm(code, dim=-1, keepdim=True).clamp(min=1e-12)
    ip = torch.einsum("bhwc,nc->bhwn", fn, cn)
    return torch.log_softmax(alpha * ip, dim=-1)


def random_head_state(featurizer: DinoFeaturizer, seed: int) -> dict[str, torch.Tensor]:
    """The head's seeded random state: kernels N(0, 1/fan_in), biases zero."""
    head = {k: v for k, v in featurizer.state_dict().items() if not k.startswith("model.")}
    gen = torch.Generator().manual_seed(seed)
    return {k: (torch.zeros(v.shape) if k.endswith("bias")
                else torch.randn(v.shape, generator=gen) / float(np.sqrt(v.shape[1])))
            for k, v in head.items()}


def _backbone(arch: str, patch_size: int) -> VisionTransformer:
    return (vit_small if arch == "vit_small" else vit_base)(patch_size)


class StegoInference:
    def __init__(self, n_classes: int = 27, dim: int = 70, arch: str = "vit_small",
                 patch_size: int = 8, ckpt_path: str | None = None,
                 dino_ckpt_path: str | None = None, seed: int = 0,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        featurizer = DinoFeaturizer(dim=dim, backbone=_backbone(arch, patch_size))
        if ckpt_path and Path(ckpt_path).exists():
            state, clusters = self._load_ckpt(ckpt_path)
        else:
            logger.warning("No STEGO checkpoint; using the port's seeded random head (plumbing "
                           "only, masks are not semantically meaningful).")
            trunk = (load_dino_torch_weights(dino_ckpt_path) if dino_ckpt_path
                     else random_state(featurizer.model, seed))
            state = dict(random_head_state(featurizer, seed),
                         **{f"model.{k}": v for k, v in trunk.items()})
            clusters = torch.randn(n_classes, dim, generator=torch.Generator().manual_seed(seed + 1))
        featurizer.load_state_dict(state, strict=True)
        self._bind(featurizer, clusters)

    def _bind(self, featurizer: DinoFeaturizer, clusters: torch.Tensor) -> None:
        self.model = featurizer.to(self.device).eval()
        self.clusters = clusters.detach().float().to(self.device)
        self.n_classes = len(clusters)
        self.timings: list[tuple[float, float]] = []    # (network s, CRF s) a predict_mask

    @classmethod
    def from_trained(cls, featurizer: DinoFeaturizer, clusters: torch.Tensor,
                     device: str | torch.device = "cuda") -> "StegoInference":
        """Inference on a trained head (`selfsup.stego_train.train_stego`)."""
        self = cls.__new__(cls)
        self.device = resolve_device(device)
        self._bind(featurizer, clusters)
        return self

    @staticmethod
    def _load_ckpt(path: str) -> tuple[dict[str, torch.Tensor], torch.Tensor]:
        """A ``LitUnsupervisedSegmenter`` checkpoint → (the featurizer's state
        dict, the cluster centres)."""
        ckpt = torch.load(path, map_location="cpu", weights_only=False)
        sd = ckpt.get("state_dict", ckpt)
        trunk = dino_state({k[len("net.model."):]: v for k, v in sd.items()
                            if k.startswith("net.model.")})
        state = {f"model.{k}": v for k, v in trunk.items()}
        for name in ("cluster1.0", "cluster2.0", "cluster2.2"):
            for leaf in ("weight", "bias"):
                state[f"{name}.{leaf}"] = sd[f"net.{name}.{leaf}"]
        return state, sd["cluster_probe.clusters"]

    def save_ckpt(self, path: str | Path) -> None:
        """This head, centres and trunk as a ``LitUnsupervisedSegmenter``
        checkpoint (the names `_load_ckpt` and STEGO read)."""
        sd = {f"net.{k}": v.detach().cpu() for k, v in self.model.state_dict().items()}
        sd["cluster_probe.clusters"] = self.clusters.detach().cpu()
        torch.save({"state_dict": sd}, path)

    def log_probs(self, img_uint8: np.ndarray) -> np.ndarray:
        """The cluster log-probs [C, h, w] float32 of one image cropped to a
        multiple of the patch: flip-averaged code, bilinear to the crop, α = 2."""
        p = self.model.model.patch_size
        h0, w0 = img_uint8.shape[:2]
        h, w = (h0 // p) * p or p, (w0 // p) * p or p
        x = torch.as_tensor(np.ascontiguousarray(img_uint8[:h, :w])).to(self.device).float()
        x = (x / 255.0 - torch.as_tensor(IMAGENET_MEAN, device=self.device)) \
            / torch.as_tensor(IMAGENET_STD, device=self.device)
        x = x.permute(2, 0, 1)[None]
        with torch.no_grad(), no_tf32():
            code1 = self.model(x)
            code2 = self.model(x.flip(3))
            code = (code1 + code2.flip(2)) / 2.0
            code = resize(code, (1, h, w, code.shape[-1]), method="bilinear")
            lp = cluster_probe_log_probs(code, self.clusters)
        return lp[0].permute(2, 0, 1).cpu().numpy()

    def predict_mask(self, img_uint8: np.ndarray, use_crf: bool = True) -> np.ndarray:
        """One image → cluster-id mask [H, W] uint8 (flip-TTA, bilinear
        upsample, cluster-probe log-probs, dense CRF, argmax)."""
        h0, w0 = img_uint8.shape[:2]
        t0 = time.perf_counter()
        logits = self.log_probs(img_uint8)
        t1 = time.perf_counter()
        h, w = logits.shape[1:]
        probs = (dense_crf(logits, np.ascontiguousarray(img_uint8[:h, :w])) if use_crf
                 else logits)
        self.timings.append((t1 - t0, time.perf_counter() - t1))
        mask = probs.argmax(0).astype(np.uint8)
        if (h, w) != (h0, w0):          # pad back to the original size (nearest edge)
            full = np.zeros((h0, w0), dtype=np.uint8)
            full[:h, :w] = mask
            full[h:, :w] = mask[-1:, :]
            full[:, w:] = full[:, w - 1:w]
            mask = full
        return mask

    def generate_mask_dir(self, image_iter, out_dir: str | Path, use_crf: bool = True) -> Path:
        """(name, uint8 image) pairs → a grey PNG mask ``<stem>.png`` each."""
        out = Path(out_dir)
        out.mkdir(parents=True, exist_ok=True)
        for name, img in image_iter:
            write_png(out / f"{Path(name).stem}.png", self.predict_mask(np.asarray(img), use_crf))
        return out


def image_files(image_dir: str | Path) -> list[Path]:
    """The images under ``image_dir`` (recursive), sorted."""
    return sorted(f for f in Path(image_dir).rglob("*") if f.suffix.lower() in IMAGE_SUFFIXES)


def main(argv: list[str] | None = None) -> tuple[Path, list[tuple[float, float]]]:
    """The CLI; returns the mask dir and each image's (network s, CRF s)."""
    p = argparse.ArgumentParser(description="STEGO segmentation masks")
    p.add_argument("--image_dir", required=True, help="dir of images to segment (recursive)")
    p.add_argument("--out_dir", required=True)
    p.add_argument("--ckpt", default=None, help="STEGO torch .ckpt")
    p.add_argument("--dino_ckpt", default=None)
    p.add_argument("--n_classes", type=int, default=27)
    p.add_argument("--dim", type=int, default=70)
    p.add_argument("--arch", default="vit_small")
    p.add_argument("--patch_size", type=int, default=8)
    p.add_argument("--no_crf", action="store_true")
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)

    st = StegoInference(n_classes=a.n_classes, dim=a.dim, arch=a.arch, patch_size=a.patch_size,
                        ckpt_path=a.ckpt, dino_ckpt_path=a.dino_ckpt, device=a.device)
    files = image_files(a.image_dir)
    out = st.generate_mask_dir(((f.name, read_image(f)) for f in files), a.out_dir,
                               use_crf=not a.no_crf)
    net = sum(t[0] for t in st.timings)
    crf = sum(t[1] for t in st.timings)
    logger.info(f"wrote {len(files)} masks to {a.out_dir} (network {net:.3f} s, CRF {crf:.3f} s)")
    return out, st.timings


if __name__ == "__main__":
    main()

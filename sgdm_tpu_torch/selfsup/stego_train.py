"""STEGO training: the contrastive correlation loss and the probes.

The port's copy of `sgdm_tpu/selfsup/stego_train.py` (STEGO's
``LitUnsupervisedSegmenter`` and ``ContrastiveCorrelationLoss``):

  * `contrastive_correlation_loss`: ``feature_samples²`` points an image,
    bilinear samples of the frozen features and of the code there
    (`_bilinear_sample`: align-corners coordinates, the upper neighbour
    clipped to the edge, formula for formula the JAX package's, not
    ``F.grid_sample``), feature and code correlations, and the code's pushed
    towards the features' minus a shift over three pairings: the image with
    itself, with a kNN positive, and with shuffled negatives; the published
    weights 0.67 / 0.28 / 0.63;
  * `cluster_probe_loss` (α None: the hard one-hot, a stop-gradient) and
    `linear_probe_loss` (label 255 ignored);
  * `precompute_knns` (CLS kNN of the dataset, `ops.knn.run_nns`) and
    `train_stego`: the head and the cluster centres trained by two Adams
    (optax's order: lr 5e-4 and 5e-3, b1 0.9, b2 0.999, eps 1e-8 outside
    the square root) over the frozen trunk, which runs once a batch under
    ``torch.no_grad`` and feeds both the head and the loss (the JAX package
    runs it twice; the values are equal).

The random draws are apart from the math: `draw_contrastive` draws the
sample coordinates (U[-1, 1), [B, S², 2] twice) and the negatives'
permutations from a `torch.Generator`; `contrastive_correlation_loss` takes
them, so the tests hand it the JAX package's ``jax.random`` draws.
"""

from __future__ import annotations

import time
from typing import Callable

import numpy as np
import torch

from ..data.loader import DataLoader
from ..device import no_tf32, resolve_device
from ..ops.knn import run_nns
from ..utils.logging import logger
from ..utils.resize import resize
from .ssl_backbone import IMAGENET_MEAN, IMAGENET_STD, get_ssl_backbone
from .stego import DinoFeaturizer, StegoInference, random_head_state

__all__ = ["tensor_correlation", "contrastive_correlation_loss", "cluster_probe_loss",
           "linear_probe_loss", "draw_contrastive", "precompute_knns", "train_stego",
           "AdamState"]


def _norm(t: torch.Tensor) -> torch.Tensor:
    return t / torch.linalg.norm(t, dim=-1, keepdim=True).clamp(min=1e-12)


def tensor_correlation(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[B, N, C] x [B, M, C] → [B, N, M] inner products."""
    return torch.einsum("bnc,bmc->bnm", a, b)


def _bilinear_sample(img: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """img [H, W, C], coords [N, 2] in [-1, 1] → [N, C]."""
    return _sample_grid(img[None], coords[None])[0]


def _sample_grid(feats: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """feats [B, H, W, C], coords [B, N, 2] → [B, N, C]."""
    _, h, w, _ = feats.shape
    x = (coords[..., 0] + 1.0) * 0.5 * (w - 1)
    y = (coords[..., 1] + 1.0) * 0.5 * (h - 1)
    x0 = torch.floor(x).long().clamp(0, w - 1)
    y0 = torch.floor(y).long().clamp(0, h - 1)
    x1 = (x0 + 1).clamp(0, w - 1)
    y1 = (y0 + 1).clamp(0, h - 1)
    wx = (x - x0)[..., None]
    wy = (y - y0)[..., None]
    b = torch.arange(feats.shape[0], device=feats.device)[:, None]
    v00, v01 = feats[b, y0, x0], feats[b, y0, x1]
    v10, v11 = feats[b, y1, x0], feats[b, y1, x1]
    return (1 - wy) * ((1 - wx) * v00 + wx * v01) + wy * ((1 - wx) * v10 + wx * v11)


def _pair_loss(f1, f2, c1, c2, shift: float, zero_clamp: bool, stabilize: bool,
               pointwise: bool):
    fd = tensor_correlation(_norm(f1.detach()), _norm(f2.detach()))
    if pointwise:
        old_mean = fd.mean()
        fd = fd - fd.mean(dim=2, keepdim=True)
        fd = fd - fd.mean() + old_mean
    cd = tensor_correlation(_norm(c1), _norm(c2))
    min_val = 0.0 if zero_clamp else -9999.0
    cd = cd.clamp(min_val, 0.8) if stabilize else cd.clamp(min=min_val)
    return -cd * (fd - shift), cd


def draw_contrastive(gen: torch.Generator, b: int, feature_samples: int = 11,
                     neg_samples: int = 5) -> dict:
    """One batch's draws on ``gen``'s device: ``coords1`` / ``coords2``
    U[-1, 1) [b, S², 2] and ``perms``, ``neg_samples`` permutations of b."""
    n = feature_samples * feature_samples
    dev = gen.device
    return dict(coords1=torch.rand(b, n, 2, generator=gen, device=dev) * 2 - 1,
                coords2=torch.rand(b, n, 2, generator=gen, device=dev) * 2 - 1,
                perms=[torch.randperm(b, generator=gen, device=dev) for _ in range(neg_samples)])


def contrastive_correlation_loss(
    feats: torch.Tensor,           # [B, h, w, C]  frozen features
    feats_pos: torch.Tensor,       # the kNN positives' features
    code: torch.Tensor,            # [B, h, w, D]  head codes
    code_pos: torch.Tensor,
    *,
    coords1: torch.Tensor,
    coords2: torch.Tensor,
    perms: list,
    pos_intra_shift: float = 0.18,
    pos_inter_shift: float = 0.12,
    neg_inter_shift: float = 0.46,
    zero_clamp: bool = True,
    stabilize: bool = False,
    pointwise: bool = True,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """(loss, {pos_intra, pos_inter, neg_inter}) on the given draws (the
    defaults are the published VOC config's)."""
    f = _sample_grid(feats, coords1)
    c = _sample_grid(code, coords1)
    f_pos = _sample_grid(feats_pos, coords2)
    c_pos = _sample_grid(code_pos, coords2)

    kw = dict(zero_clamp=zero_clamp, stabilize=stabilize, pointwise=pointwise)
    pos_intra, _ = _pair_loss(f, f, c, c, pos_intra_shift, **kw)
    pos_inter, _ = _pair_loss(f, f_pos, c, c_pos, pos_inter_shift, **kw)
    neg_losses = []
    for perm in perms:
        perm = torch.as_tensor(perm, device=feats.device, dtype=torch.long)
        f_neg = _sample_grid(feats[perm], coords2)
        c_neg = _sample_grid(code[perm], coords2)
        neg_losses.append(_pair_loss(f, f_neg, c, c_neg, neg_inter_shift, **kw)[0])
    neg_inter = torch.cat(neg_losses, dim=0)
    aux = {"pos_intra": pos_intra.mean(), "pos_inter": pos_inter.mean(),
           "neg_inter": neg_inter.mean()}
    loss = 0.67 * pos_intra.mean() + 0.28 * pos_inter.mean() + 0.63 * neg_inter.mean()
    return loss, aux


def cluster_probe_loss(code: torch.Tensor, clusters: torch.Tensor,
                       alpha: float | None = None) -> torch.Tensor:
    """−(probs · ip) of the normalised inner products; α None: the hard
    one-hot of the argmax (no gradient through it), else softmax(α · ip)."""
    ip = torch.einsum("bhwc,nc->bhwn", _norm(code), _norm(clusters))
    if alpha is None:
        probs = torch.nn.functional.one_hot(ip.argmax(-1), clusters.shape[0]).to(ip.dtype)
        probs = probs.detach()
    else:
        probs = torch.softmax(ip * alpha, dim=-1)
    return -(probs * ip).sum(-1).mean()


def linear_probe_loss(code: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                      labels: torch.Tensor, num_classes: int) -> torch.Tensor:
    """Cross-entropy of a 1×1 head (w [C, n], b [n]) against per-pixel
    labels; labels outside [0, num_classes) (255) are ignored."""
    logits = torch.einsum("bhwc,cn->bhwn", code, w) + b
    mask = (labels >= 0) & (labels < num_classes)
    safe = torch.where(mask, labels, torch.zeros_like(labels)).long()
    logp = torch.log_softmax(logits, dim=-1)
    ce = -logp.gather(-1, safe[..., None])[..., 0]
    return (ce * mask).sum() / mask.sum().clamp(min=1)


class AdamState:
    """optax.adam over a list of tensors, in optax's order: μ and ν, the
    bias corrections, ``lr · μ̂ / (√ν̂ + eps)``."""

    def __init__(self, params: list[torch.Tensor], lr: float, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        self.params, self.lr, self.b1, self.b2, self.eps = params, lr, b1, b2, eps
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]
        self.count = 0

    @torch.no_grad()
    def step(self) -> None:
        self.count += 1
        c1 = 1 - np.float32(self.b1) ** np.float32(self.count)
        c2 = 1 - np.float32(self.b2) ** np.float32(self.count)
        for p, mu, nu in zip(self.params, self.mu, self.nu):
            g = p.grad
            mu.mul_(self.b1).add_((1 - self.b1) * g)
            nu.mul_(self.b2).add_((1 - self.b2) * (g * g))
            p.add_(-self.lr * ((mu / float(c1)) / (torch.sqrt(nu / float(c2)) + self.eps)))
            p.grad = None


def precompute_knns(backbone, dataset, k: int = 7, batch_size: int = 32) -> np.ndarray:
    """The ``k`` nearest images of each (CLS features, exact L2, self
    dropped) for the kNN positives: [N, k] int64."""
    feats = []
    dl = DataLoader(dataset, batch_size=batch_size, shuffle=False, drop_last=False)
    for batch in dl:
        feats.append(backbone.batch_encode_feat(backbone.transform_batch(batch["img4unsup"])))
    feats = np.concatenate(feats).astype(np.float32)
    nns, _ = run_nns(feats, feats, k_nn=k, device=backbone.device)
    return nns


def _images(dataset, idxs, image_size: int, device: torch.device) -> torch.Tensor:
    """``img4unsup`` of ``idxs`` → [B, 3, S, S] float32, resized (JAX's
    bilinear) and ImageNet-normalised on the device."""
    imgs = np.stack([np.asarray(dataset[int(i)]["img4unsup"]) for i in idxs])
    x = torch.as_tensor(imgs).to(device).float() / 255.0
    if x.shape[1] != image_size:
        x = resize(x, (x.shape[0], image_size, image_size, 3), method="bilinear")
    x = (x - torch.as_tensor(IMAGENET_MEAN, device=device)) \
        / torch.as_tensor(IMAGENET_STD, device=device)
    return x.permute(0, 3, 1, 2)


def train_step(featurizer: DinoFeaturizer, clusters: torch.Tensor, opt_head: AdamState,
               opt_cluster: AdamState, x: torch.Tensor, x_pos: torch.Tensor,
               draws: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """One update of the head and the centres on a batch and its positives
    (the trunk frozen): returns (loss, probe loss), on the device."""
    with no_tf32():
        with torch.no_grad():
            feats = featurizer.features(x)
            feats_pos = featurizer.features(x_pos)
        code, code_pos = featurizer.head(feats), featurizer.head(feats_pos)
        cc_loss, _ = contrastive_correlation_loss(feats, feats_pos, code, code_pos, **draws)
        probe_loss = cluster_probe_loss(code.detach(), clusters, alpha=None)
        loss = cc_loss + probe_loss
        loss.backward()
    opt_head.step()
    opt_cluster.step()
    return loss.detach(), probe_loss.detach()


def _init_head(featurizer: DinoFeaturizer, n_classes: int, dim: int,
               seed: int) -> tuple[dict, torch.Tensor]:
    """The seeded random head's state (``seed``) and the centres
    [n_classes, dim] (normal on a generator seeded ``seed + 1``)."""
    clusters = torch.randn(n_classes, dim, generator=torch.Generator().manual_seed(seed + 1))
    return random_head_state(featurizer, seed), clusters


def train_stego(
    dataset,
    *,
    arch: str = "vit_small",
    patch_size: int = 8,
    dim: int = 70,
    n_classes: int = 27,
    steps: int = 1000,
    batch_size: int = 16,
    lr: float = 5e-4,
    cluster_lr: float = 5e-3,
    image_size: int = 224,
    knn_k: int = 7,
    seed: int = 0,
    dino_ckpt_path: str | None = None,
    log_every: int = 50,
    report: Callable[[dict], None] | None = None,
    device: str | torch.device = "cuda",
) -> StegoInference:
    """Train the STEGO head and centres over the frozen DINO trunk; returns
    the `StegoInference` of the trained head.

    Each step draws a batch and its kNN positives from
    ``np.random.default_rng(seed)`` (the JAX package's draws) and the
    contrastive draws by `draw_contrastive` on a generator seeded ``seed + 2``;
    the head and centres start from `_init_head`.  ``report``, when given,
    gets every ``log_every`` steps the step, loss, probe loss and the seconds
    since the last report (read after the loss reaches the host)."""
    dev = resolve_device(device)
    backbone_name = ("dino_vits" if arch == "vit_small" else "dino_vitb") + str(patch_size)
    backbone = get_ssl_backbone(backbone_name, image_size=image_size, ckpt_path=dino_ckpt_path,
                                device=dev)
    nns = precompute_knns(backbone, dataset, k=knn_k, batch_size=batch_size)

    featurizer = DinoFeaturizer(dim=dim, backbone=backbone.model)
    head, clusters = _init_head(featurizer, n_classes, dim, seed)
    missing, unexpected = featurizer.load_state_dict(head, strict=False)
    if unexpected or any(not k.startswith("model.") for k in missing):
        raise KeyError(f"head state: unexpected {unexpected}, missing {missing}")
    featurizer.to(dev)
    for p in featurizer.model.parameters():
        p.requires_grad_(False)
    clusters = clusters.detach().float().to(dev).requires_grad_(True)
    opt_head = AdamState([p for n, p in featurizer.named_parameters()
                          if not n.startswith("model.")], lr)
    opt_cluster = AdamState([clusters], cluster_lr)
    gen = torch.Generator(device=dev).manual_seed(seed + 2)

    n = len(dataset)
    np_rng = np.random.default_rng(seed)
    t0 = time.perf_counter()
    for it in range(steps):
        idxs = np_rng.integers(0, n, batch_size)
        pos_idxs = np.array([nns[i][np_rng.integers(0, knn_k)] for i in idxs])
        loss, probe_loss = train_step(featurizer, clusters, opt_head, opt_cluster,
                                      _images(dataset, idxs, image_size, dev),
                                      _images(dataset, pos_idxs, image_size, dev),
                                      draw_contrastive(gen, batch_size))
        if (it + 1) % log_every == 0:
            row = dict(step=it + 1, loss=float(loss), probe_loss=float(probe_loss),
                       seconds=time.perf_counter() - t0)
            t0 = time.perf_counter()
            logger.info(f"stego step {it + 1}/{steps} loss {row['loss']:.4f} "
                        f"probe {row['probe_loss']:.4f}")
            if report is not None:
                report(row)
    for p in featurizer.parameters():
        p.requires_grad_(False)
    return StegoInference.from_trained(featurizer, clusters.detach(), device=dev)

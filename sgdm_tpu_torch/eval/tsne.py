"""t-SNE of generated against real features, drawn without matplotlib.

Port of `sgdm_tpu/eval/tsne.py` `kluster_tsne_vis`: both image dirs are
embedded with the SimCLR ResNet-50 (`knn_eval.embed_image_dir`), laid out
jointly in 2-D by t-SNE and scattered, generated as discs ('o') and real as
down-triangles ('v').  When every file name carries a cluster id
(``…cluster{id}.png``) a point takes its cluster's colour, else its
source's.

The JAX package calls ``sklearn.manifold.TSNE(init="pca")``.  Here:

  * the joint probabilities P as sklearn's ``_joint_probabilities_nn``:
    the ⌊3·perplexity⌋ + 1 nearest neighbours (`ops/knn.py`), a binary
    search of each point's Gaussian precision to the perplexity
    (`binary_search_perplexity`, float64), symmetrised and normalised;
  * the embedding optimised on the device with the EXACT gradient over
    all N² pairs (sklearn's default is Barnes-Hut) under sklearn's
    schedule: PCA init scaled to std 1e-4, early exaggeration 12 for 250
    iterations at momentum 0.5, then momentum 0.8 to 1,000 iterations,
    learning rate max(N / 12 / 4, 50), per-coordinate gains (+0.2 / ×0.8,
    at least 0.01);
  * the scatter rasterised in numpy (`scatter_image`), without a text
    legend.
"""

from __future__ import annotations

import math
import re
from pathlib import Path

import numpy as np
import torch

from ..device import no_tf32, resolve_device
from ..ops.knn import knn_search
from ..utils.logging import logger
from ..utils.png import write_png
from .knn_eval import embed_image_dir, image_files

__all__ = ["kluster_tsne_vis", "joint_probabilities_nn", "binary_search_perplexity",
           "tsne_embed", "kl_divergence", "scatter_image"]

_CLUSTER_RE = re.compile(r"cluster(\d+)\.[A-Za-z]+$")

EARLY_EXAGGERATION = 12.0
EXPLORATION_ITERS = 250
N_ITER = 1000
MACHINE_EPSILON = np.finfo(np.double).eps


def _dir_cluster_ids(folder: str | Path, max_items: int | None) -> np.ndarray | None:
    """Per-file cluster ids parsed from ``*cluster{id}.png`` names, in the
    order `embed_image_dir` reads the folder; None when any file lacks it."""
    ids = []
    for f in image_files(folder, max_items):
        m = _CLUSTER_RE.search(f.name)
        if m is None:
            return None
        ids.append(int(m.group(1)))
    return np.asarray(ids) if ids else None


def binary_search_perplexity(sqdistances: np.ndarray, desired_perplexity: float,
                             n_steps: int = 100, tol: float = 1e-5) -> np.ndarray:
    """Conditional P [N, K] (float64) from the squared distances to each
    point's K neighbours: per row a bisection on the Gaussian's precision β
    until the entropy is log(perplexity) within ``tol`` (sklearn's
    ``_binary_search_perplexity``, all rows at once)."""
    d = np.asarray(sqdistances, np.float32).astype(np.float64)
    n = len(d)
    desired = math.log(desired_perplexity)
    beta = np.ones(n)
    lo, hi = np.full(n, -np.inf), np.full(n, np.inf)
    p = np.zeros_like(d)
    active = np.ones(n, bool)
    for _ in range(n_steps):
        if not active.any():
            break
        rows = np.flatnonzero(active)
        pr = np.exp(-d[rows] * beta[rows, None])
        s = pr.sum(1)
        s[s == 0.0] = 1e-8
        pr /= s[:, None]
        p[rows] = pr
        entropy = np.log(s) + beta[rows] * (d[rows] * pr).sum(1)
        diff = entropy - desired
        done = np.abs(diff) <= tol
        up = ~done & (diff > 0)
        down = ~done & ~(diff > 0)
        r_up, r_down = rows[up], rows[down]
        lo[r_up] = beta[r_up]
        beta[r_up] = np.where(np.isinf(hi[r_up]), beta[r_up] * 2.0, (beta[r_up] + hi[r_up]) / 2)
        hi[r_down] = beta[r_down]
        beta[r_down] = np.where(np.isinf(lo[r_down]), beta[r_down] / 2.0,
                                (beta[r_down] + lo[r_down]) / 2)
        active[rows[done]] = False
    return p


def joint_probabilities_nn(feats: np.ndarray, perplexity: float,
                           device: str | torch.device = "cuda") -> np.ndarray:
    """The symmetric joint P [N, N] (float64, sum 1) of sklearn's Barnes-Hut
    t-SNE: each point's ⌊3·perplexity⌋ + 1 nearest other points by squared
    Euclidean distance, `binary_search_perplexity`, P + Pᵀ normalised."""
    n = len(feats)
    k = min(n - 1, int(3.0 * perplexity + 1))
    d2, idx = knn_search(feats, feats, k + 1, device=device)
    # drop each point itself (the nearest, unless an exact duplicate ties it)
    own = idx == np.arange(n)[:, None]
    keep = ~own
    keep[~own.any(1), -1] = False
    d2 = d2[keep].reshape(n, k)
    idx = idx[keep].reshape(n, k)
    cond = binary_search_perplexity(d2, perplexity)
    p = np.zeros((n, n))
    p[np.repeat(np.arange(n), k), idx.ravel()] = cond.ravel()
    p = p + p.T
    return p / max(p.sum(), MACHINE_EPSILON)


def _pca_init(feats: np.ndarray, device: torch.device) -> torch.Tensor:
    """The first two principal coordinates (float64 eigh of the smaller Gram
    matrix), as float32 scaled to std 1e-4 along the first."""
    x = torch.as_tensor(np.asarray(feats), dtype=torch.float64, device=device)
    x = x - x.mean(0)
    if len(x) <= x.shape[1]:
        vals, vec = torch.linalg.eigh(x @ x.T)
        y = vec[:, -2:].flip(1) * vals[-2:].flip(0).clamp_min(0).sqrt()
    else:
        y = x @ torch.linalg.eigh(x.T @ x)[1][:, -2:].flip(1)
    y = y.float()
    return y / y[:, 0].std(unbiased=False) * 1e-4


def _affinities(y: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(w = 1 / (1 + |y_i − y_j|²) with a zero diagonal, Q = w / Σw):
    Student-t with one degree of freedom."""
    w = 1.0 / (1.0 + torch.cdist(y, y).square())
    w.fill_diagonal_(0.0)
    return w, (w / w.sum()).clamp_min(MACHINE_EPSILON)


def _grad(p: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The exact gradient of KL(P ‖ Q) in y."""
    w, q = _affinities(y)
    pq = (p - q) * w
    return 4.0 * (pq.sum(1, keepdim=True) * y - pq @ y)


def _kl(p: torch.Tensor, y: torch.Tensor) -> float:
    q = _affinities(y)[1]
    return float((p * torch.log(p.clamp_min(MACHINE_EPSILON) / q)).sum())


def kl_divergence(p: np.ndarray, y: np.ndarray) -> float:
    """KL(P ‖ Q) of an embedding ``y`` [N, 2] (float64, on the host)."""
    return _kl(torch.as_tensor(p, dtype=torch.float64),
               torch.as_tensor(np.asarray(y), dtype=torch.float64))


def tsne_embed(feats: np.ndarray, perplexity: float = 30.0, n_iter: int = N_ITER,
               device: str | torch.device = "cuda", p: np.ndarray | None = None
               ) -> tuple[np.ndarray, float]:
    """(embedding [N, 2] float32, its KL) of ``feats`` [N, D]."""
    dev = resolve_device(device)
    n = len(feats)
    if p is None:
        p = joint_probabilities_nn(feats, perplexity, device=dev)
    lr = max(n / EARLY_EXAGGERATION / 4.0, 50.0)
    with torch.no_grad(), no_tf32():
        pt = torch.as_tensor(p, dtype=torch.float32, device=dev)
        exaggerated = pt * EARLY_EXAGGERATION
        y = _pca_init(feats, dev)
        update = torch.zeros_like(y)
        gains = torch.ones_like(y)
        for it in range(n_iter):
            explore = it < EXPLORATION_ITERS
            grad = _grad(exaggerated if explore else pt, y)
            inc = update * grad < 0.0
            gains = torch.where(inc, gains + 0.2, gains * 0.8).clamp_(min=0.01)
            update = (0.5 if explore else 0.8) * update - lr * (grad * gains)
            y = y + update
        kl = _kl(pt, y)
    return y.cpu().numpy(), kl


def _hsv_colors(n: int) -> np.ndarray:
    """n + 1 evenly spaced hues of matplotlib's 'hsv' map, the first n as uint8 RGB."""
    h = np.arange(n) / (n + 1) * 6.0
    i = np.floor(h).astype(int) % 6
    f = h - np.floor(h)
    one, up, down = np.ones(n), f, 1.0 - f
    zero = np.zeros(n)
    table = {0: (one, up, zero), 1: (down, one, zero), 2: (zero, one, up),
             3: (zero, down, one), 4: (up, zero, one), 5: (one, zero, down)}
    rgb = np.stack([np.choose(i, [table[k][c] for k in range(6)]) for c in range(3)], -1)
    return np.rint(rgb * 255).astype(np.uint8)


SOURCE_COLORS = {0: (255, 127, 14), 1: (31, 119, 180)}   # generated, real
SCATTER_SIZE, SCATTER_MARGIN, MARKER_R = 600, 20, 3


def scatter_image(xy: np.ndarray, source: np.ndarray,
                  cluster_ids: np.ndarray | None = None) -> np.ndarray:
    """uint8 [600, 600, 3] scatter on white: generated points (source 0) as
    discs, real ones (1) as down-triangles, coloured by cluster id or by
    source."""
    img = np.full((SCATTER_SIZE, SCATTER_SIZE, 3), 255, np.uint8)
    xy = np.asarray(xy, np.float64)
    span = np.maximum(xy.max(0) - xy.min(0), 1e-12)
    inner = SCATTER_SIZE - 2 * SCATTER_MARGIN - 1
    pix = np.rint((xy - xy.min(0)) / span * inner).astype(int) + SCATTER_MARGIN
    if cluster_ids is not None:
        uniq = np.unique(cluster_ids)
        palette = dict(zip(uniq.tolist(), _hsv_colors(len(uniq))))
        colors = [palette[int(c)] for c in cluster_ids]
    else:
        colors = [SOURCE_COLORS[int(s)] for s in source]
    r = MARKER_R
    dy, dx = np.mgrid[-r:r + 1, -r:r + 1]
    disc = dx * dx + dy * dy <= r * r
    tri = (dy >= -r) & (np.abs(dx) <= (r - dy) / 2 + 0.5)     # apex down
    for (x, y), s, c in zip(pix, source, colors):
        shape = disc if int(s) == 0 else tri
        rows, cols = (dy + (SCATTER_SIZE - 1 - y))[shape], (dx + x)[shape]
        img[rows, cols] = c
    return img


def kluster_tsne_vis(sample_dir: str | Path, gt_dir: str | Path,
                     save_path: str | Path = "outputs/tsne_vis.png", backbone=None,
                     max_items: int = 1000, perplexity: float = 30.0,
                     device: str | torch.device = "cuda") -> Path:
    """Embed both dirs (``max_items`` each), t-SNE jointly and write the
    scatter (the PCA init leaves nothing to draw)."""
    if backbone is None:
        from ..selfsup.ssl_backbone import get_ssl_backbone

        backbone = get_ssl_backbone("simclr_rn50", device=device)
    f_sample, _ = embed_image_dir(sample_dir, backbone, max_items=max_items)
    f_real, _ = embed_image_dir(gt_dir, backbone, max_items=max_items)
    feats = np.concatenate([f_sample, f_real])
    source = np.array([0] * len(f_sample) + [1] * len(f_real))
    cid_s, cid_r = _dir_cluster_ids(sample_dir, max_items), _dir_cluster_ids(gt_dir, max_items)
    cluster_ids = np.concatenate([cid_s, cid_r]) \
        if cid_s is not None and cid_r is not None else None

    xy, kl = tsne_embed(feats, perplexity=min(perplexity, len(feats) / 4), device=device)
    save_path = Path(save_path)
    save_path.parent.mkdir(parents=True, exist_ok=True)
    write_png(save_path, scatter_image(xy, source, cluster_ids))
    logger.info(f"saved t-SNE vis to {save_path} (KL {kl:.4f})")
    return save_path

"""k-means with faiss's semantics on the card: the self-labeling clusterer.

The port's copy of `sgdm_tpu/ops/kmeans.py`, itself the rewrite of the
reference's faiss-gpu `run_kmeans`.  Every quirk of the JAX package stays:

  * the TRAIN features are L2-normalised IN PLACE before training, in
    numpy on the host, row by row (`run_kmeans` mutates its argument);
  * Lloyd's iterations with faiss's defaults: seed 1234, the training set
    subsampled to k · max_points_per_centroid, init by k distinct random
    training points, empty clusters split from a large one with faiss's
    ±1/1024 perturbation; the numpy ``Generator`` draws the subsample, the
    init and every split in the same order as the JAX package;
  * the final assignment runs on the caller's ``feat_trainval``, the
    UNNORMALISED copies (``kmeans.index.search(feat_trainval, 1)``).

Each iteration runs on the device in chunks of rows: the [chunk, k]
squared distances ``|x|² + |c|² − 2·x·cᵀ`` are one float32 matmul (TF32
off), the first nearest centroid is ``argmin`` (lowest index on ties, as
``jnp.argmin``), and the per-cluster sums and counts accumulate with
``index_add_`` (JAX's ``segment_sum``).  The sums come back to the host
each iteration, where the new centroids and the splits are computed in
numpy as in JAX.  No fused kernel: the JAX package runs this in XLA.
"""

from __future__ import annotations

import time
from typing import Callable

import numpy as np
import torch

from ..device import no_tf32, resolve_device

__all__ = ["kmeans_assign", "run_kmeans", "lloyd_iteration"]


def _normalize_rows(x: np.ndarray, rows: int = 65536) -> np.ndarray:
    """``x /= np.linalg.norm(x, axis=1, keepdims=True)`` in place, a block
    of rows at a time (equal bits, without a temporary of ``x``'s size)."""
    for i in range(0, len(x), rows):
        block = x[i:i + rows]
        block /= np.linalg.norm(block, axis=1, keepdims=True)
    return x


def _distances(x: torch.Tensor, centroids: torch.Tensor, c_norm: torch.Tensor) -> torch.Tensor:
    """[rows, k] float32 ``(|x|² + |c|²) − 2·x·cᵀ``, one buffer."""
    d2 = (x * x).sum(-1, keepdim=True) + c_norm[None, :]
    return d2.addmm_(x, centroids.T, alpha=-2.0)


def _assign(x: torch.Tensor, centroids: torch.Tensor, c_norm: torch.Tensor):
    d2 = _distances(x, centroids, c_norm)
    labels = torch.argmin(d2, dim=-1)
    return labels, d2.gather(1, labels[:, None])[:, 0]


def kmeans_assign(feats: np.ndarray, centroids: np.ndarray, chunk: int = 65536,
                  device: str | torch.device = "cuda") -> tuple[np.ndarray, np.ndarray]:
    """Nearest centroid of every row (faiss ``index.search(x, 1)``):
    (labels int64 [N], squared distances float32 [N], clamped at 0)."""
    dev = resolve_device(device)
    chunk = min(chunk, max(len(feats), 1))
    labels = np.empty(len(feats), np.int64)
    dists = np.empty(len(feats), np.float32)
    with torch.no_grad(), no_tf32():
        c = torch.as_tensor(np.asarray(centroids, np.float32)).to(dev)
        c_norm = (c * c).sum(-1)
        for i in range(0, len(feats), chunk):
            x = torch.as_tensor(np.asarray(feats[i:i + chunk], np.float32)).to(dev)
            lab, best = _assign(x, c, c_norm)
            labels[i:i + len(x)] = lab.cpu().numpy()
            dists[i:i + len(x)] = best.clamp_(min=0.0).cpu().numpy()
    return labels, dists


def lloyd_iteration(train: torch.Tensor, centroids: torch.Tensor, chunk: int
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One assignment pass: per-cluster sums [k, d], counts [k] and the
    objective (the sum of clamped squared distances), all float32 on the
    device."""
    k, d = centroids.shape
    sums = torch.zeros(k, d, dtype=torch.float32, device=train.device)
    counts = torch.zeros(k, dtype=torch.float32, device=train.device)
    obj = torch.zeros((), dtype=torch.float32, device=train.device)
    c_norm = (centroids * centroids).sum(-1)
    for i in range(0, len(train), chunk):
        x = train[i:i + chunk]
        labels, best = _assign(x, centroids, c_norm)
        sums.index_add_(0, labels, x)
        counts.index_add_(0, labels, torch.ones_like(best))
        obj += best.clamp_(min=0.0).sum()
    return sums, counts, obj


def _split_empty_clusters(
    centroids: np.ndarray, counts: np.ndarray, rng: np.random.Generator,
    eps: float = 1.0 / 1024.0,
) -> tuple[np.ndarray, np.ndarray]:
    """faiss split_clusters: an empty centroid takes a ±eps-perturbed copy of
    a large cluster's centroid (probability ∝ cluster size)."""
    counts = counts.copy()
    empty = np.where(counts < 0.5)[0]
    for ci in empty:
        probs = counts / counts.sum()
        donor = rng.choice(len(counts), p=probs)
        direction = rng.integers(0, 2, size=centroids.shape[1]) * 2 - 1
        centroids[ci] = centroids[donor] * (1 + eps * direction)
        centroids[donor] = centroids[donor] * (1 - eps * direction)
        counts[ci] = counts[donor] / 2
        counts[donor] = counts[donor] - counts[ci]
    return centroids, counts


def run_kmeans(
    feat_train: np.ndarray,
    feat_trainval: np.ndarray,
    cluster_k: int,
    niter: int = 30,  # faiss.Kmeans reference default
    minp: int = 200,
    max_points_per_centroid: int = 256,
    seed: int = 1234,
    chunk: int = 65536,
    report: Callable[[dict], None] | None = None,
    device: str | torch.device = "cuda",
) -> tuple[np.ndarray, np.ndarray]:
    """Drop-in for faiss_kmeans.run_kmeans: returns (assignments, centroids).

    NOTE mutates ``feat_train`` in place (L2 normalisation) exactly like the
    reference: callers relying on the unnormalised-assignment quirk must
    concatenate ``feat_trainval`` BEFORE calling, as the reference does.
    ``report`` (the JAX package's ``verbose``), when given, is called first
    with ``warning`` when there are fewer than ``minp`` points a centroid,
    then after each iteration with its ``iteration``, ``objective``, the
    count of empty clusters ``split`` and its ``seconds`` (the host's
    clock, the iteration ending when its sums reach the host): ``print``
    prints as ``verbose=True`` did."""
    dev = resolve_device(device)
    n, d = feat_train.shape
    _normalize_rows(feat_train)

    rng = np.random.default_rng(seed)
    # faiss subsamples the training set to k * max_points_per_centroid
    limit = cluster_k * max_points_per_centroid
    idx = rng.permutation(n)[:limit] if n > limit else None
    if n < cluster_k * minp and report is not None:
        report(dict(warning=f"only {n} points for {cluster_k} centroids "
                            f"(min_points_per_centroid={minp})"))
    with torch.no_grad(), no_tf32():
        train = torch.as_tensor(np.asarray(feat_train, np.float32)).to(dev)
        if idx is not None:
            train = train[torch.as_tensor(idx, device=dev)]
        # init: k distinct random training points (faiss default)
        init_idx = rng.permutation(len(train))[:cluster_k]
        centroids = train[torch.as_tensor(init_idx, device=dev)].cpu().numpy().astype(np.float32)

        chunk = min(chunk, len(train))
        for it in range(niter):
            t0 = time.perf_counter()
            sums, counts, obj = lloyd_iteration(train, torch.as_tensor(centroids).to(dev), chunk)
            sums, counts = sums.cpu().numpy(), counts.cpu().numpy()
            new_centroids = np.where(
                counts[:, None] > 0, sums / np.maximum(counts[:, None], 1), centroids
            ).astype(np.float32)
            split = int((counts < 0.5).sum())
            centroids, counts = _split_empty_clusters(new_centroids, counts, rng)
            if report is not None:
                report(dict(iteration=it, objective=float(obj), split=split,
                            seconds=time.perf_counter() - t0))
        del train

    labels, _ = kmeans_assign(feat_trainval, centroids, chunk=chunk, device=dev)
    return labels, centroids

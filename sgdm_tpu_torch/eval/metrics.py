"""Generative-model evaluation metrics: FID, sFID, IS, PRDC.

The port's copy of `sgdm_tpu/eval/metrics.py` (numpy float64, no JAX):

  * `frechet_distance` — the FID formula with scipy `sqrtm` and clean-fid's
    eps fallback for singular covariances,
  * `inception_score` — softmax-KL over 1 or 10 splits,
  * `compute_prdc` — precision / recall / density / coverage (Naeem et al.
    2020),
  * `FeatureStats` — streaming mean / covariance accumulation.

`FeatureStats.reduce_across_processes` is the identity in one process and
raises under a `torch.distributed` world of more than one: the
multi-process reduce comes with the parallel slice (ROADMAP §1 item 9).
"""

from __future__ import annotations

import numpy as np
import scipy.linalg

__all__ = [
    "FeatureStats",
    "frechet_distance",
    "inception_score",
    "compute_prdc",
]


class FeatureStats:
    """Streaming mean + covariance (and optional raw-feature retention)."""

    def __init__(self, capture_all: bool = False, max_items: int | None = None):
        self.capture_all = capture_all
        self.max_items = max_items
        self.n = 0
        self._sum: np.ndarray | None = None
        self._outer: np.ndarray | None = None
        self._raw: list[np.ndarray] = []

    def append(self, feats: np.ndarray) -> None:
        feats = np.asarray(feats, dtype=np.float64)
        if self.max_items is not None:
            room = self.max_items - self.n
            if room <= 0:
                return
            feats = feats[:room]
        if self._sum is None:
            d = feats.shape[1]
            self._sum = np.zeros(d)
            self._outer = np.zeros((d, d))
        self.n += feats.shape[0]
        self._sum += feats.sum(axis=0)
        self._outer += feats.T @ feats
        if self.capture_all:
            self._raw.append(feats.astype(np.float32))

    @property
    def raw(self) -> np.ndarray:
        return np.concatenate(self._raw, axis=0) if self._raw else np.empty((0, 0))

    def mean_cov(self) -> tuple[np.ndarray, np.ndarray]:
        assert self.n > 1, "need at least 2 samples"
        mu = self._sum / self.n
        # unbiased covariance (np.cov default ddof=1 — what clean-fid uses)
        cov = (self._outer - self.n * np.outer(mu, mu)) / (self.n - 1)
        return mu, cov

    def merge(self, other: "FeatureStats") -> "FeatureStats":
        """In-place merge of another accumulator (sums are additive)."""
        if other._sum is None:
            return self
        if self._sum is None:
            d = other._sum.shape[0]
            self._sum = np.zeros(d)
            self._outer = np.zeros((d, d))
        self.n += other.n
        self._sum += other._sum
        self._outer += other._outer
        if self.capture_all:
            self._raw.extend(other._raw)
        return self

    def reduce_across_processes(self) -> "FeatureStats":
        """Global statistics of a multi-process run.  One process: this
        accumulator as it is.  A `torch.distributed` world of more than one
        process raises (ROADMAP §1 item 9)."""
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
            raise NotImplementedError(
                "FID statistics across processes are not ported yet: ROADMAP §1 item 9")
        return self


def frechet_distance(
    mu1: np.ndarray, sigma1: np.ndarray, mu2: np.ndarray, sigma2: np.ndarray,
    eps: float = 1e-6,
) -> float:
    """||mu1-mu2||² + Tr(S1 + S2 - 2 sqrt(S1 S2)).  clean-fid semantics."""
    mu1, mu2 = np.atleast_1d(mu1), np.atleast_1d(mu2)
    sigma1, sigma2 = np.atleast_2d(sigma1), np.atleast_2d(sigma2)
    diff = mu1 - mu2
    # scipy < 1.17 returns (sqrtm, errest) with disp=False; newer returns
    # just the matrix
    res = scipy.linalg.sqrtm(sigma1.dot(sigma2))
    covmean = res[0] if isinstance(res, tuple) else res
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = scipy.linalg.sqrtm(
            (sigma1 + offset).dot(sigma2 + offset)
        )
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2)
                 - 2 * np.trace(covmean))


def inception_score(logits: np.ndarray, splits: int = 10) -> tuple[float, float]:
    """IS mean/std over `splits` chunks from 1008-way logits."""
    logits = np.asarray(logits, dtype=np.float64)
    logits = logits - logits.max(axis=1, keepdims=True)
    probs = np.exp(logits)
    probs /= probs.sum(axis=1, keepdims=True)
    scores = []
    n = probs.shape[0]
    for i in range(splits):
        part = probs[i * n // splits:(i + 1) * n // splits]
        if len(part) == 0:
            continue
        py = part.mean(axis=0, keepdims=True)
        kl = part * (np.log(part + 1e-16) - np.log(py + 1e-16))
        scores.append(np.exp(kl.sum(axis=1).mean()))
    return float(np.mean(scores)), float(np.std(scores))


def _pairwise_sq_dists(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    a2 = (a ** 2).sum(1)[:, None]
    b2 = (b ** 2).sum(1)[None, :]
    d = a2 + b2 - 2 * a @ b.T
    return np.maximum(d, 0.0)


def compute_prdc(
    real_features: np.ndarray, fake_features: np.ndarray, nearest_k: int = 5
) -> dict[str, float]:
    """Precision/recall/density/coverage (Naeem et al., arXiv:2002.09797)."""
    real = np.asarray(real_features, dtype=np.float64)
    fake = np.asarray(fake_features, dtype=np.float64)

    def kth_radii(x: np.ndarray) -> np.ndarray:
        d = np.sqrt(_pairwise_sq_dists(x, x))
        # kth nearest EXCLUDING self: self-distance 0 is column 0 after sort
        return np.sort(d, axis=1)[:, nearest_k]

    real_radii = kth_radii(real)
    fake_radii = kth_radii(fake)
    d_rf = np.sqrt(_pairwise_sq_dists(real, fake))  # [n_real, n_fake]

    precision = float((d_rf < real_radii[:, None]).any(axis=0).mean())
    recall = float((d_rf < fake_radii[None, :]).any(axis=1).mean())
    density = float(
        (d_rf < real_radii[:, None]).sum(axis=0).mean() / nearest_k
    )
    coverage = float(
        (d_rf.min(axis=1) < real_radii).mean()
    )
    return dict(precision=precision, recall=recall, density=density,
                coverage=coverage)

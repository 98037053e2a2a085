"""Exact k-NN search on the card: the faiss IndexFlatL2 replacement.

The port's copy of `sgdm_tpu/ops/knn.py` (the rewrite of the reference's
faiss `run_nns`): exact L2 search of the queries against an index, k + 1
neighbours with the self-match dropped, radii = sqrt of the squared
distances.

Per chunk of queries the [rows, N] squared distances are one float32
matmul (TF32 off), ``(|q|² + |x|²) − 2·q·xᵀ`` clamped at 0, then
``topk(largest=False)`` on that buffer in place: no negated copy.  Rows
are split further so the buffer stays under ``MAX_BYTES`` (an IN64-size
chunk of 8,192 queries against 1.33 M rows would need 43.6 GB); the split
changes no result.  Nothing else of a split's size is allocated, so the
device holds the index, one buffer and the [rows, k + 1] results.

Ties are broken as ``lax.top_k`` breaks them, lower index first: torch's
``topk`` promises no order among equal values, so the k + 1 smallest are
re-sorted by (distance, index).  Where the (k + 1)-th equals the k-th,
that distance may occur beyond the k + 1 returned, and the row is
scanned for the lowest indices of it.  With duplicated rows this decides
which copy is dropped as the "self" match.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import no_tf32, resolve_device

__all__ = ["knn_search", "run_nns", "search_chunk"]

MAX_BYTES = 8 << 30        # the distance buffer's bound per split of a chunk


def _topk_lowest_index(d2: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` smallest of each row of ``d2``, ascending, equal values in
    ascending index order, and at the k-th value the lowest indices."""
    vals, idx = torch.topk(d2, min(k + 1, d2.shape[1]), dim=1, largest=False, sorted=True)
    idx, order = idx.sort(dim=1)                       # by index, then stably by value
    vals = vals.gather(1, order)
    vals, order = vals.sort(dim=1, stable=True)
    idx = idx.gather(1, order)
    if vals.shape[1] > k:                              # the k-th value may go on past k + 1
        crossing = vals[:, k] == vals[:, k - 1]
        vals, idx = vals[:, :k], idx[:, :k]
        for r in torch.nonzero(crossing)[:, 0].tolist():
            kth = vals[r, -1]
            keep = int((vals[r] < kth).sum())
            idx[r, keep:] = torch.nonzero(d2[r] == kth)[:, 0][:k - keep]
    return vals, idx


def search_chunk(q: torch.Tensor, index: torch.Tensor, index_sq_norm: torch.Tensor, k: int
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` nearest rows of ``index`` to each query, on the queries'
    device: (squared distances [Q, k], indices [Q, k]); the [rows, N]
    distance buffer is split over the queries to stay under ``MAX_BYTES``."""
    rows = max(1, min(len(q), MAX_BYTES // (4 * max(len(index), 1))))
    dists, idxs = [], []
    for j in range(0, len(q), rows):
        qr = q[j:j + rows]
        d2 = (qr * qr).sum(-1, keepdim=True) + index_sq_norm[None, :]
        d2.addmm_(qr, index.T, alpha=-2.0).clamp_(min=0.0)
        d, ix = _topk_lowest_index(d2, k)
        del d2
        dists.append(d)
        idxs.append(ix)
    return torch.cat(dists), torch.cat(idxs)


def knn_search(index_feats: np.ndarray, queries: np.ndarray, k: int, chunk: int = 8192,
               device: str | torch.device = "cuda") -> tuple[np.ndarray, np.ndarray]:
    """Returns (squared_distances [Q, k] float32, indices [Q, k] int64) —
    faiss search parity."""
    dev = resolve_device(device)
    dists, idxs = [], []
    with torch.no_grad(), no_tf32():
        index = torch.as_tensor(np.asarray(index_feats, np.float32)).to(dev)
        sqn = (index * index).sum(-1)
        for i in range(0, len(queries), chunk):
            q = torch.as_tensor(np.asarray(queries[i:i + chunk], np.float32)).to(dev)
            d, ix = search_chunk(q, index, sqn, k)
            dists.append(d.cpu().numpy())
            idxs.append(ix.cpu().numpy())
    return np.concatenate(dists), np.concatenate(idxs).astype(np.int64)


def run_nns(feats: np.ndarray, features_trainval: np.ndarray, k_nn: int = 20,
            device: str | torch.device = "cuda", **_unused
            ) -> tuple[np.ndarray, np.ndarray]:
    """Drop-in for faiss_kmeans.run_nns: k_nn neighbours excluding self.

    Returns (sample_nns [N, k] int64, sample_nn_radius_all [N, k] float32)."""
    d2, idx = knn_search(feats, features_trainval, k_nn + 1, device=device)
    radii = np.sqrt(d2)
    # discard the 0-NN (the input sample itself)
    sample_nns = idx[:, 1:].astype(np.int64)
    sample_radii = radii[:, 1:].astype(np.float32)
    if sample_nns.size and sample_nns.min() < 0:
        raise ValueError("negative neighbour index")
    return sample_nns, sample_radii

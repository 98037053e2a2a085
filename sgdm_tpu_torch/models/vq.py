"""Vector quantization (lucidrains vector-quantize-pytorch).

Port of `sgdm_tpu/models/vq.py` (zoo breadth: no shipped config uses it):

  * Euclidean codebook: −distance assignment, EMA ``cluster_size`` and
    ``embed_avg`` with Laplace smoothing;
  * cosine codebook: l2-normalised embeddings and inputs, EMA on the
    normalised means;
  * k-means codebook init from the first batch, gated on ``initted``;
  * dead-code expiry below an EMA threshold, with the JAX package's
    static-shape redesign: ``codebook_size`` rows are drawn from the batch
    and written in under the expiry mask;
  * `VectorQuantize`: in / out projections, several heads (shared or
    separate codebooks), the straight-through estimator, the commitment
    loss and the orthogonal regularisation (eq. 2 of arXiv:2112.00384),
    which makes the codebook a learned parameter that the EMA leaves alone.

The codebook state is the module's buffers (``embed``, ``embed_avg``,
``cluster_size``, ``initted``: the JAX package's ``"vq"`` collection,
`models/convert.py vq_from_flax`), updated in place by a ``train=True``
call.  Every draw (k-means' initial rows, the expiry rows, the Gumbel
noise) comes from ``generator`` or, as ``draws={"kmeans": [h, K] ids,
"expire": [h, K] ids, "gumbel": uniform [h, n, K]}``, from the caller; with
neither, a generator seeded per draw name, as the JAX package's rng-free
fallback is deterministic.  The initial codebook is drawn from a
`torch.Generator` seeded with 42 (the JAX package's ``PRNGKey(42)``).
"""

from __future__ import annotations

import zlib
from typing import Mapping

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["VectorQuantize", "kmeans", "orthogonal_loss_fn"]


def _l2norm(t: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return t / (torch.linalg.vector_norm(t, dim=-1, keepdim=True) + eps)


def _neg_dist(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """−‖x_n − c_k‖ [h, n, K], each difference formed, as the JAX package does."""
    return -torch.cdist(x, c, compute_mode="donot_use_mm_for_euclid_dist")


def _sample_vectors(samples: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows ``idx`` [h, num] of each head's samples [h, n, d]."""
    return torch.gather(samples, 1, idx[..., None].expand(-1, -1, samples.shape[-1]))


def kmeans(samples: torch.Tensor, num_clusters: int, num_iters: int = 10,
           use_cosine_sim: bool = False, idx: torch.Tensor | None = None,
           generator: torch.Generator | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-head k-means from ``num_clusters`` sampled rows (``idx`` [h, K],
    else drawn); argmax assignment; an empty cluster keeps its old mean.
    Returns (means [h, K, d], bins [h, K])."""
    h, n, _ = samples.shape
    if idx is None:
        idx = torch.randint(0, n, (h, num_clusters), generator=generator,
                            device=samples.device)
    means = _sample_vectors(samples, idx.to(samples.device))
    bins = None
    for _ in range(num_iters):
        dists = torch.einsum("hnd,hcd->hnc", samples, means) if use_cosine_sim \
            else _neg_dist(samples, means)
        onehot = F.one_hot(dists.argmax(-1), num_clusters).to(samples.dtype)
        bins = onehot.sum(1)
        new_means = torch.einsum("hnc,hnd->hcd", onehot, samples) / bins.clamp_min(1.0)[..., None]
        if use_cosine_sim:
            new_means = _l2norm(new_means)
        means = torch.where((bins == 0)[..., None], means, new_means)
    return means, bins


def orthogonal_loss_fn(t: torch.Tensor) -> torch.Tensor:
    """eq. (2) of arXiv:2112.00384 over codebooks [h, n, d]."""
    h, n = t.shape[:2]
    normed = _l2norm(t)
    cos = torch.einsum("hid,hjd->hij", normed, normed)
    eye = torch.eye(n, dtype=t.dtype, device=t.device)[None]
    return ((cos - eye) ** 2).sum() / (h * n ** 2)


class VectorQuantize(nn.Module):
    """``forward(x, train=False, generator=None, draws=None)`` → (quantize,
    embed_ind, loss); ``x`` [B, N, dim] (channels last), [B, dim, N] with
    ``channel_last=False``, or [B, H, W, dim] with ``accept_image_fmap``."""

    def __init__(self, dim: int, codebook_size: int, codebook_dim: int | None = None,
                 heads: int = 1, separate_codebook_per_head: bool = False, decay: float = 0.8,
                 eps: float = 1e-5, kmeans_init: bool = False, kmeans_iters: int = 10,
                 use_cosine_sim: bool = False, threshold_ema_dead_code: float = 0.0,
                 channel_last: bool = True, accept_image_fmap: bool = False,
                 commitment_weight: float = 1.0, orthogonal_reg_weight: float = 0.0,
                 orthogonal_reg_active_codes_only: bool = False,
                 orthogonal_reg_max_codes: int | None = None,
                 sample_codebook_temp: float = 0.0):
        super().__init__()
        self.dim, self.codebook_size, self.heads = dim, codebook_size, heads
        self.separate = separate_codebook_per_head
        self.decay, self.eps = decay, eps
        self.kmeans_init, self.kmeans_iters = kmeans_init, kmeans_iters
        self.use_cosine_sim = use_cosine_sim
        self.threshold_ema_dead_code = threshold_ema_dead_code
        self.channel_last, self.accept_image_fmap = channel_last, accept_image_fmap
        self.commitment_weight = commitment_weight
        self.orthogonal_reg_weight = orthogonal_reg_weight
        self.sample_codebook_temp = sample_codebook_temp
        self.learnable = orthogonal_reg_weight > 0
        h_cb = heads if separate_codebook_per_head else 1
        self.cb_dim = codebook_dim or dim
        cb_input_dim = self.cb_dim * heads
        self.needs_proj = cb_input_dim != dim
        if self.needs_proj:
            self.project_in = nn.Linear(dim, cb_input_dim)
            self.project_out = nn.Linear(cb_input_dim, dim)
        init = torch.rand((h_cb, codebook_size, self.cb_dim),
                          generator=torch.Generator().manual_seed(42))
        if use_cosine_sim:
            init = _l2norm(init)
        if kmeans_init:
            init = torch.zeros_like(init)
        if self.learnable:
            self.embed = nn.Parameter(init.clone())
        else:
            self.register_buffer("embed", init.clone())
        self.register_buffer("embed_avg", init.clone())
        self.register_buffer("cluster_size", torch.zeros(h_cb, codebook_size))
        self.register_buffer("initted", torch.tensor(not kmeans_init))

    def _draw(self, name: str, draws: Mapping | None, generator: torch.Generator | None,
              make) -> torch.Tensor:
        if draws is not None and name in draws:
            return torch.as_tensor(draws[name], device=self.embed.device)
        if generator is None:
            generator = torch.Generator(device=self.embed.device).manual_seed(
                zlib.crc32(name.encode()) % (2 ** 31))
        return make(generator)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None, draws: Mapping | None = None):
        heads, d, size = self.heads, self.cb_dim, self.codebook_size
        h_cb = heads if self.separate else 1
        dev = x.device
        orig_shape = x.shape
        if self.accept_image_fmap:
            x = x.reshape(x.shape[0], x.shape[1] * x.shape[2], x.shape[-1])
        elif not self.channel_last:
            x = x.transpose(-1, -2)
        if self.needs_proj:
            x = self.project_in(x)
        b, n, _ = x.shape
        if heads > 1:
            xs = x.reshape(b, n, heads, d)
            xh = xs.permute(2, 0, 1, 3).reshape(h_cb, b * n, d) if self.separate \
                else xs.permute(0, 2, 1, 3).reshape(1, b * heads * n, d)
        else:
            xh = x.reshape(1, b * n, d)
        xh = xh.float()
        flat = _l2norm(xh) if self.use_cosine_sim else xh
        embed = self.embed

        # k-means init on the first batch
        if self.kmeans_init and not bool(self.initted):
            idx = self._draw("kmeans", draws, generator, lambda g: torch.randint(
                0, flat.shape[1], (h_cb, size), generator=g, device=dev))
            km_embed, km_bins = kmeans(flat.detach(), size, self.kmeans_iters,
                                       self.use_cosine_sim, idx=idx)
            with torch.no_grad():
                if not self.learnable:
                    self.embed.copy_(km_embed)
                    self.embed_avg.copy_(km_embed)
                    embed = self.embed
                self.cluster_size.copy_(km_bins.float())
        if self.kmeans_init:
            self.initted.fill_(True)

        embed_calc = embed.detach() if self.learnable else embed
        dist = torch.einsum("hnd,hcd->hnc", flat, _l2norm(embed_calc)) \
            if self.use_cosine_sim else _neg_dist(flat, embed_calc)
        if self.sample_codebook_temp > 0:
            u = self._draw("gumbel", draws, generator, lambda g: torch.rand(
                dist.shape, generator=g, device=dev) * (1.0 - 1e-20) + 1e-20)
            g = -torch.log(-torch.log(u + 1e-20))
            embed_ind = (dist / self.sample_codebook_temp + g).argmax(-1)
        else:
            embed_ind = dist.argmax(-1)
        quantize = torch.gather(embed, 1, embed_ind[..., None].expand(-1, -1, d))

        # the EMA codebook update
        if train and not self.learnable:
            with torch.no_grad():
                onehot = F.one_hot(embed_ind, size).float()
                bins = onehot.sum(1)
                self.cluster_size.mul_(self.decay).add_(bins * (1 - self.decay))
                embed_sum = torch.einsum("hnd,hnc->hcd", flat, onehot)
                if self.use_cosine_sim:
                    norm_means = _l2norm(embed_sum / bins.clamp_min(1.0)[..., None])
                    norm_means = torch.where((bins == 0)[..., None], self.embed, norm_means)
                    new_embed = self.embed * self.decay + norm_means * (1 - self.decay)
                else:
                    self.embed_avg.mul_(self.decay).add_(embed_sum * (1 - self.decay))
                    cs = self.cluster_size
                    total = cs.sum(-1, keepdim=True)
                    smoothed = (cs + self.eps) / (total + size * self.eps) * total
                    new_embed = self.embed_avg / smoothed[..., None]
                if self.threshold_ema_dead_code > 0:
                    expired = self.cluster_size < self.threshold_ema_dead_code
                    idx = self._draw("expire", draws, generator, lambda g: torch.randint(
                        0, flat.shape[1], (h_cb, size), generator=g, device=dev))
                    repl = _sample_vectors(_l2norm(flat), idx)
                    new_embed = torch.where(expired[..., None], repl, new_embed)
                self.embed.copy_(new_embed)

        if train:   # straight-through
            quantize = xh + (quantize - xh).detach()
        loss = torch.zeros((), device=dev)
        if train:
            if self.commitment_weight > 0:
                loss = loss + ((quantize.detach() - xh) ** 2).mean() * self.commitment_weight
            if self.orthogonal_reg_weight > 0:
                # the whole codebook: the active-codes subset is a dynamic
                # shape the JAX package leaves out, and so does the port
                loss = loss + orthogonal_loss_fn(embed) * self.orthogonal_reg_weight

        if heads > 1:
            if self.separate:
                quantize = quantize.reshape(heads, b, n, d).permute(1, 2, 0, 3)
                ind = embed_ind.reshape(heads, b, n).permute(1, 2, 0)
            else:
                quantize = quantize.reshape(b, heads, n, d).permute(0, 2, 1, 3)
                ind = embed_ind.reshape(b, heads, n).permute(0, 2, 1)
            quantize = quantize.reshape(b, n, heads * d)
        else:
            quantize = quantize.reshape(b, n, d)
            ind = embed_ind.reshape(b, n)
        quantize = quantize.to(x.dtype)
        if self.needs_proj:
            quantize = self.project_out(quantize)
        if self.accept_image_fmap:
            quantize = quantize.reshape(orig_shape[0], orig_shape[1], orig_shape[2], -1)
            ind = ind.reshape((orig_shape[0], orig_shape[1], orig_shape[2]) + ind.shape[2:])
        elif not self.channel_last:
            quantize = quantize.transpose(-1, -2)
        return quantize, ind, loss

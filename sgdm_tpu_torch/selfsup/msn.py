"""MSN pre-training (Masked Siamese Networks, Assran et al. 2022): the loss,
the patch masking and the compact train step.

The port's copy of `sgdm_tpu/selfsup/msn.py`: an EMA target encoder embeds
the full view, the anchor encoder a patch-masked view, both are soft-assigned
to learnable prototypes (cosine similarity, softmax at the snn temperature),
and the anchor is trained with cross-entropy against the sharpened target
assignment plus the me-max regulariser (the entropy of the mean anchor
assignment).  The masking noise [B, N] is handed in (the tests hand in
JAX's ``jax.random.uniform`` draw) or drawn from a `torch.Generator`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .pretrain_common import apply_updates, grads_of

__all__ = ["msn_loss", "sharpen", "make_msn_train_step", "mask_patches", "snn"]


def sharpen(p: torch.Tensor, T: float = 0.25) -> torch.Tensor:
    """``p^(1/T)`` renormalised over the last axis."""
    p = p ** (1.0 / T)
    return p / p.sum(-1, keepdim=True)


def snn(query: torch.Tensor, prototypes: torch.Tensor, tau: float) -> torch.Tensor:
    """softmax(cos(query, prototypes) / tau): both sides L2-normalised (floor 1e-12)."""
    q = query / torch.clamp(torch.linalg.vector_norm(query, dim=-1, keepdim=True), min=1e-12)
    s = prototypes / torch.clamp(torch.linalg.vector_norm(prototypes, dim=-1, keepdim=True),
                                 min=1e-12)
    return torch.softmax(q @ s.T / tau, dim=-1)


def msn_loss(anchor_emb: torch.Tensor, target_emb: torch.Tensor, prototypes: torch.Tensor, *,
             temperature: float = 0.1, target_temperature: float = 0.25,
             me_max_weight: float = 1.0) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Cross-entropy of the anchors' assignment against the target's (the snn
    temperature on both sides, the target sharpened at ``target_temperature``
    and cut from the graph) plus ``me_max_weight`` × Σ avg·log(avg)."""
    probs = snn(anchor_emb, prototypes, temperature)
    with torch.no_grad():
        targets = sharpen(snn(target_emb, prototypes, temperature), T=target_temperature)
    ce = -(targets * torch.log(probs + 1e-12)).sum(-1).mean()
    avg = probs.mean(0)
    me_max = (avg * torch.log(avg + 1e-12)).sum()
    return ce + me_max_weight * me_max, {"ce": ce.detach(), "me_max": me_max.detach()}


def mask_patches(x: torch.Tensor, patch_size: int, mask_ratio: float = 0.7,
                 noise: torch.Tensor | None = None,
                 generator: torch.Generator | None = None) -> torch.Tensor:
    """x [B, 3, H, W] with a random ``int(N·mask_ratio)`` of its patches zeroed
    (the patches whose noise ranks lowest)."""
    b, c, h, w = x.shape
    gh, gw = h // patch_size, w // patch_size
    n = gh * gw
    if noise is None:
        noise = torch.rand(b, n, generator=generator, device=x.device)
    rank = torch.argsort(torch.argsort(noise, dim=1, stable=True), dim=1, stable=True)
    keep = (rank >= int(n * mask_ratio)).to(x.dtype).reshape(b, 1, gh, gw)
    return x * F.interpolate(keep, scale_factor=patch_size, mode="nearest")


def make_msn_train_step(encoder, prototypes: torch.Tensor, target_encoder, tx, patch_size: int,
                        *, ema_decay: float = 0.996, mask_ratio: float = 0.7):
    """``step(x, noise=None, generator=None) -> (loss, aux)``: the anchor
    encoder and ``prototypes`` trained by ``tx`` (state in ``step.opt_state``),
    then the target encoder's weights moved to ``ema_decay·t + (1 − ema_decay)·p``."""
    params = list(encoder.parameters()) + [prototypes]
    holder = {"opt": tx.init(params)}

    def step(x, noise=None, generator=None):
        anchor = encoder(mask_patches(x, patch_size, mask_ratio, noise, generator), out="cls")
        with torch.no_grad():
            target = target_encoder(x, out="cls")
        loss, aux = msn_loss(anchor, target, prototypes)
        grads = grads_of(loss, params)
        updates, holder["opt"] = tx.update(list(grads), holder["opt"], params)
        apply_updates(params, updates)
        with torch.no_grad():
            for t, p in zip(target_encoder.parameters(), encoder.parameters()):
                t.copy_(ema_decay * t + (1 - ema_decay) * p)
        return loss.detach(), aux

    step.opt_state = holder
    return step

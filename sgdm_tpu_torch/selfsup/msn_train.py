"""MSN pre-training: the full trainer and its CLI (Masked Siamese Networks).

The port's copy of `sgdm_tpu/selfsup/msn_train.py` (MSN's ``msn_train.py``,
``losses.py`` and ``data_manager.py``):

  * multi-crop (`MultiCropDataset`): 1 target view + ``rand_views`` anchor
    views at ``rand_size`` + ``focal_views`` crops at ``focal_size``, the
    ImageNet normalisation, its draws from ``np.random.default_rng((seed,
    epoch, i))``, equal to the JAX package's sample for sample;
  * anchor patch drop: each anchor and focal view keeps a random
    ``max(int(N·(1 − patch_drop)), 1)`` of its patch tokens
    (`VisionTransformer(patch_keep_ids=…)`), the ids handed in (the tests
    hand in JAX's) or drawn from a `torch.Generator`;
  * `msn_multiview_loss`: snn at ``tau`` on both sides, the targets sharpened
    at T and tiled VIEW-major (`_views_first` orders the anchors the same
    way), me-max + log K, the optional entropy term;
  * prototypes trained with the encoder by ``clip_by_global_norm →
    scale_by_adam → scheduled_weight_decay (parameters of one dimension
    and the prototypes excluded) → −lr`` (`pretrain_common`), the lr by
    `warmup_cosine_lr`;
  * the EMA target encoder, its momentum and the sharpen temperature on
    `linear_ramp`s over 1.25·total steps.

    python -m sgdm_tpu_torch.selfsup.msn_train --ds synthetic --epochs 1 --device cpu

runs on the card by default and raises without one, and exports the
encoder as ``.msgpack`` + ``.json`` (both packages' ``get_ssl_backbone``
read it).  The network is initialised as flax initialises it and the
prototypes N(0, 0.025²), from a `torch.Generator` seeded with ``--seed``
(not JAX's draws).
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from ..data.loader import DataLoader
from ..device import no_tf32, resolve_device
from ..models.vit import VisionTransformer
from ..utils.logging import logger
from .mae_train import build_dataset, to_nchw
from .pretrain_common import (apply_updates, chain, clip_by_global_norm, flax_init_, grads_of,
                              linear_ramp, multicrop_views, save_encoder_ckpt, scale_by_adam,
                              scale_by_schedule, scheduled_weight_decay, warmup_cosine_lr,
                              wd_mask)
from .ssl_backbone import IMAGENET_MEAN, IMAGENET_STD

__all__ = ["msn_multiview_loss", "make_msn_full_train_step", "MultiCropDataset", "train_msn",
           "main", "build_argparser", "keep_ids"]

_f32 = np.float32


def msn_multiview_loss(anchor_emb: torch.Tensor, target_emb: torch.Tensor,
                       prototypes: torch.Tensor, *, num_views: int, tau: float = 0.1,
                       T: float = 0.25, memax_weight: float = 1.0, ent_weight: float = 0.0):
    """``anchor_emb`` [V·B, D] view-major, ``target_emb`` [B, D]: MSN's loss
    (losses.py) and its parts."""
    from .msn import snn

    probs = snn(anchor_emb, prototypes, tau)
    with torch.no_grad():
        targets = snn(target_emb, prototypes, tau) ** float(_f32(1.0) / _f32(T))
        targets = (targets / targets.sum(-1, keepdim=True)).repeat(num_views, 1)
    ploss = -(targets * torch.log(probs + 1e-12)).sum(-1).mean()
    avg = probs.mean(0)
    rloss = (avg * torch.log(avg + 1e-12)).sum() + float(_f32(np.log(_f32(avg.shape[0]))))
    sloss = (-(probs * torch.log(probs + 1e-12)).sum(-1)).mean()
    loss = ploss + memax_weight * rloss + ent_weight * sloss
    aux = {"ploss": ploss.detach(), "me_max": rloss.detach(), "ent": sloss.detach(),
           "max_t": targets.max(-1).values.mean()}
    return loss, aux


def _views_first(x: torch.Tensor) -> torch.Tensor:
    """[B, V, ...] → [V·B, ...] VIEW-major (all of view 0, then view 1, …):
    the order in which `msn_multiview_loss` tiles the targets; a batch-major
    reshape would pair row B + j with target j % B, not j // V."""
    b, v = x.shape[:2]
    return x.transpose(0, 1).reshape(v * b, *x.shape[2:])


def keep_ids(b: int, n: int, patch_drop: float, noise: torch.Tensor | None = None,
             generator: torch.Generator | None = None, device=None) -> torch.Tensor:
    """The first ``max(int(n·(1 − patch_drop)), 1)`` of argsort(noise [b, n])."""
    n_keep = max(int(n * (1.0 - patch_drop)), 1)
    if noise is None:
        noise = torch.rand(b, n, generator=generator, device=device)
    return torch.argsort(noise, dim=1, stable=True)[:, :n_keep]


def make_msn_full_train_step(encoder: VisionTransformer, prototypes: torch.Tensor,
                             target_encoder: VisionTransformer, tx, *, rand_size: int,
                             focal_size: int, rand_views: int, focal_views: int,
                             patch_drop: float = 0.15, tau: float = 0.1,
                             memax_weight: float = 1.0, ent_weight: float = 0.0):
    """``step(batch, m, T, ids=None, generator=None) -> (loss, aux)``.

    ``batch``: {'target' [B, 3, R, R], 'anchors' [B, V, 3, R, R], 'focals'
    [B, F, 3, f, f]}; ``m`` the EMA momentum, ``T`` the sharpen temperature;
    ``ids`` = (anchor keep ids [V·B, n], focal keep ids [F·B, n] or None),
    else drawn from ``generator``.  The encoder and ``prototypes`` are
    updated in place (``tx``'s state in ``step.opt_state``), then the
    target encoder moves to ``m·t + (1 − m)·p``."""
    p = encoder.patch_size
    n_rand, n_focal = (rand_size // p) ** 2, (focal_size // p) ** 2
    num_views = rand_views + focal_views
    params = list(encoder.parameters()) + [prototypes]
    holder = {"opt": tx.init(params)}

    def step(batch, m: float, T: float, ids=None, generator=None):
        a, f = _views_first(batch["anchors"]), _views_first(batch["focals"])
        if ids is None:
            ids = (keep_ids(a.shape[0], n_rand, patch_drop, generator=generator, device=a.device),
                   keep_ids(f.shape[0], n_focal, patch_drop, generator=generator, device=a.device)
                   if focal_views else None)
        embs = [encoder(a, out="cls", patch_keep_ids=ids[0])]
        if focal_views:
            embs.append(encoder(f, out="cls", patch_keep_ids=ids[1]))
        with torch.no_grad():
            target_emb = target_encoder(batch["target"], out="cls")
        loss, aux = msn_multiview_loss(torch.cat(embs), target_emb, prototypes,
                                       num_views=num_views, tau=tau, T=T,
                                       memax_weight=memax_weight, ent_weight=ent_weight)
        grads = grads_of(loss, params)
        updates, holder["opt"] = tx.update(list(grads), holder["opt"], params)
        apply_updates(params, updates)
        mf, om = float(_f32(m)), float(_f32(1.0) - _f32(m))
        with torch.no_grad():
            tp, ep = list(target_encoder.parameters()), list(encoder.parameters())
            torch._foreach_mul_(tp, mf)
            torch._foreach_add_(tp, torch._foreach_mul(ep, om))
        return loss.detach(), aux

    step.opt_state = holder
    return step


class MultiCropDataset:
    """A dataset whose ``image`` is HWC in [-1, 1] as ImageNet-normalised
    multi-crop views (``target``, ``anchors``, ``focals``); `set_epoch`
    re-draws them."""

    def __init__(self, base, *, rand_size, focal_size, rand_views, focal_views, seed=0):
        self.base = base
        self.kw = dict(rand_size=rand_size, focal_size=focal_size, rand_views=rand_views,
                       focal_views=focal_views)
        self.seed = seed
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch

    def __len__(self):
        return len(self.base)

    def __getitem__(self, i):
        img = np.asarray(self.base[i]["image"], dtype=np.float32)
        img = (img + 1.0) / 2.0
        rng = np.random.default_rng((self.seed, self._epoch, i))
        views = multicrop_views(rng, img, **self.kw)
        return {k: (v - IMAGENET_MEAN) / IMAGENET_STD for k, v in views.items()}


def views_to_device(raw: dict, dev: torch.device) -> dict[str, torch.Tensor]:
    """A host multi-crop batch as NCHW tensors ([B, V, 3, S, S] for the view stacks)."""
    out = {}
    for k, v in raw.items():
        if v.ndim == 5:
            b, nv = v.shape[:2]
            out[k] = to_nchw(v.reshape(b * nv, *v.shape[2:]), dev).reshape(b, nv, 3, *v.shape[2:4])
        else:
            out[k] = to_nchw(v, dev)
    return out


def train_msn(args) -> Path:
    dev = resolve_device(args.device)
    encoder = VisionTransformer(patch_size=args.patch_size, embed_dim=args.embed_dim,
                                depth=args.depth, num_heads=args.num_heads,
                                pretrain_img_size=args.rand_size)
    init = torch.Generator().manual_seed(args.seed)
    flax_init_(encoder, init)
    prototypes = (torch.randn(args.num_proto, args.embed_dim, generator=init) * 0.025).to(dev)
    encoder.to(dev)
    target = VisionTransformer(patch_size=args.patch_size, embed_dim=args.embed_dim,
                               depth=args.depth, num_heads=args.num_heads,
                               pretrain_img_size=args.rand_size).to(dev)
    target.load_state_dict(encoder.state_dict())
    target.requires_grad_(False)
    prototypes.requires_grad_(True)

    base = build_dataset(args.ds, max(args.rand_size, 32), args.data_len, args.data_root)
    dataset = MultiCropDataset(base, rand_size=args.rand_size, focal_size=args.focal_size,
                               rand_views=args.rand_views, focal_views=args.focal_views)
    dl = DataLoader(dataset, batch_size=args.batch_size, shuffle=True,
                    num_workers=args.workers, seed=args.seed)
    steps_per_epoch = max(len(dl), 1)
    total = steps_per_epoch * args.epochs

    lr_fn = warmup_cosine_lr(args.start_lr, args.lr, args.final_lr,
                             warmup_steps=args.warmup * steps_per_epoch, total_steps=total)
    mask = wd_mask(list(encoder.parameters())) + [False]       # prototypes: not decayed
    tx = chain(*([clip_by_global_norm(args.clip_grad)] if args.clip_grad > 0 else []),
               scale_by_adam(),
               scheduled_weight_decay(args.wd, args.final_wd, total, mask=mask),
               scale_by_schedule(lambda s: -lr_fn(s)))
    step_fn = make_msn_full_train_step(
        encoder, prototypes, target, tx, rand_size=args.rand_size, focal_size=args.focal_size,
        rand_views=args.rand_views, focal_views=args.focal_views, patch_drop=args.patch_drop,
        tau=args.tau, memax_weight=args.memax_weight, ent_weight=args.ent_weight)
    m_fn = linear_ramp(args.momentum, 1.0, total)
    T_fn = linear_ramp(args.start_sharpen, args.final_sharpen, total)
    gen = torch.Generator(device=dev).manual_seed(args.seed)

    it = 0
    with no_tf32():
        for epoch in range(args.epochs):
            dl.set_epoch(epoch)
            dataset.set_epoch(epoch)
            for raw in dl:
                loss, aux = step_fn(views_to_device(raw, dev), m_fn(it), T_fn(it),
                                    generator=gen)
                if it % args.log_every == 0:
                    logger.info(f"msn epoch {epoch} it {it} loss {float(loss):.4f} "
                                f"ploss {float(aux['ploss']):.4f} "
                                f"me_max {float(aux['me_max']):.4f}")
                it += 1

    out = Path(args.out)
    save_encoder_ckpt(out, encoder.state_dict(), meta={
        "arch": "vit", "patch_size": args.patch_size, "embed_dim": args.embed_dim,
        "depth": args.depth, "num_heads": args.num_heads,
        "pretrain_img_size": args.rand_size, "method": "msn"})
    logger.info(f"saved MSN encoder → {out}")
    return out


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--ds", default="synthetic", choices=["synthetic", "cifar10", "in32p"])
    p.add_argument("--data-root", default="data", help="cifar10 / in32p root")
    p.add_argument("--data-len", type=int, default=256)
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--workers", type=int, default=4)
    p.add_argument("--seed", type=int, default=0)
    # model (tiny defaults; the paper's ViT-S/16: --patch-size 16 --embed-dim 384
    # --depth 12 --num-heads 6 --rand-size 224 --focal-size 96 --focal-views 10)
    p.add_argument("--patch-size", type=int, default=8)
    p.add_argument("--embed-dim", type=int, default=64)
    p.add_argument("--depth", type=int, default=2)
    p.add_argument("--num-heads", type=int, default=2)
    p.add_argument("--rand-size", type=int, default=32)
    p.add_argument("--focal-size", type=int, default=16)
    p.add_argument("--rand-views", type=int, default=1)
    p.add_argument("--focal-views", type=int, default=2)
    p.add_argument("--patch-drop", type=float, default=0.15)
    # criterion (MSN's defaults)
    p.add_argument("--num-proto", type=int, default=64)
    p.add_argument("--tau", type=float, default=0.1)
    p.add_argument("--start-sharpen", type=float, default=0.25)
    p.add_argument("--final-sharpen", type=float, default=0.25)
    p.add_argument("--memax-weight", type=float, default=1.0)
    p.add_argument("--ent-weight", type=float, default=0.0)
    # optimisation
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--start-lr", type=float, default=2e-4)
    p.add_argument("--final-lr", type=float, default=1e-6)
    p.add_argument("--warmup", type=int, default=1, help="warmup epochs")
    p.add_argument("--wd", type=float, default=0.04)
    p.add_argument("--final-wd", type=float, default=0.4)
    p.add_argument("--momentum", type=float, default=0.996)
    p.add_argument("--clip-grad", type=float, default=3.0)
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--out", default="outputs/msn_encoder.msgpack")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def main(argv=None) -> Path:
    return train_msn(build_argparser().parse_args(argv))


if __name__ == "__main__":
    main()

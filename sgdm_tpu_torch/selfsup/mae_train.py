"""MAE pre-training: the full trainer and its CLI.

The port's copy of `sgdm_tpu/selfsup/mae_train.py` (the official recipe of
``main_pretrain.py`` + ``engine_pretrain.py``):

  * the update ``scale_by_adam(0.9, 0.95) → add_decayed_weights(0.05, every
    parameter of more than one dimension) → −lr`` in optax's order
    (`selfsup/pretrain_common.py`), lr = blr · batch / 256;
  * `mae_lr_schedule`: linear warmup over ``warmup_epochs`` then a
    half-cosine to ``min_lr``, the epoch fractional per step, in float32;
  * `AugmentedDataset`: RandomResizedCrop(0.2-1) + horizontal flip and the
    ImageNet normalisation, its draws from ``np.random.default_rng((seed,
    epoch, i))``, equal to the JAX package's sample for sample;
  * the masking noise of each step from a `torch.Generator` on the device
    seeded with ``--seed`` (the JAX trainer folds its step into a PRNG key:
    the draws differ, their law is the same); the network initialised as
    flax initialises it, from a `torch.Generator` (`flax_init_`);
  * the ENCODER exported in the JAX `VisionTransformer` layout (``.msgpack``
    + ``.json``), which both packages' ``get_ssl_backbone(ckpt_path=…)`` read.

    python -m sgdm_tpu_torch.selfsup.mae_train --ds synthetic --epochs 1 --device cpu

runs on the card by default (``--device cuda``) and raises without one.
``--ds cifar10`` and ``in32p`` read under ``--data-root``.
"""

from __future__ import annotations

import argparse
import math
from pathlib import Path

import numpy as np
import torch

from ..data.loader import DataLoader
from ..device import no_tf32, resolve_device
from ..utils.logging import logger
from .mae import MAE, encoder_state_for_backbone, make_mae_train_step
from .pretrain_common import (add_decayed_weights, chain, flax_init_, random_resized_crop,
                              save_encoder_ckpt, scale_by_adam, scale_by_schedule, wd_mask)
from .ssl_backbone import IMAGENET_MEAN, IMAGENET_STD

__all__ = ["train_mae", "main", "mae_lr_schedule", "AugmentedDataset", "build_argparser",
           "build_dataset", "to_nchw"]

_f32 = np.float32


def mae_lr_schedule(lr: float, min_lr: float, warmup_epochs: float, epochs: float,
                    steps_per_epoch: int):
    """Warmup then half-cosine with a fractional epoch (``util/lr_sched.py``), float32."""
    m_warm = _f32(max(warmup_epochs, 1e-8))
    m_cos = _f32(max(epochs - warmup_epochs, 1e-8))

    def f(step: int) -> float:
        e = _f32(step) / _f32(steps_per_epoch)
        if e < warmup_epochs:
            return float(_f32(lr) * e / m_warm)
        return float(_f32(min_lr) + _f32((lr - min_lr) * 0.5) * (
            _f32(1.0) + np.cos(_f32(math.pi) * (e - _f32(warmup_epochs)) / m_cos)))

    return f


class AugmentedDataset:
    """RandomResizedCrop(0.2-1) + hflip + ImageNet normalisation of a dataset
    whose ``image`` is HWC in [-1, 1]; `set_epoch` re-draws the crops."""

    def __init__(self, base, size: int, seed: int = 0):
        self.base, self.size, self.seed = base, size, seed
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch

    def __len__(self):
        return len(self.base)

    def __getitem__(self, i):
        img = np.asarray(self.base[i]["image"], dtype=np.float32)
        img = (img + 1.0) / 2.0
        rng = np.random.default_rng((self.seed, self._epoch, i))
        img = random_resized_crop(rng, img, self.size, scale=(0.2, 1.0))
        return {"image": (img - IMAGENET_MEAN) / IMAGENET_STD}


def build_dataset(ds: str, size: int, n: int, data_root: str = "data"):
    """``synthetic`` (n images at ``size``), ``cifar10`` or ``in32p``."""
    if ds == "synthetic":
        from ..data.synthetic import SyntheticImages

        return SyntheticImages(size=size, length=n, num_classes=10)
    if ds == "cifar10":
        from ..data.cifar10 import CIFAR10

        return CIFAR10(root=data_root, train=True)
    if ds == "in32p":
        from ..data.imagenet_pickle import ImageNetPickle

        return ImageNetPickle(root=str(Path(data_root) / "in32"), train=True, image_size=size)
    raise ValueError(ds)


def to_nchw(images: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A host batch [B, H, W, 3] as a float32 [B, 3, H, W] tensor on ``dev``."""
    x = torch.from_numpy(np.ascontiguousarray(images, dtype=np.float32))
    if dev.type == "cuda":
        x = x.pin_memory()
    return x.to(dev, non_blocking=True).permute(0, 3, 1, 2)


def train_mae(args) -> Path:
    dev = resolve_device(args.device)
    model = MAE(patch_size=args.patch_size, embed_dim=args.embed_dim, depth=args.depth,
                num_heads=args.num_heads, decoder_dim=args.decoder_dim,
                decoder_depth=args.decoder_depth, decoder_heads=args.decoder_heads,
                mask_ratio=args.mask_ratio, pretrain_img_size=args.input_size)
    flax_init_(model, torch.Generator().manual_seed(args.seed)).to(dev)
    base = build_dataset(args.ds, max(args.input_size, 32), args.data_len, args.data_root)
    dataset = AugmentedDataset(base, args.input_size)
    dl = DataLoader(dataset, batch_size=args.batch_size, shuffle=True,
                    num_workers=args.workers, seed=args.seed)
    steps_per_epoch = max(len(dl), 1)

    eff_lr = args.blr * args.batch_size / 256.0
    lr_fn = mae_lr_schedule(eff_lr, args.min_lr, args.warmup_epochs, args.epochs,
                            steps_per_epoch)
    tx = chain(scale_by_adam(b1=0.9, b2=0.95),
               add_decayed_weights(args.weight_decay, mask=wd_mask),
               scale_by_schedule(lambda s: -lr_fn(s)))
    step_fn = make_mae_train_step(model, tx)
    gen = torch.Generator(device=dev).manual_seed(args.seed)

    it = 0
    with no_tf32():
        for epoch in range(args.epochs):
            dl.set_epoch(epoch)
            dataset.set_epoch(epoch)
            for raw in dl:
                loss = step_fn(to_nchw(raw["image"], dev), generator=gen)
                if it % args.log_every == 0:
                    logger.info(f"mae epoch {epoch} it {it} loss {float(loss):.4f}")
                it += 1

    out = Path(args.out)
    save_encoder_ckpt(out, encoder_state_for_backbone(model.state_dict()), meta={
        "arch": "vit", "patch_size": args.patch_size, "embed_dim": args.embed_dim,
        "depth": args.depth, "num_heads": args.num_heads,
        "pretrain_img_size": args.input_size, "method": "mae"})
    logger.info(f"saved MAE encoder → {out}")
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
    # model (tiny defaults; the paper's mae_vit_base_patch16 at 224 is
    # --input-size 224 --patch-size 16 --embed-dim 768 --depth 12 --num-heads 12
    # --decoder-dim 512 --decoder-depth 8 --decoder-heads 16)
    p.add_argument("--input-size", type=int, default=32)
    p.add_argument("--patch-size", type=int, default=8)
    p.add_argument("--embed-dim", type=int, default=64)
    p.add_argument("--depth", type=int, default=2)
    p.add_argument("--num-heads", type=int, default=2)
    p.add_argument("--decoder-dim", type=int, default=32)
    p.add_argument("--decoder-depth", type=int, default=1)
    p.add_argument("--decoder-heads", type=int, default=2)
    p.add_argument("--mask-ratio", type=float, default=0.75)
    # optimisation (main_pretrain.py defaults)
    p.add_argument("--blr", type=float, default=1e-3)
    p.add_argument("--min-lr", type=float, default=0.0)
    p.add_argument("--warmup-epochs", type=float, default=0.25)
    p.add_argument("--weight-decay", type=float, default=0.05)
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--out", default="outputs/mae_encoder.msgpack")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def main(argv=None) -> Path:
    return train_mae(build_argparser().parse_args(argv))


if __name__ == "__main__":
    main()

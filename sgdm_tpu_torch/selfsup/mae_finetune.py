"""MAE end-to-end fine-tuning: a pre-trained encoder turned into a classifier.

The port's copy of `sgdm_tpu/selfsup/mae_finetune.py` (MAE's
``main_finetune.py`` + ``engine_finetune.py``):

  * `ViTClassifier` (``models_vit.py``): ``global_pool`` pools the PRE-norm
    patch tokens through a fresh ``fc_norm`` LayerNorm (the encoder's own
    norm bypassed), else the normed CLS token; the head's kernel
    truncated-normal(2e-5) at initialisation;
  * layer-wise lr decay: `layerwise_lr_scales` gives each parameter
    ``layer_decay ** (depth + 1 − layer_id)`` (`_layer_id`: patch embedding,
    CLS and position embedding 0, block i i + 1, the rest depth + 1),
    applied by `make_finetune_tx` to the update after AdamW (equal to
    torch's per-group lr), with weight decay off for 1-D parameters and the
    CLS / position embeddings (`finetune_wd_mask`);
  * timm's batch-mode `apply_mixup` (one λ a batch, mixup or cutmix by
    ``switch_prob``, cutmix's λ corrected by the box's area, label smoothing
    folded into the targets), `soft_target_ce`, `label_smoothing_ce`;
  * stochastic depth (``--drop_path``, `models/vit.py`);
  * the train augmentation of `FinetuneDataset`: RandomResizedCrop(0.08-1)
    + hflip, `_rand_augment` (``rand-m9-mstd0.5-inc1``: 2 ops an image,
    magnitude N(9, 0.5)), the ImageNet normalisation, `_random_erase`
    (pixel mode, p 0.25); every draw from ``default_rng((seed, epoch, i))``
    in the JAX package's order, every op PIL's pixel for pixel
    (`data/image_ops.py`), so a sample equals the JAX package's.

The step's draws — the mixup λ, box, switch and apply draws and the
drop-path masks — come from the caller: handed in (`draws=`, the tests hand
in JAX's) or drawn by `draw_finetune` from a `torch.Generator` (the λ by
numpy's Beta sampler seeded from that generator; JAX's draws differ, their
law is the same).

    python -m sgdm_tpu_torch.selfsup.mae_finetune --finetune enc.msgpack --device cpu

runs on the card by default and raises without one; it writes
``finetuned.msgpack`` (the classifier in the JAX layout) and
``finetuned_encoder.msgpack`` + ``.json`` at the best validation epoch.
"""

from __future__ import annotations

import argparse
import math
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..data import image_ops
from ..data.loader import DataLoader
from ..device import no_tf32, resolve_device
from ..models.convert import vit_from_flax, vit_to_flax
from ..models.vit import VisionTransformer, _layer_norm
from ..utils.logging import logger
from ..utils.msgpack import pack_params, unpack_params
from .mae_train import build_dataset, mae_lr_schedule, to_nchw
from .pretrain_common import (_resize_np, add_decayed_weights, apply_updates, chain,
                              clip_by_global_norm, flax_init_, grads_of, load_encoder_ckpt,
                              random_resized_crop, save_encoder_ckpt, scale_by_adam,
                              scale_by_schedule, scale_by_tree)
from .ssl_backbone import IMAGENET_MEAN, IMAGENET_STD

__all__ = ["ViTClassifier", "layerwise_lr_scales", "finetune_wd_mask", "make_finetune_tx",
           "apply_mixup", "draw_finetune", "soft_target_ce", "label_smoothing_ce",
           "FinetuneDataset", "make_finetune_train_step", "make_finetune_eval_step",
           "train_finetune", "main", "build_argparser", "build_model", "init_classifier_",
           "save_classifier", "load_classifier"]

_f32 = np.float32


class ViTClassifier(nn.Module):
    """Encoder + classification head (``encoder.*``, ``fc_norm``, ``head``)."""

    def __init__(self, encoder: VisionTransformer, num_classes: int, global_pool: bool = True):
        super().__init__()
        self.encoder, self.num_classes, self.global_pool = encoder, num_classes, global_pool
        d = encoder.embed_dim
        if global_pool:
            self.fc_norm = nn.LayerNorm(d, eps=1e-6)
        self.head = nn.Linear(d, num_classes)

    def forward(self, x: torch.Tensor, drop_masks: torch.Tensor | None = None) -> torch.Tensor:
        pre, normed = self.encoder(x, out="tokens_pair", drop_masks=drop_masks)
        f = _layer_norm(self.fc_norm, pre[:, 1:].mean(dim=1)) if self.global_pool else normed[:, 0]
        return F.linear(f, self.head.weight, self.head.bias)


def init_classifier_(model: ViTClassifier, generator: torch.Generator) -> ViTClassifier:
    """flax's initialisation (`flax_init_`) with the head's kernel
    truncated-normal(2e-5) over [−2σ, 2σ]."""
    flax_init_(model, generator)
    with torch.no_grad():
        model.head.weight.copy_(torch.nn.init.trunc_normal_(
            torch.empty(model.head.weight.shape), std=2e-5, a=-4e-5, b=4e-5, generator=generator))
    return model


# ----------------------------------------------------------------------
# optimizer: layer-wise lr decay + wd mask
# ----------------------------------------------------------------------

def _layer_id(name: str, depth: int) -> int:
    """``get_layer_id_for_vit`` over the port's parameter names."""
    parts = name.split(".")
    if parts[0] == "encoder" and len(parts) > 1:
        if parts[1] in ("cls_token", "pos_embed", "patch_embed"):
            return 0
        if parts[1] == "blocks":
            return int(parts[2]) + 1
    return depth + 1


def layerwise_lr_scales(names, layer_decay: float, depth: int) -> list[float]:
    """``layer_decay ** (depth + 1 − layer_id)`` for each parameter name."""
    return [layer_decay ** (depth + 1 - _layer_id(n, depth)) for n in names]


def finetune_wd_mask(named) -> list[bool]:
    """True = decayed: more than one dimension, and not the CLS token or the
    position embedding."""
    return [p.ndim > 1 and not any(k in ("cls_token", "pos_embed") for k in n.split("."))
            for n, p in named]


def make_finetune_tx(model: nn.Module, lr_schedule, *, weight_decay: float, layer_decay: float,
                     depth: int, clip_grad: float | None = None):
    """[clip_by_global_norm →] AdamW(0.9, 0.999, decay masked) → × layer scale,
    over ``model.parameters()`` in order."""
    named = list(model.named_parameters())
    chain_ = [clip_by_global_norm(clip_grad)] if clip_grad else []
    chain_ += [scale_by_adam(0.9, 0.999),
               add_decayed_weights(weight_decay, mask=finetune_wd_mask(named)),
               scale_by_schedule(lambda s: -lr_schedule(s)),
               scale_by_tree(layerwise_lr_scales([n for n, _ in named], layer_decay, depth))]
    return chain(*chain_)


# ----------------------------------------------------------------------
# mixup / cutmix / losses
# ----------------------------------------------------------------------

def _smooth_onehot(y: torch.Tensor, num_classes: int, smoothing: float) -> torch.Tensor:
    off = smoothing / num_classes
    return F.one_hot(y.long(), num_classes).float() * (1.0 - smoothing) + off


def draw_finetune(generator: torch.Generator, *, mixup_alpha: float, cutmix_alpha: float,
                  prob: float, switch_prob: float, height: int, width: int,
                  model: VisionTransformer | None = None, batch: int = 0,
                  device=None) -> dict:
    """One train step's draws: ``lam_m`` ~ Beta(α, α) (1 without mixup),
    ``lam0`` ~ Beta(α_c, α_c), the box centre ``cy`` ~ U[0, H), ``cx`` ~
    U[0, W), ``use_cut`` (switch_prob, when both are on), ``applied`` (prob),
    all float32 host scalars from the CPU ``generator``; and, given the
    ``model``'s encoder, its drop-path masks for ``batch`` samples drawn on
    ``device``."""
    u = torch.rand(5, generator=generator).tolist()
    seed = int(torch.randint(0, 2 ** 62, (1,), generator=generator))
    beta = np.random.default_rng(seed)
    out = dict(lam_m=float(_f32(beta.beta(mixup_alpha, mixup_alpha))) if mixup_alpha > 0 else 1.0,
               lam0=float(_f32(beta.beta(cutmix_alpha, cutmix_alpha))) if cutmix_alpha > 0 else 1.0,
               cy=float(_f32(u[0] * height)), cx=float(_f32(u[1] * width)),
               use_cut=(u[2] < switch_prob) if mixup_alpha > 0 and cutmix_alpha > 0
               else cutmix_alpha > 0,
               applied=u[3] < prob, drop_masks=None)
    if model is not None and model.drop_path_rate > 0:
        dev_gen = torch.Generator(device=device).manual_seed(seed % 2 ** 63)
        out["drop_masks"] = model.draw_drop_masks(batch, dev_gen)
    return out


def apply_mixup(x: torch.Tensor, y: torch.Tensor, num_classes: int, draws: dict, *,
                mixup_alpha: float = 0.8, cutmix_alpha: float = 1.0, smoothing: float = 0.1):
    """timm's Mixup in batch mode on x [B, 3, H, W] with the step's ``draws``
    (`draw_finetune`, or JAX's): the batch mixed with its reverse (λ·x +
    (1 − λ)·x[::-1]) or a box of the reverse pasted in (λ = 1 − the box's
    share), the smoothed one-hot targets mixed by λ; all in float32."""
    y1 = _smooth_onehot(y, num_classes, smoothing)
    y2, x2 = y1.flip(0), x.flip(0)
    h, w = x.shape[-2:]
    lam_m = _f32(draws["lam_m"]) if mixup_alpha > 0 else _f32(1.0)
    x_mix = float(lam_m) * x + float(_f32(1.0) - lam_m) * x2
    if cutmix_alpha > 0:
        ratio = np.sqrt(_f32(1.0) - _f32(draws["lam0"]))
        ch, cw = _f32(h) * ratio, _f32(w) * ratio
        cy, cx = _f32(draws["cy"]), _f32(draws["cx"])
        y0, y1b = np.clip(cy - ch / _f32(2), 0, h), np.clip(cy + ch / _f32(2), 0, h)
        x0, x1b = np.clip(cx - cw / _f32(2), 0, w), np.clip(cx + cw / _f32(2), 0, w)
        yy = np.arange(h, dtype=np.float32)[:, None]
        xx = np.arange(w, dtype=np.float32)[None, :]
        box = (yy >= y0) & (yy < y1b) & (xx >= x0) & (xx < x1b)
        x_cut = torch.where(torch.from_numpy(box).to(x.device), x2, x)
        lam_c = _f32(1.0) - _f32(_f32(box.sum()) / _f32(h * w))
    else:
        x_cut, lam_c = x_mix, lam_m
    use_cut = bool(draws["use_cut"]) if mixup_alpha > 0 and cutmix_alpha > 0 else cutmix_alpha > 0
    lam = lam_c if use_cut else lam_m
    x_out = x_cut if use_cut else x_mix
    targets = float(lam) * y1 + float(_f32(1.0) - lam) * y2
    if draws["applied"]:
        return x_out, targets
    return x, y1


def soft_target_ce(logits: torch.Tensor, soft_targets: torch.Tensor) -> torch.Tensor:
    """timm's SoftTargetCrossEntropy."""
    return -torch.mean(torch.sum(soft_targets * torch.log_softmax(logits, -1), dim=-1))


def label_smoothing_ce(logits: torch.Tensor, y: torch.Tensor, num_classes: int,
                       smoothing: float = 0.1) -> torch.Tensor:
    """timm's LabelSmoothingCrossEntropy (the soft CE of smoothed one-hots)."""
    return soft_target_ce(logits, _smooth_onehot(y, num_classes, smoothing))


# ----------------------------------------------------------------------
# host-side train augmentation (the JAX package's draws, PIL's ops)
# ----------------------------------------------------------------------

_RA_OPS = (
    "autocontrast", "equalize", "invert", "rotate", "posterize", "solarize",
    "solarize_add", "color", "contrast", "brightness", "sharpness",
    "shear_x", "shear_y", "translate_x", "translate_y",
)


def _rand_augment(rng: np.random.Generator, img01: np.ndarray, num_ops: int = 2,
                  magnitude: float = 9.0, mstd: float = 0.5) -> np.ndarray:
    """``rand-m9-mstd0.5-inc1``: ``num_ops`` ops chosen uniformly, magnitude
    N(m, mstd) clipped to [0, 10], a random sign; on [0, 1] float HWC,
    through uint8 as PIL works."""
    img = np.clip(img01 * 255.0, 0, 255).astype(np.uint8)
    for op in rng.choice(len(_RA_OPS), size=num_ops, replace=True):
        m = float(np.clip(rng.normal(magnitude, mstd), 0.0, 10.0))
        frac = m / 10.0
        sign = -1.0 if rng.random() < 0.5 else 1.0
        name = _RA_OPS[int(op)]
        h, w = img.shape[:2]
        if name == "autocontrast":
            img = image_ops.autocontrast(img)
        elif name == "equalize":
            img = image_ops.equalize(img)
        elif name == "invert":
            img = image_ops.invert(img)
        elif name == "rotate":
            img = image_ops.rotate(img, sign * 30.0 * frac)
        elif name == "posterize":
            img = image_ops.posterize(img, max(1, 8 - int(4 * frac)))
        elif name == "solarize":
            img = image_ops.solarize(img, int(255 * (1.0 - frac)))
        elif name == "solarize_add":
            arr = img.astype(np.int32)
            img = np.where(arr < 128, np.clip(arr + int(110 * frac), 0, 255), arr).astype(np.uint8)
        elif name in ("color", "contrast", "brightness", "sharpness"):
            img = image_ops.enhance(img, name, 1.0 + sign * 0.9 * frac)
        elif name in ("shear_x", "shear_y"):
            s = sign * 0.3 * frac
            img = image_ops.affine(img, (1, s, 0, 0, 1, 0) if name == "shear_x"
                                   else (1, 0, 0, s, 1, 0))
        else:                                   # translate_x / translate_y (relative, ±0.45)
            t = sign * 0.45 * frac
            dx = t * w if name == "translate_x" else 0
            dy = t * h if name == "translate_y" else 0
            img = image_ops.affine(img, (1, 0, dx, 0, 1, dy))
    return np.asarray(img, np.float32) / 255.0


def _random_erase(rng: np.random.Generator, x: np.ndarray, prob: float = 0.25,
                  scale=(0.02, 0.33), ratio=(0.3, 3.3)) -> np.ndarray:
    """timm's RandomErasing, 'pixel' mode, on the normalised image."""
    if rng.random() >= prob:
        return x
    h, w = x.shape[:2]
    area = h * w
    for _ in range(10):
        target = rng.uniform(*scale) * area
        ar = math.exp(rng.uniform(math.log(ratio[0]), math.log(ratio[1])))
        eh, ew = int(round(math.sqrt(target * ar))), int(round(math.sqrt(target / ar)))
        if eh < h and ew < w and eh > 0 and ew > 0:
            top = rng.integers(0, h - eh + 1)
            left = rng.integers(0, w - ew + 1)
            x = x.copy()
            x[top:top + eh, left:left + ew] = rng.standard_normal(
                (eh, ew, x.shape[2])).astype(np.float32)
            return x
    return x


class FinetuneDataset:
    """Train: RRC(0.08-1) + hflip → RandAugment → normalise → RandomErasing;
    eval: resize → normalise.  Yields {'image' HWC float32, 'label_id'}."""

    def __init__(self, base, size: int, train: bool, seed: int = 0, reprob: float = 0.25,
                 randaug: bool = True):
        self.base, self.size, self.train = base, size, train
        self.seed, self.reprob, self.randaug = seed, reprob, randaug
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch

    def __len__(self):
        return len(self.base)

    def __getitem__(self, i):
        item = self.base[i]
        img = (np.asarray(item["image"], np.float32) + 1.0) / 2.0
        if self.train:
            rng = np.random.default_rng((self.seed, self._epoch, i))
            img = random_resized_crop(rng, img, self.size, scale=(0.08, 1.0))
            if self.randaug:
                img = _rand_augment(rng, img)
            img = (img - IMAGENET_MEAN) / IMAGENET_STD
            img = _random_erase(rng, img, prob=self.reprob)
        else:
            img = (_resize_np(img, self.size) - IMAGENET_MEAN) / IMAGENET_STD
        lab = item.get("label_id")
        if lab is None:
            lab = int(np.argmax(item["label"]))
        return {"image": np.ascontiguousarray(img, np.float32), "label_id": np.int32(lab)}


# ----------------------------------------------------------------------
# train / eval steps
# ----------------------------------------------------------------------

def make_finetune_train_step(model: ViTClassifier, tx, num_classes: int, *, mixup_alpha: float,
                             cutmix_alpha: float, smoothing: float, mixup_prob: float = 1.0,
                             switch_prob: float = 0.5):
    """``step(x, y, draws=None, generator=None) -> loss``: mixup / cutmix (or
    the smoothed targets), the soft CE of the classifier under drop-path, and
    ``tx``'s update in place (its state in ``step.opt_state``).  ``draws``:
    `draw_finetune`'s dict, else drawn from the CPU ``generator``."""
    params = list(model.parameters())
    holder = {"opt": tx.init(params)}
    mixup_on = mixup_alpha > 0 or cutmix_alpha > 0

    def step(x, y, draws=None, generator=None):
        if draws is None:
            draws = draw_finetune(generator, mixup_alpha=mixup_alpha, cutmix_alpha=cutmix_alpha,
                                  prob=mixup_prob, switch_prob=switch_prob, height=x.shape[-2],
                                  width=x.shape[-1], model=model.encoder, batch=x.shape[0],
                                  device=x.device)
        if mixup_on:
            x, targets = apply_mixup(x, y, num_classes, draws, mixup_alpha=mixup_alpha,
                                     cutmix_alpha=cutmix_alpha, smoothing=smoothing)
        else:
            targets = _smooth_onehot(y, num_classes, smoothing)
        loss = soft_target_ce(model(x, drop_masks=draws.get("drop_masks")), targets)
        grads = grads_of(loss, params)
        updates, holder["opt"] = tx.update(list(grads), holder["opt"], params)
        apply_updates(params, updates)
        return loss.detach()

    step.opt_state = holder
    return step


def make_finetune_eval_step(model: ViTClassifier):
    """``step(x, y) -> (loss, top1, top5)``: the deterministic network's mean
    CE and accuracies (top-k over min(5, classes))."""

    @torch.no_grad()
    def step(x, y):
        logits = model(x)
        y = y.long()
        loss = F.cross_entropy(logits, y)
        top1 = (logits.argmax(-1) == y).float().mean()
        top5 = (logits.topk(min(5, logits.shape[-1]), dim=-1).indices == y[:, None]).any(-1)
        return loss, top1, top5.float().mean()

    return step


# ----------------------------------------------------------------------
# checkpoints and the training loop
# ----------------------------------------------------------------------

def save_classifier(path: str | Path, model: ViTClassifier) -> None:
    """The classifier's weights in the JAX `ViTClassifier` layout, as flax's
    msgpack bytes."""
    Path(path).write_bytes(pack_params(vit_to_flax(model.state_dict())))


def load_classifier(path: str | Path, model: ViTClassifier) -> ViTClassifier:
    """`save_classifier`'s file (or the JAX trainer's ``finetuned.msgpack``) into ``model``."""
    model.load_state_dict(vit_from_flax(unpack_params(Path(path).read_bytes()), model))
    return model


def build_model(args) -> ViTClassifier:
    encoder = VisionTransformer(patch_size=args.patch_size, embed_dim=args.embed_dim,
                                depth=args.depth, num_heads=args.num_heads,
                                pretrain_img_size=args.input_size, drop_path_rate=args.drop_path)
    return ViTClassifier(encoder, args.nb_classes, global_pool=not args.cls_token)


def train_finetune(args) -> Path:
    dev = resolve_device(args.device)
    base_train = build_dataset(args.ds, args.input_size, args.n_train, args.data_root)
    base_val = build_dataset(args.ds, args.input_size, args.n_val, args.data_root)
    ds_train = FinetuneDataset(base_train, args.input_size, train=True, seed=args.seed,
                               reprob=args.reprob, randaug=not args.no_randaug)
    ds_val = FinetuneDataset(base_val, args.input_size, train=False)

    model = init_classifier_(build_model(args), torch.Generator().manual_seed(args.seed))
    if args.finetune:
        # the head and fc_norm stay freshly initialised; the encoder resamples
        # its position embedding at apply time
        model.encoder.load_state_dict(load_encoder_ckpt(args.finetune, model.encoder))
        logger.info(f"loaded pretrained encoder from {args.finetune}")
    model.to(dev)

    steps_per_epoch = max(len(ds_train) // args.batch_size, 1)
    lr = args.lr if args.lr is not None else args.blr * args.batch_size / 256.0
    sched = mae_lr_schedule(lr, args.min_lr, args.warmup_epochs, args.epochs, steps_per_epoch)
    tx = make_finetune_tx(model, sched, weight_decay=args.weight_decay,
                          layer_decay=args.layer_decay, depth=args.depth,
                          clip_grad=args.clip_grad)
    train_step = make_finetune_train_step(model, tx, args.nb_classes, mixup_alpha=args.mixup,
                                          cutmix_alpha=args.cutmix, smoothing=args.smoothing)
    eval_step = make_finetune_eval_step(model)

    out_dir = Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    gen = torch.Generator().manual_seed(args.seed)
    best_acc, step_i = 0.0, 0
    with no_tf32():
        for epoch in range(args.epochs):
            ds_train.set_epoch(epoch)
            dl = DataLoader(ds_train, batch_size=args.batch_size, shuffle=True, drop_last=True,
                            seed=args.seed + epoch, num_workers=args.workers)
            losses = []
            for batch in dl:
                loss = train_step(to_nchw(batch["image"], dev),
                                  torch.from_numpy(batch["label_id"]).to(dev), generator=gen)
                losses.append(loss)
                step_i += 1
            stats = []
            dl_val = DataLoader(ds_val, batch_size=args.batch_size, shuffle=False,
                                drop_last=False, num_workers=args.workers)
            for batch in dl_val:
                lo, t1, t5 = eval_step(to_nchw(batch["image"], dev),
                                       torch.from_numpy(batch["label_id"]).to(dev))
                stats.append((float(lo), float(t1), float(t5), len(batch["label_id"])))
            n = sum(s[3] for s in stats)
            acc1 = sum(s[1] * s[3] for s in stats) / n
            acc5 = sum(s[2] * s[3] for s in stats) / n
            train_loss = float(torch.stack(losses).mean()) if losses else float("nan")
            logger.info(f"epoch {epoch}: train_loss {train_loss:.4f} val acc1 {acc1:.4f} "
                        f"acc5 {acc5:.4f} lr {sched(step_i):.2e}")
            if acc1 >= best_acc:
                best_acc = acc1
                save_classifier(out_dir / "finetuned.msgpack", model)
                save_encoder_ckpt(out_dir / "finetuned_encoder.msgpack",
                                  model.encoder.state_dict(),
                                  meta={"arch": "vit", "patch_size": args.patch_size,
                                        "embed_dim": args.embed_dim, "depth": args.depth,
                                        "num_heads": args.num_heads,
                                        "pretrain_img_size": args.input_size,
                                        "method": "mae_finetune"})
    logger.info(f"best val acc1 {best_acc:.4f}")
    return out_dir / "finetuned.msgpack"


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("MAE fine-tuning")
    p.add_argument("--ds", default="synthetic")
    p.add_argument("--data_root", default="data", help="cifar10 / in32p root")
    p.add_argument("--n_train", type=int, default=512)
    p.add_argument("--n_val", type=int, default=128)
    p.add_argument("--nb_classes", type=int, default=10)
    p.add_argument("--input_size", type=int, default=32)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--epochs", type=int, default=50)
    p.add_argument("--patch_size", type=int, default=8)
    p.add_argument("--embed_dim", type=int, default=192)
    p.add_argument("--depth", type=int, default=6)
    p.add_argument("--num_heads", type=int, default=3)
    p.add_argument("--drop_path", type=float, default=0.1)
    p.add_argument("--clip_grad", type=float, default=None)
    p.add_argument("--weight_decay", type=float, default=0.05)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--blr", type=float, default=1e-3)
    p.add_argument("--layer_decay", type=float, default=0.75)
    p.add_argument("--min_lr", type=float, default=1e-6)
    p.add_argument("--warmup_epochs", type=float, default=5)
    p.add_argument("--smoothing", type=float, default=0.1)
    p.add_argument("--mixup", type=float, default=0.0)
    p.add_argument("--cutmix", type=float, default=0.0)
    p.add_argument("--reprob", type=float, default=0.25)
    p.add_argument("--no_randaug", action="store_true")
    p.add_argument("--finetune", default="",
                   help="pretrained encoder .msgpack (mae_train / msn_train export)")
    p.add_argument("--cls_token", action="store_true",
                   help="CLS head instead of global average pool")
    p.add_argument("--output_dir", default="./output_finetune")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--workers", type=int, default=8, help="loader threads")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def main(argv=None) -> Path:
    return train_finetune(build_argparser().parse_args(argv))


if __name__ == "__main__":
    main()

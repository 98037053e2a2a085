"""The Wide-ResNet validator of the downsampled-ImageNet pickles.

Port of `sgdm_tpu/data/wrn_validate.py`: a pre-activation Wide-ResNet
classifier trained on the ``train_data_batch_1..10`` / ``val_data`` pickles
(`data/imagenet_pickle.py` reads the same files) to check a freshly packed
dataset, reporting top-1 / top-5 as the downsampled-ImageNet paper does.

The quirks of the Lasagne recipe, kept as the JAX package keeps them:

  * the stem and each block's conv_1 are conv → BN → ReLU with the conv's
    bias removed; conv_2 keeps its bias;
  * the first block of stack 1 has no pre-activation and a 1×1
    projection; ``increase_dim`` blocks stride both conv_1 and a bias-free
    1×1 projection taken from the RAW input, not the pre-activation;
  * stacks: a 16-wide stem, then n blocks each at 16k / 32k (+64k at ≥ 32
    px, +128k at ≥ 64 px);
  * data: x / 255 less the TRAIN mean image (val too), every train batch
    doubled by its horizontal flip, pad-4 random crops;
  * SGD momentum 0.9 (v ← m·v − lr·g, p ← p + v), L2 ``reg_fac`` on the
    conv / dense kernels only, the LR × ``lr_fac`` at epochs E1 / E2 / E3;
    batch 128, val batch 500;
  * resuming (``-c``) restores params, BN statistics, velocity and epoch
    and replays the LR drops.

Convolutions pad as flax's "SAME" (a stride-2 3×3 conv pads one row and
column after, none before); BN is flax's (batch statistics with the
biased variance, running averages at momentum 0.9, eps 1e-4).  The
checkpoint is the JAX package's pickle: ``params`` / ``batch_stats`` /
``velocity`` as nested dicts of numpy arrays under flax's names and
layouts (HWIO kernels), and ``epoch`` (`wrn_to_flax`,
`models/convert.py wrn_from_flax`); either package resumes the other's.
Augmentation draws from the same ``np.random.RandomState(seed)`` as the
JAX package; dropout (off by default) from a `torch.Generator`.
"""

from __future__ import annotations

import pickle
import time
from argparse import ArgumentParser
from pathlib import Path
from typing import Mapping, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import no_tf32, resolve_device
from ..utils.logging import logger

__all__ = ["WideResNet", "train_wrn", "main", "load_databatch", "load_validation_data",
           "iterate_minibatches", "make_wrn_steps", "wrn_to_flax"]


def _he_normal(shape, fan_in: int, gain: float, gen: torch.Generator) -> torch.Tensor:
    # flax's variance_scaling(gain, "fan_in", "normal"): a truncated normal
    std = (gain / fan_in) ** 0.5 / 0.87962566103423978
    return torch.nn.init.trunc_normal_(torch.empty(shape), std=1.0, a=-2.0, b=2.0,
                                       generator=gen) * std


class _Conv(nn.Module):
    """A square conv padded as flax's "SAME"."""

    def __init__(self, cin: int, cout: int, k: int = 3, stride: int = 1, bias: bool = True):
        super().__init__()
        self.k, self.stride = k, stride
        self.weight = nn.Parameter(torch.zeros(cout, cin, k, k))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    def forward(self, x):
        size = x.shape[-1]
        out = -(-size // self.stride)
        total = max((out - 1) * self.stride + self.k - size, 0)
        lo = total // 2
        x = F.pad(x, (lo, total - lo, lo, total - lo))
        return F.conv2d(x, self.weight, self.bias, stride=self.stride)


class _BN(nn.Module):
    """Flax's BatchNorm (momentum 0.9, eps 1e-4) under the name ``bn``."""

    def __init__(self, c: int):
        super().__init__()
        self.bn = _FlaxBatchNorm(c)

    def forward(self, x):
        return self.bn(x)


class _FlaxBatchNorm(nn.Module):
    def __init__(self, c: int, momentum: float = 0.9, eps: float = 1e-4):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("mean", torch.zeros(c))
        self.register_buffer("var", torch.ones(c))

    def forward(self, x):
        if self.training:
            mean = x.mean((0, 2, 3))
            var = (x.square().mean((0, 2, 3)) - mean.square()).clamp_min(0.0)
            with torch.no_grad():
                self.mean.mul_(self.momentum).add_((1 - self.momentum) * mean)
                self.var.mul_(self.momentum).add_((1 - self.momentum) * var)
        else:
            mean, var = self.mean, self.var
        scale = self.weight * torch.rsqrt(var + self.eps)
        return x * scale[:, None, None] + (self.bias - mean * scale)[:, None, None]


class _Dropout(nn.Module):
    def __init__(self, p: float):
        super().__init__()
        self.p = p
        self.generator: torch.Generator | None = None

    def forward(self, x):
        if not self.training or self.p <= 0:
            return x
        keep = torch.rand(x.shape, generator=self.generator, device=x.device) >= self.p
        return torch.where(keep, x / (1.0 - self.p), torch.zeros_like(x))


class ResidualBlock(nn.Module):
    def __init__(self, cin: int, filters: int, first: bool = False, increase_dim: bool = False,
                 dropout: float = 0.0):
        super().__init__()
        self.first, self.increase_dim = first, increase_dim
        stride = 2 if increase_dim else 1
        if not first:
            self.bn_pre = _BN(cin)
        self.conv1 = _Conv(cin, filters, 3, stride, bias=False)
        self.bn1 = _BN(filters)
        self.drop = _Dropout(dropout)
        self.conv2 = _Conv(filters, filters, 3, 1, bias=True)
        if increase_dim:
            self.proj = _Conv(cin, filters, 1, 2, bias=False)
        elif first:
            self.proj = _Conv(cin, filters, 1, 1, bias=False)

    def forward(self, x):
        pre = x if self.first else F.relu(self.bn_pre(x))
        h = F.relu(self.bn1(self.conv1(pre)))
        h = self.conv2(self.drop(h))
        sc = self.proj(x) if (self.increase_dim or self.first) else x
        return h + sc


class WideResNet(nn.Module):
    """ResNet_FullPre_Wide: ``forward(x [B, H, W, 3])`` → logits [B, nout]."""

    def __init__(self, nout: int = 1000, n: int = 4, k: float = 1.0, dropout: float = 0.0,
                 img_size: int = 32, seed: int = 0):
        super().__init__()
        widths = [int(16 * k), int(32 * k)]
        if img_size >= 32:
            widths.append(int(64 * k))
        if img_size >= 64:
            widths.append(int(128 * k))
        self.stem = _Conv(3, 16, 3, 1, bias=False)
        self.bn_stem = _BN(16)
        self.blocks = []
        cin = 16
        for s, w in enumerate(widths):
            for b in range(n):
                blk = ResidualBlock(cin, w, first=(s == 0 and b == 0),
                                    increase_dim=(s > 0 and b == 0), dropout=dropout)
                self.add_module(f"stack{s}_block{b}", blk)
                self.blocks.append(blk)
                cin = w
        self.bn_post = _BN(cin)
        self.fc = nn.Linear(cin, nout)
        gen = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, _Conv):
                    fan_in = m.weight.shape[1] * m.k * m.k
                    m.weight.copy_(_he_normal(m.weight.shape, fan_in, 2.0, gen))
            self.fc.weight.copy_(_he_normal(self.fc.weight.shape, cin, 1.0, gen))
            self.fc.bias.zero_()

    def set_dropout_generator(self, gen: torch.Generator | None) -> None:
        for m in self.modules():
            if isinstance(m, _Dropout):
                m.generator = gen

    def forward(self, x):
        h = x.permute(0, 3, 1, 2)
        h = F.relu(self.bn_stem(self.stem(h)))
        for blk in self.blocks:
            h = blk(h)
        h = F.relu(self.bn_post(h)).mean((2, 3))
        return self.fc(h)


# ---------------------------------------------------------------------------
# flax names (the checkpoint)
# ---------------------------------------------------------------------------

def _kernel_names(model: WideResNet) -> set[str]:
    return {f"{name}.weight" for name, m in model.named_modules()
            if isinstance(m, (_Conv, nn.Linear))}


def _leaf_to_flax(key: str, t: torch.Tensor, kernels: set[str]) -> tuple[list[str], np.ndarray]:
    parts = key.split(".")
    arr = t.detach().cpu().float().numpy()
    if key in kernels:
        arr = arr.transpose(2, 3, 1, 0) if arr.ndim == 4 else arr.T
        return parts[:-1] + ["kernel"], np.ascontiguousarray(arr)
    return parts[:-1] + [{"weight": "scale"}.get(parts[-1], parts[-1])], arr


def _nest(flat: Mapping[tuple, np.ndarray]) -> dict:
    out: dict = {}
    for parts, v in flat.items():
        node = out
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


def wrn_to_flax(model: WideResNet, velocity: Mapping[str, torch.Tensor] | None = None) -> dict:
    """{"params", "batch_stats"[, "velocity"]} as the JAX package's pickle
    holds them: nested dicts of numpy arrays, flax names, HWIO kernels."""
    kernels = _kernel_names(model)
    params, stats, vel = {}, {}, {}
    for key, t in model.state_dict().items():
        parts, arr = _leaf_to_flax(key, t, kernels)
        (stats if parts[-1] in ("mean", "var") else params)[tuple(parts)] = arr
    if velocity is not None:
        for key, t in velocity.items():
            parts, arr = _leaf_to_flax(key, t, kernels)
            vel[tuple(parts)] = arr
    out = {"params": _nest(params), "batch_stats": _nest(stats)}
    if velocity is not None:
        out["velocity"] = _nest(vel)
    return out


# ---------------------------------------------------------------------------
# data (as the JAX package: NHWC float32)
# ---------------------------------------------------------------------------

def _planar_to_nhwc(x: np.ndarray, img_size: int) -> np.ndarray:
    s2 = img_size * img_size
    x = np.dstack((x[:, :s2], x[:, s2:2 * s2], x[:, 2 * s2:]))
    return x.reshape(x.shape[0], img_size, img_size, 3)


def load_databatch(folder: str | Path, idx: int, img_size: int = 32) -> dict:
    with open(Path(folder) / f"train_data_batch_{idx}", "rb") as f:
        d = pickle.load(f)
    x = d["data"] / np.float32(255)
    mean = d["mean"] / np.float32(255)
    y = np.asarray([i - 1 for i in d["labels"]], np.int32)
    x -= mean
    x = _planar_to_nhwc(x, img_size)
    x = np.concatenate([x, x[:, :, ::-1, :]], axis=0)   # the mirrored doubling
    y = np.concatenate([y, y], axis=0)
    return {"X": x.astype(np.float32), "Y": y, "mean": mean}


def load_validation_data(folder: str | Path, mean: np.ndarray, img_size: int = 32) -> dict:
    with open(Path(folder) / "val_data", "rb") as f:
        d = pickle.load(f)
    x = d["data"] / np.float32(255) - mean
    y = np.asarray([i - 1 for i in d["labels"]], np.int32)
    return {"X": _planar_to_nhwc(x, img_size).astype(np.float32), "Y": y}


def iterate_minibatches(x, y, bs, rng: np.random.RandomState | None = None,
                        augment: bool = False, img_size: int = 32):
    """Shuffle and pad-4 random-crop augmentation."""
    idx = np.arange(len(x))
    if rng is not None:
        rng.shuffle(idx)
    for s in range(0, len(x) - bs + 1, bs):
        sel = idx[s:s + bs]
        xb = x[sel]
        if augment:
            padded = np.pad(xb, ((0, 0), (4, 4), (4, 4), (0, 0)))
            crops = rng.randint(0, 9, size=(bs, 2))
            xb = np.stack([padded[i, r:r + img_size, c:c + img_size]
                           for i, (r, c) in enumerate(crops)])
        yield xb, y[sel]


# ---------------------------------------------------------------------------
# train / eval steps
# ---------------------------------------------------------------------------

def make_wrn_steps(model: WideResNet, reg_fac: float, momentum: float = 0.9):
    """(train_step(velocity, xb, yb, lr) → ce, eval_step(xb, yb) → (ce,
    top1, top5)); the train step updates ``model`` and ``velocity`` (torch
    names → tensors) in place."""
    kernels = [p for name, p in model.named_parameters() if name in _kernel_names(model)]
    params = list(model.parameters())
    names = [n for n, _ in model.named_parameters()]

    def train_step(velocity: dict, xb: torch.Tensor, yb: torch.Tensor, lr: float):
        model.train()
        out = model(xb).float()
        ce = F.cross_entropy(out, yb.long())
        loss = ce + reg_fac * sum(k.square().sum() for k in kernels)
        grads = torch.autograd.grad(loss, params)
        with torch.no_grad():
            for name, p, g in zip(names, params, grads):
                v = velocity[name]
                v.mul_(momentum).sub_(lr * g)
                p.add_(v)
        return ce.detach()

    @torch.no_grad()
    def eval_step(xb: torch.Tensor, yb: torch.Tensor):
        model.eval()
        out = model(xb).float()
        yb = yb.long()
        ce = F.cross_entropy(out, yb)
        top1 = (out.argmax(-1) == yb).float().mean()
        top5 = (out.topk(min(5, out.shape[-1]), -1).indices == yb[:, None]).any(-1).float().mean()
        return ce, top1, top5

    return train_step, eval_step


def _evaluate(eval_step, X, Y, dev, bs: int = 500):
    errs, a1, a5, nb = 0.0, 0.0, 0.0, 0
    for xb, yb in iterate_minibatches(X, Y, min(bs, len(X))):
        e, t1, t5 = eval_step(torch.as_tensor(xb, device=dev), torch.as_tensor(yb, device=dev))
        errs += float(e)
        a1 += float(t1)
        a5 += float(t5)
        nb += 1
    return errs / nb, a1 / nb, a5 / nb


def _load_checkpoint(model: WideResNet, path: str, dev) -> tuple[dict, int]:
    from ..models.convert import wrn_from_flax

    with open(path, "rb") as f:
        net = pickle.load(f)
    model.load_state_dict(wrn_from_flax(net["params"], net["batch_stats"], model))
    vel = wrn_from_flax(net["velocity"], None)
    return {k: v.to(dev) for k, v in vel.items()}, int(net["epoch"])


def train_wrn(data_folder: str, img_size: int = 32, n: int = 4, k: float = 1.0,
              num_epochs: int = 40, lr: float = 0.01, lr_fac: float = 0.2,
              lr_drops: Sequence[int] = (10, 20, 30), reg_fac: float = 5e-4,
              dropout: float = 0.0, batch_size: int = 128, nout: int = 1000,
              num_train_batches: int = 10, cont: str | None = None,
              ckpt_path: str | None = None, seed: int = 23, val_batch_size: int = 500,
              device: str | torch.device = "cuda", report=None) -> dict:
    """Returns the final test metrics (loss / top1 / top5) and the model.
    ``report(record)``, when given, sees each epoch's record (with its
    train steps' seconds)."""
    dev = resolve_device(device)
    model = WideResNet(nout=nout, n=n, k=k, dropout=dropout, img_size=img_size,
                       seed=seed).to(dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    model.set_dropout_generator(gen)
    first = load_databatch(data_folder, 1, img_size)
    val = load_validation_data(data_folder, first["mean"], img_size)
    velocity = {name: torch.zeros_like(p) for name, p in model.named_parameters()}
    n_params = sum(p.numel() for p in model.parameters())
    logger.info("WRN n=%d k=%g img=%d: %.2fM params", n, k, img_size, n_params / 1e6)

    train_step, eval_step = make_wrn_steps(model, reg_fac)
    start_epoch, cur_lr = 0, lr
    if cont:
        velocity, start_epoch = _load_checkpoint(model, cont, dev)
        for e in range(start_epoch):    # replay the LR schedule
            if (e + 1) in lr_drops:
                cur_lr *= lr_fac
        logger.info("resumed %s at epoch %d (lr %g)", cont, start_epoch, cur_lr)

    rng = np.random.RandomState(seed)
    t0 = time.time()
    with no_tf32():
        for epoch in range(start_epoch, num_epochs):
            t_ep = time.time()
            tr_err, steps = 0.0, []
            for ib in range(1, num_train_batches + 1):
                if ib == 1 and epoch == start_epoch and first is not None:
                    data, first = first, None    # the flip-doubled copy, once
                else:
                    data = load_databatch(data_folder, ib, img_size)
                for xb, yb in iterate_minibatches(data["X"], data["Y"], batch_size, rng,
                                                  augment=True, img_size=img_size):
                    ts = time.perf_counter()
                    ce = train_step(velocity, torch.as_tensor(xb, device=dev),
                                    torch.as_tensor(yb, device=dev), cur_lr)
                    tr_err += float(ce)
                    steps.append(time.perf_counter() - ts)
            v_err, v1, v5 = _evaluate(eval_step, val["X"], val["Y"], dev, val_batch_size)
            logger.info("epoch %d/%d (%.1fs, lr %g): train loss %.4f | val loss %.4f "
                        "top1 %.2f%% top5 %.2f%%", epoch + 1, num_epochs, time.time() - t_ep,
                        cur_lr, tr_err / max(len(steps), 1), v_err, v1 * 100, v5 * 100)
            if report is not None:
                report(dict(epoch=epoch + 1, lr=cur_lr, train_loss=tr_err / max(len(steps), 1),
                            val_loss=v_err, top1=v1, top5=v5, step_seconds=steps))
            if ckpt_path:
                net = dict(wrn_to_flax(model, velocity), epoch=epoch + 1)
                with open(ckpt_path, "wb") as f:
                    pickle.dump(net, f)
            if (epoch + 1) in lr_drops:
                cur_lr *= lr_fac
                logger.info("new LR: %g", cur_lr)

        t_err, t1, t5 = _evaluate(eval_step, val["X"], val["Y"], dev, val_batch_size)
    logger.info("final (%.1fs total): test loss %.4f | top1 %.2f%% | top5 %.2f%%",
                time.time() - t0, t_err, t1 * 100, t5 * 100)
    return {"loss": t_err, "top1": t1, "top5": t5, "model": model}


def main(argv: list[str] | None = None) -> dict:
    p = ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("-df", "--data_folder", required=True)
    p.add_argument("-s", "--img_size", type=int, default=32)
    p.add_argument("-lr", "--learning_rate", type=float, default=0.01)
    p.add_argument("-k", "--network_width", type=float, default=1)
    p.add_argument("-n", "--blocks_per_stack", type=int, default=4)
    p.add_argument("-d", "--decay", type=float, default=5e-4)
    p.add_argument("-e", "--epochs", type=int, default=40)
    p.add_argument("-c", "--cont", default=None, help="checkpoint pickle to resume from")
    p.add_argument("--ckpt", default="wrn_last.p", help="rolling checkpoint path ('' disables)")
    p.add_argument("--batch-size", type=int, default=128)
    p.add_argument("--nout", type=int, default=1000)
    p.add_argument("--num-train-batches", type=int, default=10)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    a = p.parse_args(argv)
    return train_wrn(a.data_folder, img_size=a.img_size, n=a.blocks_per_stack,
                     k=a.network_width, num_epochs=a.epochs, lr=a.learning_rate,
                     reg_fac=a.decay, batch_size=a.batch_size, nout=a.nout,
                     num_train_batches=a.num_train_batches, cont=a.cont,
                     ckpt_path=a.ckpt or None, device=a.device)


if __name__ == "__main__":
    main()

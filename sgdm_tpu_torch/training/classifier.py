"""Noisy-latent classifier trainer (classifier guidance).

Port of `sgdm_tpu/training/classifier.py`: trains an `EncoderUNetModel` to
classify q-sampled noisy images at random timesteps:

  * per batch t ~ U[0, T) and x_noisy = q_sample(x, t, noise) on the frozen
    diffusion schedule; t and the noise come from a `torch.Generator`, or
    are handed in (``draws``: the JAX step's own draws, for the tests);
  * cross-entropy on the class logits;
  * the plain optax-order ``adamw(lr, weight_decay)`` at a constant lr
    (`training.optim`, no EMA: the JAX classifier calls ``optax.adamw``, so
    the fused AdamW+EMA kernel is not on this path);
  * top-1 / top-5 accuracy (`compute_top_k`) and the per-noise-level
    accuracy table after every epoch (`noise_accuracy_table`: acc@1 at
    every ``T // log_steps``-th timestep of the val set, one noise draw
    for every call, as the JAX table's fixed key).

The parameters live in one flat f32 buffer that the model's parameters
are views of; a step updates it in place.  The encoder's attention takes
K9 on f32 operands where the flash gate passes (`models/encoder_unet.py`).

CLI, on the card unless ``--device cpu``:

    python -m sgdm_tpu_torch.training.classifier --ds synthetic --out C.msgpack
    python -m sgdm_tpu_torch.training.classifier --arch full --channels 128 \\
        --image-size 64 --num-classes 1000 --batch-size 128

``--arch small`` (default) is the JAX CLI's network (one res block a
level, channel_mult (1, 2), attention at ds 2, 4 heads); ``--arch full``
is `EncoderUNetModel`'s defaults (two res blocks a level, channel_mult
(1, 2, 4), attention at ds 4, 8 heads) at ``--channels``.  The checkpoint
is the bytes of the JAX CLI's ``flax.serialization.to_bytes(params)``
(`utils/msgpack.py`), so either package reads the other's
(`load_checkpoint`).  One JSON line per logged step and per epoch's table.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from pathlib import Path
from typing import Any, Callable, Mapping

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..diffusion.schedule import DiffusionSchedule, q_sample
from ..models.convert import from_flax, to_flax
from ..models.encoder_unet import EncoderUNetModel
from ..models.factory import init_train_params
from .optim import OptState, Optimizer, create_optimizer
from ..utils import msgpack

__all__ = ["compute_top_k", "ClassifierState", "create_classifier_state",
           "make_classifier_train_step", "make_classifier_eval_step", "timestep_grid",
           "noise_accuracy_table",
           "build_model", "save_checkpoint", "load_checkpoint", "train_classifier",
           "build_argparser", "main"]

ARCH = {"small": dict(num_res_blocks=1, channel_mult=(1, 2), attention_resolutions=(2,),
                      num_heads=4),
        "full": dict(num_res_blocks=2, channel_mult=(1, 2, 4), attention_resolutions=(4,),
                     num_heads=8)}


def compute_top_k(logits: np.ndarray, labels: np.ndarray, k: int) -> float:
    """Share of rows whose label is among the k largest logits."""
    top = np.argsort(-np.asarray(logits), axis=1)[:, :k]
    return float((top == np.asarray(labels)[:, None]).any(axis=1).mean())


@dataclasses.dataclass
class ClassifierState:
    """The flat f32 parameters (the model's parameters are views of them),
    the optimizer state, and the layout: (name, shape) per parameter."""

    params: torch.Tensor
    opt: OptState
    layout: tuple


def create_classifier_state(model: EncoderUNetModel, tx: Optimizer, *,
                            device: str | torch.device = "cuda") -> ClassifierState:
    """A state from the model's current parameter values, which it then binds."""
    dev = resolve_device(device)
    named = list(model.named_parameters())
    flat = torch.cat([p.detach().reshape(-1).float() for _, p in named]).to(dev)
    model.to(dev)
    offset = 0
    for _, p in named:
        p.data = flat[offset:offset + p.numel()].view_as(p)
        offset += p.numel()
    return ClassifierState(flat, tx.init(flat), tuple((n, tuple(p.shape)) for n, p in named))


def _loss(model, sched, x, labels, t, noise, train):
    logits = model(q_sample(sched, x, t, noise), t, train=train)
    ce = -F.log_softmax(logits, dim=-1).gather(-1, labels[:, None]).squeeze(-1)
    return ce.mean(), logits


def _draw(sched, shape, dev, gen):
    t = torch.randint(0, sched.num_timesteps, (shape[0],), generator=gen, device=dev)
    return t, torch.randn(shape, generator=gen, device=dev)


def make_classifier_train_step(model: EncoderUNetModel, sched: DiffusionSchedule,
                               tx: Optimizer, *, device: str | torch.device = "cuda"):
    """``step(state, x, labels, gen=None, draws=None) -> (state, loss, logits)``:
    x [B, H, W, C] in [-1, 1], labels [B] ints; ``draws`` {"t", "noise"}
    replaces the generator's draws."""
    dev = resolve_device(device)
    params = list(model.parameters())

    def step(state: ClassifierState, x, labels, gen: torch.Generator | None = None,
             draws: Mapping[str, Any] | None = None):
        x = torch.as_tensor(x, dtype=torch.float32).to(dev)
        labels = torch.as_tensor(labels).long().to(dev)
        if draws is None:
            t, noise = _draw(sched, x.shape, dev, gen)
        else:
            t = torch.as_tensor(np.array(draws["t"])).long().to(dev)
            noise = torch.as_tensor(np.array(draws["noise"]), dtype=torch.float32).to(dev)
        for p in params:
            p.grad = None
        loss, logits = _loss(model, sched, x, labels, t, noise, True)
        loss.backward()
        grads = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1)
                           for p in params])
        updates, opt = tx.update(grads, state.opt, state.params)
        with torch.no_grad():
            state.params.add_(updates)
        return ClassifierState(state.params, opt, state.layout), loss.detach(), logits.detach()

    return step


def make_classifier_eval_step(model: EncoderUNetModel, sched: DiffusionSchedule, *,
                              device: str | torch.device = "cuda"):
    """``step(x, labels, t_fixed, gen=None, noise=None) -> (loss, logits)``
    without gradients; ``t_fixed`` [B] timesteps (one value for the
    per-noise accuracy table)."""
    dev = resolve_device(device)

    def step(x, labels, t_fixed, gen: torch.Generator | None = None, noise=None):
        x = torch.as_tensor(x, dtype=torch.float32).to(dev)
        labels = torch.as_tensor(labels).long().to(dev)
        t = torch.as_tensor(t_fixed).long().to(dev)
        if noise is None:
            noise = torch.randn(x.shape, generator=gen, device=dev)
        noise = torch.as_tensor(noise, dtype=torch.float32).to(dev)
        with torch.no_grad():
            return _loss(model, sched, x, labels, t, noise, False)

    return step


def timestep_grid(num_timesteps: int, log_steps: int) -> list[int]:
    """The timesteps of the accuracy table: every ``T // log_steps``-th."""
    return list(range(0, num_timesteps, max(num_timesteps // log_steps, 1)))


def noise_accuracy_table(eval_step: Callable, batches, num_timesteps: int, log_steps: int,
                         noise_fn: Callable) -> dict[int, float]:
    """acc@1 by timestep: the mean over ``batches`` (dicts with ``image``
    and one-hot ``label``) of each batch's top-1 share at every grid step;
    ``noise_fn(shape)`` gives the noise of each call."""
    grid = timestep_grid(num_timesteps, log_steps)
    acc: dict[int, list] = {t: [] for t in grid}
    for raw in batches:
        x = np.asarray(raw["image"], np.float32)
        labels = np.argmax(raw["label"], -1)
        for t in grid:
            _, logits = eval_step(x, labels, np.full((len(x),), t), noise=noise_fn(x.shape))
            acc[t].append(compute_top_k(logits.cpu().numpy(), labels, 1))
    return {t: float(np.mean(v)) for t, v in acc.items()}


def build_model(args) -> EncoderUNetModel:
    return EncoderUNetModel(num_classes=args.num_classes, model_channels=args.channels,
                            pool=args.pool, **ARCH[args.arch])


def init_params(model: EncoderUNetModel, seed: int) -> EncoderUNetModel:
    """The training init (`init_train_params`) and, as the JAX module's
    ``kernel_init=zeros``, the adaptive head's ``out`` kernel at zero."""
    with torch.no_grad():
        init_train_params(model, seed)
        if model.pool == "adaptive":
            model.out.weight.zero_()
    return model


def save_checkpoint(model: EncoderUNetModel, path: str | Path) -> Path:
    """The flax param tree of ``model`` as the JAX CLI's ``to_bytes`` writes it."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(msgpack.pack_params(to_flax(model.state_dict(), model)))
    return path


def load_checkpoint(model: EncoderUNetModel, path: str | Path) -> EncoderUNetModel:
    """Parameters from a checkpoint of either package (checked leaf for leaf)."""
    state = from_flax(msgpack.unpack_params(Path(path).read_bytes()), model)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(state[name])
    return model


def train_classifier(args, report: Callable[[dict], None] | None = None) -> Path:
    """The CLI's run; ``report`` gets every log record (default: printed as JSON)."""
    from ..data.loader import DataLoader
    from ..data.synthetic import SyntheticImages

    report = report or (lambda rec: print(json.dumps(rec), flush=True))
    dev = resolve_device(args.device)
    model = init_params(build_model(args), args.seed)
    sched = DiffusionSchedule.create(num_timesteps=args.num_timesteps)
    train_ds = SyntheticImages(size=args.image_size, length=args.data_len,
                               num_classes=args.num_classes, seed=0)
    val_ds = SyntheticImages(size=args.image_size, length=args.data_len // 4,
                             num_classes=args.num_classes, seed=1)
    dl = DataLoader(train_ds, batch_size=args.batch_size, shuffle=True,
                    num_workers=args.workers)
    val_dl = DataLoader(val_ds, batch_size=args.batch_size, shuffle=False,
                        num_workers=args.workers)
    tx = create_optimizer("adamw", lr=args.lr, wd=args.weight_decay, scheduler=None)
    state = create_classifier_state(model, tx, device=dev)
    train_step = make_classifier_train_step(model, sched, tx, device=dev)
    eval_step = make_classifier_eval_step(model, sched, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)

    def fixed_noise(shape):  # one draw for every call, as the JAX table's fixed key
        g = torch.Generator(device=dev)
        g.manual_seed(args.seed + 999)
        return torch.randn(shape, generator=g, device=dev)

    it = 0
    for epoch in range(args.epochs):
        dl.set_epoch(epoch)
        t0 = time.perf_counter()
        for raw in dl:
            labels = np.argmax(raw["label"], -1)
            state, loss, logits = train_step(state, raw["image"], labels, gen)
            if it % args.log_every == 0:
                report(dict(epoch=epoch, it=it, loss=loss.item(),
                            acc1=compute_top_k(logits.cpu().numpy(), labels, 1)))
            it += 1
        seconds = time.perf_counter() - t0
        table = noise_accuracy_table(eval_step, val_dl, sched.num_timesteps, args.log_steps,
                                     fixed_noise)
        report(dict(epoch=epoch, train_seconds=seconds, acc1_by_noise_level=table))
    out = save_checkpoint(model, args.out)
    report(dict(saved=str(out)))
    return out


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--ds", default="synthetic", choices=["synthetic"])
    p.add_argument("--num-classes", type=int, default=10)
    p.add_argument("--image-size", type=int, default=16)
    p.add_argument("--channels", type=int, default=32)
    p.add_argument("--arch", default="small", choices=sorted(ARCH))
    p.add_argument("--num-timesteps", type=int, default=100)
    p.add_argument("--pool", default="adaptive", choices=["adaptive", "spatial"])
    p.add_argument("--data-len", type=int, default=128)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--workers", type=int, default=4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--weight-decay", type=float, default=1e-2)
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--log-steps", type=int, default=10)
    p.add_argument("--out", default="outputs/noisy_classifier.msgpack")
    p.add_argument("--device", default="cuda")
    return p


def main(argv=None) -> Path:
    return train_classifier(build_argparser().parse_args(argv))


if __name__ == "__main__":
    main()

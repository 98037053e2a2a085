"""Training entry point: the fused training step of IN64 ``unet_fast`` or
of VOC64 ``unetca_fast``.

The port's counterpart of `bench.py` ``build`` + ``bench_train`` under
``--fused --fused-optim``, bf16 compute with f32 parameters, AdamW (lr
1e-4, weight decay 0.01, the lambda-linear warmup) fused with the EMA
(decay 0.9999) in one kernel, condition drop 0.1:

  * ``--family unet`` (default): `models.factory.UNET_FAST_IN64` with
    one-hot ``cluster`` conditions (cond_dim 1000), dropout 0.1, trained on
    `data.synthetic.SyntheticImages`;
  * ``--family unetca``: `models.factory.UNETCA_FAST_VOC64`
    (``stegoclusterlayout``: cond = ``stego_attr`` n-hot, layout =
    ``stegomask``, both ``cond_dim`` = 21 wide), dropout 0, trained on
    `data.synthetic.SyntheticSegImages` shipping uint8 id masks that become
    one-hot on the device.

    python -m sgdm_tpu_torch.train --batch-size 128 --steps 10
    python -m sgdm_tpu_torch.train --family unetca --batch-size 128 --steps 10
    python -m sgdm_tpu_torch.train --batch-size 2 --steps 2 --image-size 16 \\
        --model-channels 32 --cond-dim 10 --device cpu

Prints one JSON line per step (loss, grad_norm) and a last line with
seconds per step and samples/s over the steps after the first (which
builds the kernels).  Runs on the card unless ``--device cpu``; raises
without one.  Checkpoints, the trainer loop with validation and FID come
later.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Any

import torch

from .conditioning.condition import prepare_condition_kwargs
from .data.synthetic import SyntheticImages, SyntheticSegImages, collate
from .device import resolve_device
from .diffusion.core import GaussianDiffusion
from .models.factory import UNET_FAST_IN64, UNETCA_FAST_VOC64, create_denoiser, \
    init_random_params, init_train_params
from .training.optim import create_optimizer
from .training.state import create_train_state, make_train_step

__all__ = ["build", "make_batches", "main"]

CONDITION = {"unet": "cluster", "unetca": "stegoclusterlayout"}
COND_DIM = {"unet": 1000, "unetca": 21}
COND_DROP_PROB = 0.1


def build(batch_size: int, image_size: int = 64, cond_dim: int | None = None, *,
          family: str = "unet", model_channels: int = 128, init: str = "train", seed: int = 0,
          device: str | torch.device = "cuda") -> dict[str, Any]:
    """Model, diffusion, optimizer, train state and the fused train step.
    ``init``: "train" (flax's training init) or "random" (nonzero random
    weights everywhere, for the chip checks).  ``cond_dim`` defaults to the
    family's (1000 / 21); the CA family's layout is as deep."""
    dev = resolve_device(device)
    cond_dim = cond_dim or COND_DIM[family]
    if family == "unetca":
        cfg = dict(UNETCA_FAST_VOC64, image_size=image_size, cond_dim=cond_dim,
                   layout_dim=cond_dim, model_channels=model_channels)
    else:
        cfg = dict(UNET_FAST_IN64, image_size=image_size, cond_dim=cond_dim,
                   condition_method=CONDITION[family], model_channels=model_channels)
    model = create_denoiser(dtype=torch.bfloat16, **cfg)
    {"train": init_train_params, "random": init_random_params}[init](model, seed)
    diffusion = GaussianDiffusion(num_timesteps=1000)
    tx = create_optimizer("adamw", lr=1e-4, wd=0.01)
    state = create_train_state(model, tx, device=dev)
    step = make_train_step(model, diffusion, tx, cond_drop_prob=COND_DROP_PROB,
                           ema_decay=0.9999, fused_optim=True, device=dev)
    return dict(cfg=cfg, model=model, diffusion=diffusion, tx=tx, state=state, step=step,
                device=dev)


def make_batches(n: int, batch_size: int, image_size: int, cond_dim: int,
                 device: torch.device, seed: int = 0,
                 family: str = "unet") -> list[dict[str, torch.Tensor]]:
    """``n`` distinct batches of `SyntheticImages` (``unet``) or
    `SyntheticSegImages` (``unetca``: layouts as uint8 id masks), on ``device``."""
    method = CONDITION[family]
    if family == "unetca":
        data = SyntheticSegImages(size=image_size, num_classes=cond_dim - 1, stego_k=cond_dim,
                                  length=n * batch_size, seed=seed, onehot_on_device=True)
    else:
        data = SyntheticImages(size=image_size, num_classes=cond_dim, length=n * batch_size,
                               seed=seed, cond_key=method)
    out = []
    for j in range(n):
        raw = collate([data[j * batch_size + i] for i in range(batch_size)])
        kw = prepare_condition_kwargs(method, raw, cond_drop_prob=COND_DROP_PROB)
        batch = {"image": torch.as_tensor(raw["image"]).to(device),
                 "cond": torch.as_tensor(kw["cond"]).to(device)}
        if "layout" in kw:
            batch["layout"] = torch.as_tensor(kw["layout"]).to(device)
        out.append(batch)
    return out


def main(argv: list[str] | None = None) -> dict[str, Any]:
    ap = argparse.ArgumentParser(prog="sgdm_tpu_torch.train",
                                 description="Fused training steps of unet_fast or unetca_fast "
                                             "on synthetic data.")
    ap.add_argument("--family", choices=("unet", "unetca"), default="unet")
    ap.add_argument("--batch-size", type=int, default=128)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--image-size", type=int, default=64)
    ap.add_argument("--cond-dim", type=int, default=None, help="default: 1000 (unet), 21 (unetca)")
    ap.add_argument("--model-channels", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    run = build(a.batch_size, a.image_size, a.cond_dim, family=a.family,
                model_channels=a.model_channels, seed=a.seed, device=a.device)
    dev, state, step = run["device"], run["state"], run["step"]
    batches = make_batches(min(a.steps, 4), a.batch_size, a.image_size, run["cfg"]["cond_dim"],
                           dev, a.seed, a.family)
    t0 = None
    for i in range(a.steps):
        if i == 1:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
        state, metrics = step(state, batches[i % len(batches)], seed=a.seed)
        print(json.dumps({"step": state.step, "loss": float(metrics["loss"]),
                          "grad_norm": float(metrics["grad_norm"])}), flush=True)
    timed = a.steps - 1
    result: dict[str, Any] = {"steps": a.steps, "timed_steps": max(timed, 0),
                              "batch_size": a.batch_size, "device": str(dev)}
    if t0 is not None and timed > 0:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
        result.update(s_per_step=dt / timed, samples_per_s=a.batch_size * timed / dt)
    if dev.type == "cuda":
        result["card"] = torch.cuda.get_device_name(dev)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()

"""Serving entry point: guided DDIM samples from a concat-cond UNet.

Port of `sgdm_tpu/generate.py` for vector-conditioned methods.  The model
is described by a dict of ``configs/dynamic`` params (for example
`models.factory.UNET_FAST_IN64` plus ``cond_dim``); its weights come from a
flax param tree flattened to an ``.npz`` of ``/``-joined paths, or are
random, made from ``seed``, when none is given.

    python -m sgdm_tpu_torch.generate --params P.npz --cond-dim 1000 \
        --n 16 --steps 50 --cond-scale 2 --out samples/

Reading orbax checkpoints comes with the checkpoint slice.
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Any, Mapping

import numpy as np
import torch

from .device import resolve_device
from .diffusion.core import GaussianDiffusion
from .models.convert import from_flax
from .models.factory import UNET_FAST_IN64, create_denoiser, init_random_params
from .training.state import make_sample_fn

__all__ = ["generate", "main"]


def generate(
    model_cfg: Mapping[str, Any],
    params: Mapping[str, np.ndarray] | None = None,
    *,
    n: int = 16,
    batch_size: int | None = None,
    steps: int = 50,
    cond_scale: float = 2.0,
    labels: list[int] | None = None,
    seed: int = 0,
    device: str | torch.device = "cuda",
    out_dir: str | Path | None = None,
    dtype: torch.dtype = torch.bfloat16,
    scale_type: str = "imagen",
    model: torch.nn.Module | None = None,
) -> torch.Tensor:
    """Sample ``n`` images; returns uint8 [n, H, W, 3] on ``device``.

    ``params``: flattened flax tree (see `models.convert`); None draws
    random weights from ``seed``.  ``model`` skips building one from
    ``model_cfg`` (its weights are then used as they are).  Conditions are
    one-hot ids from ``labels`` (cycled) or drawn from ``seed``.  PNGs are
    written only when ``out_dir`` is given.
    """
    dev = resolve_device(device)
    if model is None:
        model = create_denoiser(dtype=dtype, **model_cfg)
        if params is None:
            init_random_params(model, seed)
        else:
            model.load_state_dict(from_flax(params, model))
    image_size = int(model_cfg.get("image_size", 64))
    channels = int(model_cfg.get("out_channels", 3))
    cond_dim = int(model_cfg.get("cond_dim") or 0)
    method = model_cfg.get("condition_method")
    if method in ("clusterlayout", "cluster_lookup"):
        raise NotImplementedError(f"generate() takes vector conditions, not {method!r}")
    sample = make_sample_fn(model, GaussianDiffusion(), num_steps=steps,
                            cond_scale=cond_scale, scale_type=scale_type, device=dev)
    generator = torch.Generator(device=dev)
    generator.manual_seed(seed)
    ids_rng = np.random.default_rng(seed)
    bs = min(batch_size or n, n)
    out = torch.empty((n, image_size, image_size, channels), dtype=torch.uint8, device=dev)
    all_ids = []
    made = 0
    while made < n:
        b = min(bs, n - made)
        cond = None
        if cond_dim:
            if labels:
                ids = np.asarray([labels[(made + j) % len(labels)] for j in range(b)])
                if (ids < 0).any() or (ids >= cond_dim).any():
                    raise ValueError(f"labels must be in [0,{cond_dim})")
            else:
                ids = ids_rng.integers(0, cond_dim, size=b)
            all_ids.extend(int(i) for i in ids)
            cond = torch.nn.functional.one_hot(
                torch.as_tensor(ids, device=dev), cond_dim).float()
        imgs, _ = sample(model, generator, b, image_size, channels, cond=cond)
        out[made:made + b] = imgs
        made += b
    if out_dir is not None:
        _write_pngs(out.cpu().numpy(), all_ids, Path(out_dir))
    return out


def _write_pngs(imgs: np.ndarray, ids: list[int], out: Path) -> list[Path]:
    from PIL import Image

    out.mkdir(parents=True, exist_ok=True)
    paths = []
    for j, img in enumerate(imgs):
        name = f"{j:06d}" + (f"_c{ids[j]}" if ids else "")
        p = out / f"{name}.png"
        Image.fromarray(img).save(p)
        paths.append(p)
    return paths


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(prog="sgdm_tpu_torch.generate",
                                 description="Guided DDIM samples from a unet_fast model.")
    ap.add_argument("--params", default=None,
                    help=".npz of the flax param tree with '/'-joined paths "
                         "(default: random weights from --seed)")
    ap.add_argument("--image-size", type=int, default=64)
    ap.add_argument("--cond-dim", type=int, default=0)
    ap.add_argument("--n", type=int, default=16)
    ap.add_argument("--batch-size", type=int, default=None)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--cond-scale", type=float, default=2.0)
    ap.add_argument("--labels", default=None,
                    help="comma-separated condition ids, cycled (default: random)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None, help="directory for PNGs (default: none written)")
    a = ap.parse_args(argv)
    cfg = dict(UNET_FAST_IN64, image_size=a.image_size, cond_dim=a.cond_dim or None)
    params = dict(np.load(a.params)) if a.params else None
    labels = [int(x) for x in a.labels.split(",")] if a.labels else None
    imgs = generate(cfg, params, n=a.n, batch_size=a.batch_size, steps=a.steps,
                    cond_scale=a.cond_scale, labels=labels, seed=a.seed,
                    device=a.device, out_dir=a.out)
    print(f"sampled {tuple(imgs.shape)} {imgs.dtype} on {imgs.device}")


if __name__ == "__main__":
    main()

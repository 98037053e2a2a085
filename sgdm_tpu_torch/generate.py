"""Serving entry point: guided samples from a UNet of either family.

Port of `sgdm_tpu/generate.py`.  The model is described by a dict of
``configs/dynamic`` params (`models.factory.UNET_FAST_IN64` plus
``cond_dim``, or `models.factory.UNETCA_FAST_VOC64`); its weights come from
a flax param tree flattened to an ``.npz`` of ``/``-joined paths, or are
random, made from ``seed``, when none is given.

    python -m sgdm_tpu_torch.generate --params P.npz --cond-dim 1000 \
        --n 16 --steps 50 --cond-scale 2 --out samples/
    python -m sgdm_tpu_torch.generate --sampler plms --n 16 --steps 50 --out samples/
    python -m sgdm_tpu_torch.generate --family unetca --mask-dir masks/ \
        --n 16 --steps 50 --out samples/
    python -m sgdm_tpu_torch.generate --run outputs/run1 --n 64 --steps 50 \
        --out samples/

``--sampler`` (``sampler=``) is any name of the sampler registry
(`diffusion.core.SAMPLER_REGISTRY`): ``native`` (ancestral, T model calls;
``--steps`` is not used), ``ddim``, ``plms``, ``pndm``, ``tero`` (EDM),
``vdm`` and ``ddim_continuous``; the last two need a diffusion on the
``sqrt_linear`` or ``cosine`` beta schedule, which comes from the run's
config or the ``diffusion=`` argument.

``--run DIR`` samples a training run of the port (`sgdm_tpu_torch.main`,
or a JAX run carried over by ``tools/jax_run_to_torch.py``): the model and
diffusion are built from the run's ``config.json`` as the trainer builds
them, ``--ckpt`` (``last``, ``best`` or a path) is resolved through
``ckpts/meta.json`` and restored, and the EMA is sampled unless
``--no-ema``; ``--cond-scale`` defaults to the run's own.  As the JAX
CLI's, ``--run`` samples 250 steps unless ``--steps`` says otherwise,
writes PNGs to ``samples/`` unless ``--out`` names another directory, and
samples at the run's ``data.image_size`` unless ``--image-size`` is given
(``--boxes`` are drawn at that size).  Without ``--run``, no ``--steps``
takes each sampler's own default and no PNG is written without ``--out``.

Conditions: vector methods take one-hot ids (``--labels``, cycled, or drawn
from the seed).  The layout methods take per-image layouts, cycled over the
batch like the labels:

  * ``--mask-dir DIR`` — id-pixel mask PNGs (STEGO outputs or ground-truth
    segmentation masks): the first ``n`` of them in name order, each decoded
    once (its stored samples, the first channel of a colour mask),
    nearest-resized to the sample size as PIL's ``Image.NEAREST`` does and
    one-hot encoded (255 is background 0; an id ≥ the model's layout_dim
    raises); ``stegoclusterlayout`` takes the n-hot of each mask's classes
    as its ``cond``;
  * ``--layout F`` — an ``.npy`` (or the first array of an ``.npz``) of
    integer id masks [K, H, W] (expanded to one-hot on the device) or of
    float one-hot / binary maps [K, H, W, C]; ``stegoclusterlayout`` derives
    its n-hot ``cond`` from the classes present in each layout;
  * ``--boxes "x0,y0,x1,y1[;…]"`` — boxes in sample-pixel coordinates →
    binary box masks [H, W, 1] for ``clusterlayout`` (ids via ``--labels``).

PNGs are written (and read back) by the standard library alone
(`write_png`, `read_png`, re-exported from `utils.png`): the machine with
the card has no PIL.  ``cluster_lookup`` is not sampled: it conditions on
dataset ids, and the JAX ``generate`` takes none either.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Any, Mapping

import numpy as np
import torch

from .conditioning.condition import LAYOUT_COND_METHODS, layout_to_device
from .device import resolve_device
from .data.transforms import bbox_to_mask, mask_to_attr_nhot, segmask_to_onehot
from .diffusion.core import SAMPLER_REGISTRY, GaussianDiffusion
from .models.convert import from_flax
from .models.factory import UNET_FAST_IN64, UNETCA_FAST_VOC64, create_denoiser, \
    init_random_params
from .training.state import make_sample_fn
from .utils.png import read_png, resize_nearest, write_png

__all__ = ["generate", "generate_from_run", "load_run", "boxes_to_layouts", "masks_to_layouts",
           "write_png", "read_png", "main"]


def boxes_to_layouts(boxes: str, image_size: int) -> np.ndarray:
    """``"x0,y0,x1,y1[;…]"`` → binary box masks, float32 [K, H, W, 1]."""
    out = []
    for spec in boxes.split(";"):
        b = np.asarray([float(v) for v in spec.split(",")])
        if b.shape != (4,):
            raise ValueError(f"bad box {spec!r}: want x0,y0,x1,y1")
        out.append(bbox_to_mask((image_size, image_size), b)[..., None].astype(np.float32))
    return np.stack(out)


def masks_to_layouts(mask_dir: str | Path, n: int, image_size: int, layout_dim: int,
                     attr_dim: int = 0) -> tuple[np.ndarray, np.ndarray | None]:
    """The layouts of ``--mask-dir`` (see the module docstring), cycled to
    ``n``: one-hot float32 [n, H, W, layout_dim] and, when ``attr_dim``,
    the n-hot [n, attr_dim] of each mask's classes."""
    paths = sorted(Path(mask_dir).glob("*.png"))
    if not paths:
        raise ValueError(f"no .png masks in {mask_dir}")
    if layout_dim <= 0:
        raise ValueError("id masks need the model's layout_dim")
    layouts, attrs = [], []
    for p in paths[:min(n, len(paths))]:
        m = read_png(p, samples=True)
        if m.shape[:2] != (image_size, image_size):
            m = resize_nearest(m, image_size, image_size)
        if m.ndim == 3:
            m = m[..., 0]
        ids = m[m != 255]  # 255 = the ignore label, background 0 after
        if ids.size and int(ids.max()) >= layout_dim:
            raise ValueError(f"{p.name}: mask id {int(ids.max())} >= layout_dim {layout_dim}")
        layouts.append(segmask_to_onehot(m, layout_dim))
        if attr_dim:
            attrs.append(mask_to_attr_nhot(m, attr_dim))
    cycle = np.arange(n) % len(layouts)
    return np.stack(layouts)[cycle], (np.stack(attrs)[cycle] if attrs else None)


def _attr_nhot(layout: torch.Tensor) -> torch.Tensor:
    """One-hot layouts [B, H, W, K] → n-hot [B, K] of the classes present."""
    return (layout.amax(dim=(1, 2)) > 0).float()


def generate(
    model_cfg: Mapping[str, Any],
    params: Mapping[str, np.ndarray] | None = None,
    *,
    n: int = 16,
    batch_size: int | None = None,
    sampler: str = "ddim",
    steps: int | None = 50,
    cond_scale: float = 2.0,
    image_size: int | None = None,
    labels: list[int] | None = None,
    cond: np.ndarray | torch.Tensor | None = None,
    layout: np.ndarray | torch.Tensor | None = None,
    mask_dir: str | Path | None = None,
    seed: int = 0,
    device: str | torch.device = "cuda",
    out_dir: str | Path | None = None,
    dtype: torch.dtype = torch.bfloat16,
    scale_type: str = "imagen",
    model: torch.nn.Module | None = None,
    diffusion: GaussianDiffusion | None = None,
) -> torch.Tensor:
    """Sample ``n`` images; returns uint8 [n, H, W, 3] on ``device``.

    ``params``: flattened flax tree (see `models.convert`); None draws
    random weights from ``seed``.  ``model`` skips building one from
    ``model_cfg`` (its weights are then used as they are).
    ``diffusion`` defaults to the 1000-step linear schedule.  ``sampler``
    names one of `SAMPLER_REGISTRY`; ``steps`` None takes the sampler's
    default; ``image_size`` None the model config's.  Conditions, each cycled over the ``n`` samples: ``cond``
    [K, cond_dim] vectors as they are, else one-hot ids from ``labels`` or
    drawn from ``seed``; ``layout`` [K, H, W] id masks or [K, H, W, C] maps
    for the layout methods, or ``mask_dir``'s PNGs (`masks_to_layouts`);
    ``stegoclusterlayout`` without ``cond`` takes the n-hot of each
    layout's classes.  PNGs are written only when ``out_dir`` is given.
    """
    dev = resolve_device(device)
    if model is None:
        model = create_denoiser(dtype=dtype, **model_cfg)
        if params is None:
            init_random_params(model, seed)
        else:
            model.load_state_dict(from_flax(params, model))
    image_size = int(image_size or model_cfg.get("image_size", 64))
    channels = int(model_cfg.get("out_channels", 3))
    cond_dim = int(model_cfg.get("cond_dim") or 0)
    method = model_cfg.get("condition_method")
    if method == "cluster_lookup":
        raise NotImplementedError("generate() does not take cluster_lookup's dataset ids")
    if mask_dir is not None:
        if method not in LAYOUT_COND_METHODS or layout is not None:
            raise ValueError(f"mask_dir is for the layout methods {LAYOUT_COND_METHODS}, in "
                             f"place of layout= (condition_method={method!r})")
        layout_dim = int(getattr(model, "layout_dim", 0) or model_cfg.get("layout_dim") or cond_dim)
        layout, attrs = masks_to_layouts(
            mask_dir, n, image_size, layout_dim,
            (cond_dim or layout_dim) if method == "stegoclusterlayout" else 0)
        if cond is None:
            cond = attrs
    if method in LAYOUT_COND_METHODS and layout is None:
        raise ValueError(f"condition_method={method!r} needs layouts (layout=, --layout, "
                         f"--mask-dir, --boxes)")
    if layout is not None:
        layout = layout_to_device(layout, getattr(model, "layout_dim", 0), dev)
        if tuple(layout.shape[1:3]) != (image_size, image_size):
            raise ValueError(f"layouts {tuple(layout.shape)} do not fit {image_size}px images")
        if cond is None and method == "stegoclusterlayout":
            cond = _attr_nhot(layout)
    if cond is not None:
        cond = torch.as_tensor(cond, dtype=torch.float32).to(dev)
        if cond.shape[-1] != cond_dim:
            raise ValueError(f"cond {tuple(cond.shape)} is not {cond_dim} wide")
    sample = make_sample_fn(model, diffusion or GaussianDiffusion(), sampling_method=sampler,
                            num_steps=steps, cond_scale=cond_scale, scale_type=scale_type,
                            device=dev)
    generator = torch.Generator(device=dev)
    generator.manual_seed(seed)
    ids_rng = np.random.default_rng(seed)
    bs = min(batch_size or n, n)
    out = torch.empty((n, image_size, image_size, channels), dtype=torch.uint8, device=dev)
    all_ids = []
    made = 0
    while made < n:
        b = min(bs, n - made)
        cycle = lambda t: t[(torch.arange(made, made + b, device=dev)) % t.shape[0]]
        c = None
        if cond is not None:
            c = cycle(cond)
        elif cond_dim:
            if labels:
                ids = np.asarray([labels[(made + j) % len(labels)] for j in range(b)])
                if (ids < 0).any() or (ids >= cond_dim).any():
                    raise ValueError(f"labels must be in [0,{cond_dim})")
            else:
                ids = ids_rng.integers(0, cond_dim, size=b)
            all_ids.extend(int(i) for i in ids)
            c = torch.nn.functional.one_hot(
                torch.as_tensor(ids, device=dev), cond_dim).float()
        imgs, _ = sample(model, generator, b, image_size, channels, cond=c,
                         layout=None if layout is None else cycle(layout))
        out[made:made + b] = imgs
        made += b
    if out_dir is not None:
        _write_pngs(out.cpu().numpy(), all_ids, Path(out_dir))
    return out


def _write_pngs(imgs: np.ndarray, ids: list[int], out: Path) -> list[Path]:
    """``{i:06d}.png`` (``{i:06d}_c{id}.png`` when ids are given) for each
    image, in order, as `sgdm_tpu/generate.py` names them."""
    out.mkdir(parents=True, exist_ok=True)
    paths = []
    for j, img in enumerate(imgs):
        name = f"{j:06d}" + (f"_c{ids[j]}" if ids else "")
        p = out / f"{name}.png"
        write_png(p, img)
        paths.append(p)
    return paths


def load_run(run_dir: str | Path, device: str | torch.device = "cuda"):
    """The trainer of a run directory, built from its ``config.json``."""
    from .training.trainer import SelfGuidedDiffusionTrainer

    cfg_path = Path(run_dir) / "config.json"
    if not cfg_path.exists():
        raise FileNotFoundError(f"{cfg_path} not found: point --run at a training output dir")
    return SelfGuidedDiffusionTrainer(device=device, **json.loads(cfg_path.read_text()))


def _resolve_ckpt(run_dir: Path, which: str) -> Path:
    """``last`` / ``best`` through the run's ``ckpts/meta.json``, else a path."""
    from .training.checkpoints import CheckpointManager

    meta_path = Path(run_dir) / "ckpts" / "meta.json"
    if which in ("last", "best"):
        if not meta_path.exists():
            raise FileNotFoundError(f"{meta_path} missing: no checkpoints?")
        p = json.loads(meta_path.read_text()).get("last_path" if which == "last" else "best_path")
        if not p:
            raise FileNotFoundError(f"run has no {which!r} checkpoint recorded in {meta_path}")
        return Path(p)
    return CheckpointManager.resolve(which)


def generate_from_run(run_dir: str | Path, *, ckpt: str = "last", use_ema: bool = True,
                      sampler: str = "ddim", cond_scale: float | None = None,
                      device: str | torch.device = "cuda", **kw) -> torch.Tensor:
    """`generate` from a run directory's checkpoint (see the module
    docstring), sampled on the run's own diffusion; ``kw`` as `generate`
    takes them."""
    from .training.checkpoints import CheckpointManager
    from .training.state import create_train_state

    trainer = load_run(run_dir, device)
    path = _resolve_ckpt(Path(run_dir), ckpt)
    trainer.state = create_train_state(trainer.model, trainer.tx, device=trainer.device)
    CheckpointManager(path.parent).restore(trainer.state, path)
    model = trainer._bound_model(use_ema)
    if cond_scale is None:
        cond_scale = trainer.cond_scale or 0.0
    return generate(trainer.hparams["dynamic"]["params"], model=model, sampler=sampler,
                    diffusion=trainer.diffusion, cond_scale=cond_scale,
                    scale_type=trainer.scale_type, device=trainer.device, **kw)


def _load_array(path: str) -> np.ndarray:
    data = np.load(path)
    return data if isinstance(data, np.ndarray) else data[data.files[0]]


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(prog="sgdm_tpu_torch.generate",
                                 description="Guided samples from a unet_fast or "
                                             "unetca_fast model.")
    ap.add_argument("--run", default=None,
                    help="a training output dir (config.json + ckpts/); the model flags below "
                         "are then not used")
    ap.add_argument("--ckpt", default="last", help="with --run: last, best or a checkpoint path")
    ap.add_argument("--no-ema", action="store_true",
                    help="with --run: sample the raw params instead of the EMA")
    ap.add_argument("--sampler", default="ddim", choices=SAMPLER_REGISTRY,
                    help="vdm and ddim_continuous need a run on the sqrt_linear or cosine "
                         "schedule")
    ap.add_argument("--family", choices=("unet", "unetca"), default="unet",
                    help="unet: UNET_FAST_IN64; unetca: UNETCA_FAST_VOC64")
    ap.add_argument("--params", default=None,
                    help=".npz of the flax param tree with '/'-joined paths "
                         "(default: random weights from --seed)")
    ap.add_argument("--image-size", type=int, default=None,
                    help="sample resolution (default: the run's data.image_size with --run, "
                         "else 64)")
    ap.add_argument("--model-channels", type=int, default=128)
    ap.add_argument("--cond-dim", type=int, default=None,
                    help="default: 0 (unet), 21 (unetca)")
    ap.add_argument("--condition-method", default=None,
                    help="default: none (unet), stegoclusterlayout (unetca)")
    ap.add_argument("--layout-dim", type=int, default=None,
                    help="channels of the layout map (default: the family's)")
    ap.add_argument("--layout", default=None,
                    help=".npy/.npz of id masks [K,H,W] or one-hot/binary maps [K,H,W,C], cycled")
    ap.add_argument("--mask-dir", default=None,
                    help="id-pixel mask PNGs for the layout methods (STEGO outputs / "
                         "ground-truth masks): the first --n, cycled")
    ap.add_argument("--boxes", default=None,
                    help='boxes "x0,y0,x1,y1[;...]" in sample-pixel coordinates, cycled '
                         "(clusterlayout; sets --layout-dim 1)")
    ap.add_argument("--n", type=int, default=16)
    ap.add_argument("--batch-size", type=int, default=None)
    ap.add_argument("--steps", type=int, default=None,
                    help="default: 250 with --run (as sgdm_tpu.generate), else the sampler's "
                         "own (DDIM 50); not used by --sampler native")
    ap.add_argument("--cond-scale", type=float, default=None,
                    help="guidance scale (default: the run's own with --run, else 2)")
    ap.add_argument("--labels", default=None,
                    help="comma-separated condition ids, cycled (default: random)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None,
                    help="directory for PNGs (default: samples/ with --run, else none written)")
    a = ap.parse_args(argv)
    labels = [int(x) for x in a.labels.split(",")] if a.labels else None
    if a.run:  # the JAX CLI's defaults: 250 steps, samples/, the run's resolution
        run_cfg = json.loads((Path(a.run) / "config.json").read_text()) \
            if (Path(a.run) / "config.json").exists() else {}
        a.image_size = a.image_size or int((run_cfg.get("data") or {}).get("image_size", 64))
        a.steps = 250 if a.steps is None else a.steps
        a.out = a.out or "samples"
    image_size = a.image_size or 64
    layout = None
    if a.boxes:
        layout = boxes_to_layouts(a.boxes, image_size)
    elif a.layout:
        layout = _load_array(a.layout)
    if a.run:
        imgs = generate_from_run(a.run, ckpt=a.ckpt, use_ema=not a.no_ema, sampler=a.sampler,
                                 cond_scale=a.cond_scale, device=a.device, n=a.n,
                                 batch_size=a.batch_size, steps=a.steps, labels=labels,
                                 layout=layout, mask_dir=a.mask_dir, seed=a.seed,
                                 out_dir=a.out, image_size=image_size)
        print(f"sampled {tuple(imgs.shape)} {imgs.dtype} on {imgs.device} from {a.run}")
        return
    cfg = dict(UNETCA_FAST_VOC64 if a.family == "unetca" else UNET_FAST_IN64,
               image_size=image_size, model_channels=a.model_channels)
    if a.cond_dim is not None:
        cfg["cond_dim"] = a.cond_dim or None
    if a.condition_method is not None:
        cfg["condition_method"] = a.condition_method
    if a.boxes:
        cfg["layout_dim"] = 1
    if a.layout_dim is not None:
        cfg["layout_dim"] = a.layout_dim
    params = dict(np.load(a.params)) if a.params else None
    imgs = generate(cfg, params, n=a.n, batch_size=a.batch_size, sampler=a.sampler,
                    steps=a.steps, cond_scale=2.0 if a.cond_scale is None else a.cond_scale,
                    labels=labels, layout=layout, mask_dir=a.mask_dir, seed=a.seed,
                    device=a.device, out_dir=a.out)
    print(f"sampled {tuple(imgs.shape)} {imgs.dtype} on {imgs.device}")


if __name__ == "__main__":
    main()

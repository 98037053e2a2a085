"""Serving entry point: guided DDIM samples from a UNet of either family.

Port of `sgdm_tpu/generate.py`.  The model is described by a dict of
``configs/dynamic`` params (`models.factory.UNET_FAST_IN64` plus
``cond_dim``, or `models.factory.UNETCA_FAST_VOC64`); its weights come from
a flax param tree flattened to an ``.npz`` of ``/``-joined paths, or are
random, made from ``seed``, when none is given.

    python -m sgdm_tpu_torch.generate --params P.npz --cond-dim 1000 \
        --n 16 --steps 50 --cond-scale 2 --out samples/
    python -m sgdm_tpu_torch.generate --family unetca --layout masks.npy \
        --n 16 --steps 50 --out samples/
    python -m sgdm_tpu_torch.generate --run outputs/run1 --n 64 --steps 50 \
        --out samples/

``--run DIR`` samples a training run of the port (`sgdm_tpu_torch.main`,
or a JAX run carried over by ``tools/jax_run_to_torch.py``): the model and
diffusion are built from the run's ``config.json`` as the trainer builds
them, ``--ckpt`` (``last``, ``best`` or a path) is resolved through
``ckpts/meta.json`` and restored, and the EMA is sampled unless
``--no-ema``; ``--cond-scale`` defaults to the run's own.  DDIM is the only
``--sampler`` ported (the others: ROADMAP §1 item 6).

Conditions: vector methods take one-hot ids (``--labels``, cycled, or drawn
from the seed).  The layout methods take per-image layouts, cycled over the
batch like the labels:

  * ``--layout F`` — an ``.npy`` (or the first array of an ``.npz``) of
    integer id masks [K, H, W] (expanded to one-hot on the device) or of
    float one-hot / binary maps [K, H, W, C]; ``stegoclusterlayout`` derives
    its n-hot ``cond`` from the classes present in each layout;
  * ``--boxes "x0,y0,x1,y1[;…]"`` — boxes in sample-pixel coordinates →
    binary box masks [H, W, 1] for ``clusterlayout`` (ids via ``--labels``).

PNGs are written (and read back) by the standard library alone
(`write_png`, `read_png`): the machine with the card has no PIL.  Mask PNGs
(``--mask-dir``) and ``cluster_lookup`` ids wait for the dataset readers
(ROADMAP §1 item 4).
"""

from __future__ import annotations

import argparse
import json
import struct
import zlib
from pathlib import Path
from typing import Any, Mapping

import numpy as np
import torch

from .conditioning.condition import LAYOUT_COND_METHODS, layout_to_device
from .device import resolve_device
from .diffusion.core import GaussianDiffusion
from .models.convert import from_flax
from .models.factory import UNET_FAST_IN64, UNETCA_FAST_VOC64, create_denoiser, \
    init_random_params
from .training.state import make_sample_fn

__all__ = ["generate", "generate_from_run", "load_run", "boxes_to_layouts", "write_png",
           "read_png", "main"]

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def boxes_to_layouts(boxes: str, image_size: int) -> np.ndarray:
    """``"x0,y0,x1,y1[;…]"`` → binary box masks, float32 [K, H, W, 1]."""
    out = []
    for spec in boxes.split(";"):
        b = [float(v) for v in spec.split(",")]
        if len(b) != 4:
            raise ValueError(f"bad box {spec!r}: want x0,y0,x1,y1")
        m = np.zeros((image_size, image_size, 1), np.float32)
        m[int(b[1]):int(b[3]), int(b[0]):int(b[2])] = 1.0
        out.append(m)
    return np.stack(out)


def _attr_nhot(layout: torch.Tensor) -> torch.Tensor:
    """One-hot layouts [B, H, W, K] → n-hot [B, K] of the classes present."""
    return (layout.amax(dim=(1, 2)) > 0).float()


def generate(
    model_cfg: Mapping[str, Any],
    params: Mapping[str, np.ndarray] | None = None,
    *,
    n: int = 16,
    batch_size: int | None = None,
    steps: int = 50,
    cond_scale: float = 2.0,
    labels: list[int] | None = None,
    cond: np.ndarray | torch.Tensor | None = None,
    layout: np.ndarray | torch.Tensor | None = None,
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
    ``diffusion`` defaults to the 1000-step linear schedule.  Conditions, each
    cycled over the ``n`` samples: ``cond`` [K, cond_dim] vectors as they
    are, else one-hot ids from ``labels`` or drawn from ``seed``; ``layout``
    [K, H, W] id masks or [K, H, W, C] maps for the layout methods
    (``stegoclusterlayout`` without ``cond`` takes the n-hot of each
    layout's classes).  PNGs are written only when ``out_dir`` is given.
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
    if method == "cluster_lookup":
        raise NotImplementedError("generate() does not take cluster_lookup's dataset ids")
    if method in LAYOUT_COND_METHODS and layout is None:
        raise ValueError(f"condition_method={method!r} needs layouts (layout=, --layout, --boxes)")
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
    sample = make_sample_fn(model, diffusion or GaussianDiffusion(), num_steps=steps,
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


def write_png(path: Path, img: np.ndarray) -> None:
    """An 8-bit RGB PNG of uint8 ``img`` [H, W, 3], with the standard library
    only: signature, IHDR, one zlib IDAT of rows each led by filter byte 0
    (none), IEND, every chunk with its CRC-32."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"want uint8 [H, W, 3], got {img.shape}")
    h, w = img.shape[:2]

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    rows = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, 3 * w)], axis=1)
    Path(path).write_bytes(
        _PNG_SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
        + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + chunk(b"IEND", b""))


def read_png(path: Path) -> np.ndarray:
    """uint8 [H, W, 3] of a PNG as `write_png` writes it (8-bit RGB, not
    interlaced, filter byte 0 on every row); raises on anything else."""
    data = Path(path).read_bytes()
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError(f"{path}: not a PNG")
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])[0] != zlib.crc32(kind + body):
            raise ValueError(f"{path}: bad CRC in {kind!r}")
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        pos += 12 + n
    if hdr is None or hdr[2:] != (8, 2, 0, 0, 0):
        raise ValueError(f"{path}: not an 8-bit RGB PNG without interlace: {hdr}")
    w, h = hdr[:2]
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, 1 + 3 * w)
    if rows[:, 0].any():
        raise ValueError(f"{path}: row filters other than 0 are not read")
    return rows[:, 1:].reshape(h, w, 3).copy()


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
    docstring); ``kw`` as `generate` takes them."""
    from .training.checkpoints import CheckpointManager
    from .training.state import create_train_state

    if sampler != "ddim":
        raise NotImplementedError(f"--sampler {sampler}: only ddim is ported (ROADMAP §1 item 6)")
    trainer = load_run(run_dir, device)
    path = _resolve_ckpt(Path(run_dir), ckpt)
    trainer.state = create_train_state(trainer.model, trainer.tx, device=trainer.device)
    CheckpointManager(path.parent).restore(trainer.state, path)
    model = trainer._bound_model(use_ema)
    if cond_scale is None:
        cond_scale = trainer.cond_scale or 0.0
    return generate(trainer.hparams["dynamic"]["params"], model=model,
                    diffusion=trainer.diffusion, cond_scale=cond_scale,
                    scale_type=trainer.scale_type, device=trainer.device, **kw)


def _load_array(path: str) -> np.ndarray:
    data = np.load(path)
    return data if isinstance(data, np.ndarray) else data[data.files[0]]


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(prog="sgdm_tpu_torch.generate",
                                 description="Guided DDIM samples from a unet_fast or "
                                             "unetca_fast model.")
    ap.add_argument("--run", default=None,
                    help="a training output dir (config.json + ckpts/); the model flags below "
                         "are then not used")
    ap.add_argument("--ckpt", default="last", help="with --run: last, best or a checkpoint path")
    ap.add_argument("--no-ema", action="store_true",
                    help="with --run: sample the raw params instead of the EMA")
    ap.add_argument("--sampler", default="ddim", help="ddim (the only sampler ported)")
    ap.add_argument("--family", choices=("unet", "unetca"), default="unet",
                    help="unet: UNET_FAST_IN64; unetca: UNETCA_FAST_VOC64")
    ap.add_argument("--params", default=None,
                    help=".npz of the flax param tree with '/'-joined paths "
                         "(default: random weights from --seed)")
    ap.add_argument("--image-size", type=int, default=64)
    ap.add_argument("--model-channels", type=int, default=128)
    ap.add_argument("--cond-dim", type=int, default=None,
                    help="default: 0 (unet), 21 (unetca)")
    ap.add_argument("--condition-method", default=None,
                    help="default: none (unet), stegoclusterlayout (unetca)")
    ap.add_argument("--layout-dim", type=int, default=None,
                    help="channels of the layout map (default: the family's)")
    ap.add_argument("--layout", default=None,
                    help=".npy/.npz of id masks [K,H,W] or one-hot/binary maps [K,H,W,C], cycled")
    ap.add_argument("--boxes", default=None,
                    help='boxes "x0,y0,x1,y1[;...]" in sample-pixel coordinates, cycled '
                         "(clusterlayout; sets --layout-dim 1)")
    ap.add_argument("--n", type=int, default=16)
    ap.add_argument("--batch-size", type=int, default=None)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--cond-scale", type=float, default=None,
                    help="guidance scale (default: the run's own with --run, else 2)")
    ap.add_argument("--labels", default=None,
                    help="comma-separated condition ids, cycled (default: random)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None, help="directory for PNGs (default: none written)")
    a = ap.parse_args(argv)
    labels = [int(x) for x in a.labels.split(",")] if a.labels else None
    layout = None
    if a.boxes:
        layout = boxes_to_layouts(a.boxes, a.image_size)
    elif a.layout:
        layout = _load_array(a.layout)
    if a.run:
        imgs = generate_from_run(a.run, ckpt=a.ckpt, use_ema=not a.no_ema, sampler=a.sampler,
                                 cond_scale=a.cond_scale, device=a.device, n=a.n,
                                 batch_size=a.batch_size, steps=a.steps, labels=labels,
                                 layout=layout, seed=a.seed, out_dir=a.out)
        print(f"sampled {tuple(imgs.shape)} {imgs.dtype} on {imgs.device} from {a.run}")
        return
    if a.sampler != "ddim":
        raise NotImplementedError(f"--sampler {a.sampler}: only ddim is ported "
                                  f"(ROADMAP §1 item 6)")
    cfg = dict(UNETCA_FAST_VOC64 if a.family == "unetca" else UNET_FAST_IN64,
               image_size=a.image_size, model_channels=a.model_channels)
    if a.cond_dim is not None:
        cfg["cond_dim"] = a.cond_dim or None
    if a.condition_method is not None:
        cfg["condition_method"] = a.condition_method
    if a.boxes:
        cfg["layout_dim"] = 1
    if a.layout_dim is not None:
        cfg["layout_dim"] = a.layout_dim
    params = dict(np.load(a.params)) if a.params else None
    imgs = generate(cfg, params, n=a.n, batch_size=a.batch_size, steps=a.steps,
                    cond_scale=2.0 if a.cond_scale is None else a.cond_scale, labels=labels,
                    layout=layout, seed=a.seed,
                    device=a.device, out_dir=a.out)
    print(f"sampled {tuple(imgs.shape)} {imgs.dtype} on {imgs.device}")


if __name__ == "__main__":
    main()

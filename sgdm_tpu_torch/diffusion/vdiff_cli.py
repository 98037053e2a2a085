"""v-diffusion sampling CLIs on the card: one CLI, four subcommands.

Port of `sgdm_tpu/diffusion/vdiff_cli.py` (v-diffusion-pytorch's
``cfg_sample.py``, ``clip_sample.py``, ``cfg_modify_image.py`` and
``make_grid.py``), with the same flags and defaults:

    python -m sgdm_tpu_torch.diffusion.vdiff_cli cfg-sample  "prompt:3" ...
    python -m sgdm_tpu_torch.diffusion.vdiff_cli clip-sample "prompt:1" ...
    python -m sgdm_tpu_torch.diffusion.vdiff_cli modify-image init.png "prompt" ...
    python -m sgdm_tpu_torch.diffusion.vdiff_cli make-grid img1.png img2.png ...

The samplers are `samplers/v_objective.py`'s loops.  The CFG combine runs
the denoiser once on an (n_conds·B) batch and takes the weighted sum of the
n_conds predictions.  CLIP guidance is `torch.autograd.grad` of the
spherical-distance loss of the denoised prediction's random cutouts, through
the model and the CLIP image tower, inside an otherwise gradient-free
sampler loop: v ← v − (−∂loss/∂x)·σ/α.  Cutouts are the JAX package's
``jax.image.scale_and_translate`` crops (antialiased ``linear`` kernel at a
float scale and offset per cutout), drawn afresh from the run's generator
on every denoiser call.

Runs on the card (``--device cuda``, the default) unless asked for the CPU;
the networks run in float32 with TF32 off.  Text and image prompts go
through a CLIP encoder: ``--clip-encoder module:factory`` (or
``$SGDM_CLIP_ENCODER``; ``none`` turns it off), by default the native
`models/clip.py` towers (weights from ``SGDM_CLIP_WEIGHTS``, seeded random
ones otherwise).  ``--embed file.npy[:weight]`` takes a precomputed
embedding.  ``--checkpoint PATH`` reads a published ``.pth``;
``--checkpoint random:<seed>`` initialises the net from torch's generator
seeded with ``seed`` (its images differ from the JAX CLI's, whose random
init draws from ``jax.random``).  Images are read as PNG or JPEG
(`utils/image.py`) and written as PNG (`utils/png.py`).
"""

from __future__ import annotations

import argparse
import math
import sys
from pathlib import Path

import numpy as np
import torch

from ..data.transforms import resize
from ..device import no_tf32, resolve_device
from ..models.zoo_vdiff import (
    get_vdiff_model, get_vdiff_models, load_vdiff_torch_checkpoint,
)
from ..utils.image import read_image
from ..utils.png import write_png
from ..utils.resize import resize as jax_resize
from ..utils.resize import scale_and_translate_weights
from .samplers import v_objective as vo

__all__ = [
    "parse_prompt", "resize_and_center_crop", "spherical_dist_loss", "draw_cutouts",
    "make_cutouts", "make_cfg_model_fn", "make_cond_model_fn", "run_sampler",
    "resolve_clip_encoder", "gather_target_embeds", "main",
]


# ---------------------------------------------------------------------------
# prompts and images (cfg_sample.py:23-36)
# ---------------------------------------------------------------------------

def parse_prompt(prompt: str, default_weight: float = 3.0):
    """'text:weight' → (text, weight); URLs keep their colon."""
    if prompt.startswith("http://") or prompt.startswith("https://"):
        vals = prompt.rsplit(":", 2)
        vals = [vals[0] + ":" + vals[1], *vals[2:]]
    else:
        vals = prompt.rsplit(":", 1)
    vals = vals + ["", default_weight][len(vals):]
    return vals[0], float(vals[1])


def resize_and_center_crop(image: np.ndarray, size) -> np.ndarray:
    """uint8 [H, W, 3] → [size[1], size[0], 3]: PIL's LANCZOS cover-resize
    (`data/transforms.py resize`), then the centre crop."""
    h, w = image.shape[:2]
    fac = max(size[0] / w, size[1] / h)
    nw, nh = round(fac * w), round(fac * h)
    if (nh, nw) != (h, w):
        image = resize(image, nh, nw, "lanczos")
    left, top = (nw - size[0]) // 2, (nh - size[1]) // 2
    return image[top:top + size[1], left:left + size[0]]


def _from_image(img: np.ndarray) -> np.ndarray:
    """uint8 [H, W, 3] → float32 [3, H, W] in [-1, 1]."""
    return (img.astype(np.float32) / 255.0 * 2.0 - 1.0).transpose(2, 0, 1)


def _to_image(x) -> np.ndarray:
    """float [3, H, W] (or [1, 3, H, W]) in [-1, 1] → uint8 [H, W, 3],
    truncated as ``np.uint8(x * 255)``."""
    x = np.asarray(x, np.float32)
    if x.ndim == 4:
        x = x[0]
    x = np.clip((x.transpose(1, 2, 0) + 1) / 2, 0, 1)
    return np.asarray(x * 255, np.uint8)


# ---------------------------------------------------------------------------
# CLIP guidance (clip_sample.py:23-78)
# ---------------------------------------------------------------------------

def spherical_dist_loss(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Squared great-circle distance between the directions of x and y."""
    x = x / x.norm(dim=-1, keepdim=True)
    y = y / y.norm(dim=-1, keepdim=True)
    return torch.arcsin((x - y).norm(dim=-1) / 2).square() * 2


def draw_cutouts(gen: torch.Generator | None, h: int, w: int, cut_size: int, cutn: int,
                 cut_pow: float = 1.0, device=None):
    """The random crops: sizes ~ U^cut_pow·(max − min) + min and offsets
    U·(side − size), each float32 [cutn]."""
    max_size, min_size = min(h, w), min(h, w, cut_size)
    u = torch.rand(3, cutn, generator=gen, device=device)
    sizes = u[0] ** cut_pow * (max_size - min_size) + min_size
    return sizes, u[1] * (w - sizes), u[2] * (h - sizes)


def make_cutouts(imgs: torch.Tensor, cut_size: int, sizes: torch.Tensor,
                 offx: torch.Tensor, offy: torch.Tensor) -> torch.Tensor:
    """imgs [B, C, H, W] → [cutn·B, C, cut_size, cut_size], cutout-major (as
    torch.cat of the cutouts): cutout i maps the window [offy, offy + size) ×
    [offx, offx + size) onto cut_size² with jax.image's antialiased linear
    resampling.  Differentiable in imgs."""
    b, c, h, w = imgs.shape
    scale = cut_size / sizes
    wy = scale_and_translate_weights(h, cut_size, 1.0 / scale, -offy * scale).to(imgs.dtype)
    wx = scale_and_translate_weights(w, cut_size, 1.0 / scale, -offx * scale).to(imgs.dtype)
    out = torch.einsum("bchw,nhy,nwx->nbcyx", imgs, wy, wx)
    return out.reshape(-1, c, cut_size, cut_size)


def make_cond_model_fn(model_fn, loss_fn):
    """``loss_fn(x, t, pred) -> scalar`` (summed over the batch) → a model fn
    computing v − (−∂loss/∂x)·σ/α, the gradient taken through the model."""

    def cond_model_fn(x, t):
        a, s = vo.t_to_alpha_sigma(t)
        a4, s4 = a.reshape(-1, *[1] * (x.ndim - 1)), s.reshape(-1, *[1] * (x.ndim - 1))
        with torch.enable_grad():
            x_ = x.detach().requires_grad_()
            v = model_fn(x_, t)
            loss = loss_fn(x_, t, x_ * a4 - v * s4)
            g, = torch.autograd.grad(loss, x_)
        return v.detach() - (-g) * (s4 / a4)

    return cond_model_fn


def make_cfg_model_fn(apply_fn, target_embeds, weights):
    """``apply_fn(x, t, clip_embed) -> v``; target_embeds [n_conds, D],
    weights [n_conds]: one denoiser call on the (n_conds·B) batch, then the
    weighted sum of the n_conds predictions (cfg_sample.py:123-131)."""
    target_embeds = torch.as_tensor(np.asarray(target_embeds, np.float32))
    weights = torch.as_tensor(np.asarray(weights, np.float32))
    n_conds = target_embeds.shape[0]

    def cfg_model_fn(x, t):
        n = x.shape[0]
        x_in = x.repeat(n_conds, *[1] * (x.ndim - 1))
        t_in = t.repeat(n_conds)
        ce_in = target_embeds.to(x.device).repeat_interleave(n, dim=0)
        vs = apply_fn(x_in, t_in, ce_in).reshape(n_conds, *x.shape)
        return torch.tensordot(weights.to(x.device), vs, dims=1)

    return cfg_model_fn


# ---------------------------------------------------------------------------
# sampler dispatch (cfg_sample.py:133-148)
# ---------------------------------------------------------------------------

_METHODS = ("ddpm", "ddim", "prk", "plms", "pie", "plms2", "iplms")


def run_sampler(method: str, model_fn, x, steps, eta: float = 0.0,
                rng: torch.Generator | None = None, is_reverse: bool = False):
    if method == "ddpm":
        if is_reverse:
            raise SystemExit(
                "ddpm is stochastic ancestral sampling and cannot be "
                "reversed — use a deterministic method (ddim/prk/plms/"
                "pie/plms2/iplms) for modify-image")
        return vo.v_sample(model_fn, x, steps, 1.0, rng)
    if method == "ddim":
        if is_reverse:
            return vo.v_reverse_sample(model_fn, x, steps)
        return vo.v_sample(model_fn, x, steps, eta, rng)
    fn = {"prk": vo.prk_sample, "plms": vo.plms_sample, "pie": vo.pie_sample,
          "plms2": vo.plms2_sample, "iplms": vo.iplms_sample}[method]
    return fn(model_fn, x, steps, is_reverse=is_reverse)


# ---------------------------------------------------------------------------
# the CLIP encoder plug
# ---------------------------------------------------------------------------

class ClipEncoderProtocol:
    """What a ``--clip-encoder module:factory`` builds; the factory is called
    as ``factory(model_name, device=device)``.

    Attributes: ``embed_dim`` (int), ``input_resolution`` (int).  Methods:
    ``encode_text(list[str]) -> np[n, D]``; ``encode_image_fn(imgs) ->
    tensor [n, D]`` on NCHW RGB in [0, 1] at ``input_resolution``,
    differentiable (clip-sample's guidance takes its gradient; image prompts
    only call it forward).  The encoder normalises the pixels itself.
    """


def resolve_clip_encoder(spec, model_name, device):
    """``spec`` 'module:factory' (or $SGDM_CLIP_ENCODER) → the encoder;
    none given → the native `models/clip.py` encoder; 'none' → None (text
    and image prompts then raise)."""
    import importlib
    import os

    spec = spec or os.environ.get("SGDM_CLIP_ENCODER")
    if spec == "none":
        return None
    if not spec:
        from ..models.clip import build

        return build(model_name, device=device)
    mod, _, factory = spec.partition(":")
    return getattr(importlib.import_module(mod), factory or "build")(model_name, device=device)


def _require_encoder(encoder, what):
    if encoder is None:
        raise SystemExit(
            f"{what} require a CLIP encoder, and none is configured. Provide "
            "--clip-encoder module:factory (see ClipEncoderProtocol), or pass "
            "precomputed embeddings via --embed file.npy[:weight].")
    return encoder


def gather_target_embeds(args, clip_dim, encoder, include_zero: bool,
                         default_weight: float = 3.0):
    """The target embeddings ([1, D] each) and weights of the text prompts,
    ``--embed`` files and image prompts, after the zero embedding (the CFG
    null condition) when ``include_zero``."""
    target_embeds, weights = [], []
    if include_zero:
        target_embeds.append(np.zeros((1, clip_dim), np.float32))
    for prompt in args.prompts:
        txt, weight = parse_prompt(prompt, default_weight)
        enc = _require_encoder(encoder, "text prompts")
        target_embeds.append(np.asarray(enc.encode_text([txt]), np.float32))
        weights.append(weight)
    for prompt in getattr(args, "embeds", None) or []:
        path, weight = parse_prompt(prompt, default_weight)
        e = np.asarray(np.load(path), np.float32).reshape(1, -1)
        if e.shape[-1] != clip_dim:
            raise SystemExit(f"--embed {path}: dim {e.shape[-1]} != {clip_dim}")
        target_embeds.append(e)
        weights.append(weight)
    for prompt in args.images:
        path, weight = parse_prompt(prompt, default_weight)
        enc = _require_encoder(encoder, "image prompts")
        res = enc.input_resolution
        img = resize_and_center_crop(read_image(path), (res, res))
        x01 = torch.as_tensor((_from_image(img)[None] + 1) / 2)
        with torch.no_grad():
            e = enc.encode_image_fn(x01).float().cpu().numpy()
        target_embeds.append(e / np.linalg.norm(e, axis=-1, keepdims=True))
        weights.append(weight)
    return target_embeds, weights


# ---------------------------------------------------------------------------
# model and checkpoint
# ---------------------------------------------------------------------------

def _get_model(args):
    """The zoo entry's meta and the output size (no weights yet)."""
    _, meta = get_vdiff_model(args.model, "meta")
    side_y, side_x = meta.shape[:2]
    if args.size:
        side_x, side_y = args.size
    return meta, side_x, side_y


def _resolve_checkpoint(args):
    """--checkpoint → an existing path, or None for random:<seed>."""
    ckpt = args.checkpoint
    if ckpt and str(ckpt).startswith("random:"):
        return None
    if not ckpt:
        ckpt = Path(f"checkpoints/{args.model}.pth")
    if not Path(ckpt).exists():
        raise SystemExit(
            f"checkpoint {ckpt} not found — pass --checkpoint PATH "
            "(torch .pth) or --checkpoint random:<seed> for a smoke run")
    return ckpt


def _load_model(args, dev: torch.device):
    """The net with its weights on ``dev`` (after the argument checks, so a
    missing encoder fails before a 0.6B-parameter load)."""
    ckpt = _resolve_checkpoint(args)
    if ckpt is None:
        torch.manual_seed(int(str(args.checkpoint).split(":", 1)[1]))
        model, _ = get_vdiff_model(args.model, dev)
    else:
        model = load_vdiff_torch_checkpoint(args.model, str(ckpt), dev)
    return model.requires_grad_(False)


def _linspace(start: float, stop: float, num: int) -> torch.Tensor:
    """float32 ``jnp.linspace(start, stop, num)``'s formula: start·(1 − s) +
    stop·s with s = i / (num − 1), the last point exactly ``stop`` (XLA's
    fused evaluation may round a point one ulp apart)."""
    div = num - 1
    step = torch.arange(div, dtype=torch.float32) / div
    return torch.cat([start * (1 - step) + stop * step, torch.tensor([float(stop)])])


def _schedule(meta, steps: int, for_modify: bool = False) -> torch.Tensor:
    """cfg_sample.py:152-153 / clip_sample.py:219-223 / cfg_modify_image.py:130-132."""
    if for_modify:
        return vo.get_spliced_ddpm_cosine_schedule(_linspace(0, 1, steps + 1))
    t = _linspace(1, 0, steps + 1)[:-1]
    if meta.min_t == 0:
        return vo.get_spliced_ddpm_cosine_schedule(t)
    return vo.get_ddpm_schedule(t)


def _load_init(args, side_x, side_y, n, dev) -> torch.Tensor:
    img = resize_and_center_crop(read_image(args.init), (side_x, side_y))
    return torch.as_tensor(_from_image(img), device=dev)[None].repeat(n, 1, 1, 1)


def _save_batch(outs, start: int, prefix: str = "out"):
    for j, out in enumerate(outs.float().cpu().numpy()):
        write_png(f"{prefix}_{start + j:05}.png", _to_image(out))


def _run_batches(run, n, batch_size, side_x, side_y, seed, dev, init=None, start_t=None):
    """One noise tensor for all n images (from a generator seeded with
    ``seed``), sampled ``batch_size`` at a time; the generator goes on to
    feed the samplers' draws."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    x = torch.randn((n, 3, side_y, side_x), generator=gen, device=dev)
    if init is not None:
        a, s = vo.t_to_alpha_sigma(start_t)
        x = init * a.to(dev) + x * s.to(dev)
    for i in range(0, n, batch_size):
        _save_batch(run(x[i:i + batch_size], gen), i)
        print(f"saved {min(i + batch_size, n)}/{n}", file=sys.stderr)


# ---------------------------------------------------------------------------
# subcommands
# ---------------------------------------------------------------------------

def _cmd_cfg_sample(args, dev):
    """cfg_sample.py main."""
    meta, side_x, side_y = _get_model(args)
    if not meta.clip_dim:
        raise SystemExit("cfg-sample needs a CLIP-conditioned model (cc12m_1_cfg)")
    _resolve_checkpoint(args)
    encoder = resolve_clip_encoder(args.clip_encoder, meta.clip_model, dev)
    target_embeds, weights = gather_target_embeds(args, meta.clip_dim, encoder,
                                                  include_zero=True)
    weights = np.asarray([1 - sum(weights), *weights], np.float32)
    model = _load_model(args, dev)
    cfg_fn = make_cfg_model_fn(model, np.concatenate(target_embeds), weights)
    steps = _schedule(meta, args.steps)
    init = _load_init(args, side_x, side_y, args.n, dev) if args.init else None
    if init is not None:
        steps = steps[steps < args.starting_timestep]
    run = lambda x, gen: run_sampler(args.method, cfg_fn, x, steps, args.eta, gen)  # noqa: E731
    _run_batches(run, args.n, args.batch_size, side_x, side_y, args.seed, dev, init,
                 steps[0] if init is not None else None)


def _cmd_clip_sample(args, dev):
    """clip_sample.py main."""
    meta, side_x, side_y = _get_model(args)
    _resolve_checkpoint(args)
    encoder = resolve_clip_encoder(args.clip_encoder, meta.clip_model or "ViT-B/16", dev)
    clip_dim = meta.clip_dim or (encoder.embed_dim if encoder else 512)
    target_embeds, weights = gather_target_embeds(args, clip_dim, encoder, include_zero=False,
                                                  default_weight=1.0)
    if not target_embeds:
        raise SystemExit("at least one text or image prompt (or --embed) must be specified")
    weights = np.asarray(weights, np.float32)
    if abs(weights.sum()) < 1e-3:
        raise SystemExit("the weights must not sum to 0")
    weights = weights / abs(weights.sum())
    if args.clip_guidance_scale:
        _require_encoder(encoder, "CLIP guidance (-cs > 0)")
    model = _load_model(args, dev)
    clip_embed = (np.concatenate(target_embeds) * weights[:, None]).sum(0)
    clip_embed = clip_embed / max(np.linalg.norm(clip_embed), 1e-12)
    clip_embed = torch.as_tensor(clip_embed, dtype=torch.float32, device=dev)[None]
    clip_embed = clip_embed.repeat(args.n, 1)

    if meta.clip_dim:
        base_fn = lambda x, t: model(x, t, clip_embed[:x.shape[0]])  # noqa: E731
    else:
        base_fn = lambda x, t: model(x, t)  # noqa: E731

    if args.clip_guidance_scale:
        cut_size = encoder.input_resolution

        def model_fn(x, t, gen):
            def loss_fn(x_, t_, pred):
                b = x_.shape[0]
                if min(pred.shape[2:4]) < 256:        # clip_sample.py:181-182
                    pred = _resize_linear(pred, 2 * pred.shape[2], 2 * pred.shape[3])
                sizes, ox, oy = draw_cutouts(gen, pred.shape[2], pred.shape[3], cut_size,
                                             args.cutn, args.cut_pow, dev)
                cuts = make_cutouts((pred + 1) / 2, cut_size, sizes, ox, oy)
                emb = encoder.encode_image_fn(cuts).reshape(args.cutn, b, -1)
                losses = spherical_dist_loss(emb, clip_embed[None, :b])
                return losses.mean(0).sum() * args.clip_guidance_scale

            return make_cond_model_fn(base_fn, loss_fn)(x, t)
    else:
        model_fn = lambda x, t, gen: base_fn(x, t)  # noqa: E731

    steps = _schedule(meta, args.steps)
    init = _load_init(args, side_x, side_y, args.n, dev) if args.init else None
    if init is not None:
        steps = steps[steps < args.starting_timestep]

    def run(x, gen):
        return run_sampler(args.method, lambda x_, t_: model_fn(x_, t_, gen), x, steps,
                           args.eta, gen)

    _run_batches(run, args.n, args.batch_size, side_x, side_y, args.seed, dev, init,
                 steps[0] if init is not None else None)


def _resize_linear(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """``jax.image.resize(…, "linear")`` of NCHW ``x`` to (h, w)."""
    return jax_resize(x, (x.shape[0], x.shape[1], h, w), "linear")


def _cmd_modify_image(args, dev):
    """cfg_modify_image.py main: DDIM-invert the init image with the zero
    embedding, then integrate the conditional ODE from that latent."""
    meta, side_x, side_y = _get_model(args)
    if not meta.clip_dim:
        raise SystemExit("modify-image needs cc12m_1_cfg")
    if args.method == "ddpm":
        raise SystemExit("modify-image cannot use --method ddpm (stochastic "
                         "ancestral sampling has no inverse); pick "
                         "ddim/prk/plms/pie/plms2/iplms")
    _resolve_checkpoint(args)
    encoder = resolve_clip_encoder(args.clip_encoder, meta.clip_model, dev)
    target_embeds, weights = gather_target_embeds(args, meta.clip_dim, encoder,
                                                  include_zero=True)
    weights = np.asarray([1 - sum(weights), *weights], np.float32)
    model = _load_model(args, dev)
    cfg_fn = make_cfg_model_fn(model, np.concatenate(target_embeds), weights)
    zero = torch.zeros(1, meta.clip_dim, device=dev)
    plain_fn = lambda x, t: model(x, t, zero.repeat(x.shape[0], 1))  # noqa: E731

    steps = _schedule(meta, args.steps, for_modify=True)
    steps = steps[steps <= args.max_timestep]
    init = _load_init(args, side_x, side_y, 1, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    lat = run_sampler(args.method, plain_fn, init, steps, is_reverse=True)
    out = run_sampler(args.method, cfg_fn, lat, steps.flip(0)[:-1], rng=gen)
    write_png(args.output, _to_image(out.float().cpu().numpy()[0]))


def _cmd_make_grid(args, dev=None):
    """make_grid.py: same-size images pasted into a grid, row by row."""
    images = [read_image(p) for p in args.images]
    size = images[0].shape
    for img, name in zip(images, args.images):
        if img.shape != size:
            raise SystemExit(f"{name}: size {img.shape[1]}x{img.shape[0]} != "
                             f"{size[1]}x{size[0]}")
    n = len(images)
    x = args.nrow if args.nrow else math.ceil(n ** 0.5)
    y = math.ceil(n / x)
    h, w = size[:2]
    out = np.zeros((h * y, w * x, 3), np.uint8)
    for i, img in enumerate(images):
        r, c = i // x, i % x
        out[h * r:h * (r + 1), w * c:w * (c + 1)] = img
    write_png(args.output, out)


# ---------------------------------------------------------------------------
# argparse
# ---------------------------------------------------------------------------

def _common(p, default_model, model_choices, default_method, default_steps):
    p.add_argument("prompts", type=str, default=[], nargs="*",
                   help="text prompts ('text:weight')")
    p.add_argument("--images", type=str, default=[], nargs="*",
                   metavar="IMAGE", help="image prompts ('path:weight')")
    p.add_argument("--embed", dest="embeds", type=str, action="append",
                   metavar="NPY[:W]",
                   help="precomputed CLIP embedding .npy (repeatable)")
    p.add_argument("--clip-encoder", type=str, default=None,
                   metavar="MODULE:FACTORY",
                   help="CLIP encoder plug (ClipEncoderProtocol)")
    p.add_argument("--batch-size", "-bs", type=int, default=1)
    p.add_argument("--checkpoint", type=str,
                   help=".pth path, or random:<seed> for a smoke run")
    p.add_argument("--eta", type=float, default=0.0)
    p.add_argument("--method", type=str, default=default_method,
                   choices=_METHODS)
    p.add_argument("--model", type=str, default=default_model,
                   choices=model_choices)
    p.add_argument("-n", type=int, default=1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--size", type=int, nargs=2)
    p.add_argument("--steps", type=int, default=default_steps)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")


def build_parser():
    p = argparse.ArgumentParser(prog="sgdm-vdiff", description=__doc__.splitlines()[0])
    sub = p.add_subparsers(dest="cmd", required=True)

    c = sub.add_parser("cfg-sample", help="classifier-free-guidance sampling")
    _common(c, "cc12m_1_cfg", ["cc12m_1_cfg"], "plms", 50)
    c.add_argument("--init", type=str)
    c.add_argument("--starting-timestep", "-st", type=float, default=0.9)
    c.set_defaults(fn=_cmd_cfg_sample)

    c = sub.add_parser("clip-sample", help="CLIP-guided sampling")
    _common(c, "cc12m_1", get_vdiff_models(), "ddpm", 1000)
    c.add_argument("--clip-guidance-scale", "-cs", type=float, default=500.0)
    c.add_argument("--cutn", type=int, default=16)
    c.add_argument("--cut-pow", type=float, default=1.0)
    c.add_argument("--init", type=str)
    c.add_argument("--starting-timestep", "-st", type=float, default=0.9)
    c.set_defaults(fn=_cmd_clip_sample)

    c = sub.add_parser("modify-image", help="apply a prompt to an existing image")
    c.add_argument("init", type=str, help="the init image")
    _common(c, "cc12m_1_cfg", ["cc12m_1_cfg"], "plms", 50)
    c.add_argument("--max-timestep", "-mt", type=float, default=1.0)
    c.add_argument("--output", "-o", type=str, default="out.png")
    c.set_defaults(fn=_cmd_modify_image)

    c = sub.add_parser("make-grid", help="assemble images into a grid")
    c.add_argument("images", type=str, nargs="+", metavar="image")
    c.add_argument("--output", "-o", type=str, default="out.png")
    c.add_argument("--nrow", type=int)
    c.set_defaults(fn=_cmd_make_grid, device=None)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.device is None:
        return args.fn(args)
    dev = resolve_device(args.device)
    with torch.no_grad(), no_tf32():
        return args.fn(args, dev)


if __name__ == "__main__":
    main()

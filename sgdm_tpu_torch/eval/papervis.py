"""Paper-figure grids: the core and the named figure zoo.

Port of `sgdm_tpu/eval/papervis.py`.  A small core (`draw_grid`,
`overlay_mask`, `overlay_bbox`, `draw_chain_grid`) and the figures built on
it:

  * `draw_grid_img` / `draw_grid_clustervis` / `draw_grid_interp`: plain
    sample grids;
  * `draw_grid_stego` / `draw_grid_random_stego_with_mask`: STEGO-mask
    figures (the original, its mask overlay, then samples, or interleaved
    overlay / sample pairs);
  * `draw_grid_lost_bbox` / `draw_grid_random_lost_with_box`: the LOST
    mask's box in red on the original and the samples;
  * `draw_grid_stego_chainvis` / `draw_grid_lost_chainvis`: denoising
    chains led by the condition's overlay;
  * `draw_grid_condscale` / `draw_grid_condscale_stego`: guidance sweeps,
    sampled by `condscale_sweep_images` in one sampler call with a
    per-sample weight;
  * `draw_grid_scoremix`, `cluster_hist_vis_fn`, `extract_bboxes`.

Helpers take uint8 NHWC numpy arrays; masks are class ids [H, W], one-hot
[H, W, K] or channels-first one-hot [K, H, W].  Images are upsampled with
PIL's bilinear filter bit for bit (`data/transforms.py resize_bilinear`),
masks with its nearest pick (`utils/png.py resize_nearest`); figures are
written by `utils/png.write_png`.  The images-per-cluster histogram is
rasterised in numpy (`hist_image`), where the JAX package draws it with
matplotlib.
"""

from __future__ import annotations

from pathlib import Path
from typing import Sequence

import numpy as np
import torch

from ..data.transforms import resize_bilinear
from ..utils.logging import make_grid
from ..utils.png import resize_nearest, write_png

__all__ = [
    "DISTINCT_COLORS", "draw_grid", "overlay_mask", "overlay_bbox",
    "draw_chain_grid", "extract_bboxes", "mask_to_ids", "upsample_img",
    "draw_grid_img", "draw_grid_clustervis", "draw_grid_interp",
    "draw_grid_stego", "draw_grid_random_stego_with_mask",
    "draw_grid_lost_bbox", "draw_grid_random_lost_with_box",
    "draw_grid_stego_chainvis", "draw_grid_lost_chainvis",
    "draw_grid_condscale", "draw_grid_condscale_stego",
    "draw_grid_scoremix", "cluster_hist_vis_fn", "hist_image", "condscale_sweep_images",
]

# 27 visually-distinct RGB colors (enough for stego_k / coco-stuff 27)
DISTINCT_COLORS = np.array([
    [230, 25, 75], [60, 180, 75], [255, 225, 25], [0, 130, 200],
    [245, 130, 48], [145, 30, 180], [70, 240, 240], [240, 50, 230],
    [210, 245, 60], [250, 190, 212], [0, 128, 128], [220, 190, 255],
    [170, 110, 40], [255, 250, 200], [128, 0, 0], [170, 255, 195],
    [128, 128, 0], [255, 215, 180], [0, 0, 128], [128, 128, 128],
    [255, 255, 255], [0, 0, 0], [255, 0, 102], [102, 255, 0],
    [0, 102, 255], [255, 153, 0], [153, 0, 255],
], dtype=np.uint8)


def draw_grid(images: Sequence[np.ndarray] | np.ndarray, save_path: str | Path,
              ncol: int | None = None, padding: int = 2) -> Path:
    """Stack uint8 [H,W,C] images into a grid PNG."""
    batch = np.stack([np.asarray(im) for im in images])
    if batch.ndim == 3:
        batch = batch[..., None]
    grid = make_grid(batch, ncol=ncol, pad=padding)
    save_path = Path(save_path)
    save_path.parent.mkdir(parents=True, exist_ok=True)
    write_png(save_path, grid)
    return save_path


def overlay_mask(img: np.ndarray, mask_ids: np.ndarray, alpha: float = 0.5) -> np.ndarray:
    """Blend a class-id mask over an image with distinct colors."""
    colors = DISTINCT_COLORS[mask_ids % len(DISTINCT_COLORS)]
    out = (1 - alpha) * img.astype(np.float32) + alpha * colors.astype(np.float32)
    return np.clip(out, 0, 255).astype(np.uint8)


def overlay_bbox(img: np.ndarray, bbox: np.ndarray, color=(255, 0, 0),
                 width: int = 1) -> np.ndarray:
    """Draw an (x0,y0,x1,y1) box outline."""
    out = img.copy()
    x0, y0, x1, y1 = [int(v) for v in bbox]
    h, w = img.shape[:2]
    x0, x1 = np.clip([x0, x1], 0, w - 1)
    y0, y1 = np.clip([y0, y1], 0, h - 1)
    c = np.asarray(color, dtype=out.dtype)
    for k in range(width):
        out[np.clip(y0 + k, 0, h - 1), x0:x1 + 1] = c
        out[np.clip(y1 - k, 0, h - 1), x0:x1 + 1] = c
        out[y0:y1 + 1, np.clip(x0 + k, 0, w - 1)] = c
        out[y0:y1 + 1, np.clip(x1 - k, 0, w - 1)] = c
    return out


def draw_chain_grid(chain: np.ndarray, save_path: str | Path, padding: int = 2) -> Path:
    """Progressive chain [K,B,H,W,C] → rows = samples, cols = timesteps."""
    chain = np.asarray(chain)
    k, b = chain.shape[:2]
    rows = chain.transpose(1, 0, 2, 3, 4).reshape(k * b, *chain.shape[2:])
    return draw_grid(rows, save_path, ncol=k, padding=padding)


# ----------------------------------------------------------------------
# shared small ops

def mask_to_ids(mask: np.ndarray) -> np.ndarray:
    """Any mask form → class-id [H,W]: ids [H,W], one-hot [H,W,K] or
    one-hot [K,H,W] (the class axis is the one that differs from the square
    spatial dims)."""
    m = np.asarray(mask)
    if m.ndim == 2:
        return m.astype(np.int32)
    if m.ndim == 3:
        if m.shape[0] != m.shape[1] and m.shape[1] == m.shape[2]:
            m = np.moveaxis(m, 0, -1)
        return m.argmax(-1).astype(np.int32)
    raise ValueError(f"bad mask shape {m.shape}")


def upsample_img(img: np.ndarray, up_size: int = 256, mode: str = "bilinear") -> np.ndarray:
    """uint8 [H,W,C] (or ids [H,W]) → up_size²: PIL's bilinear for images,
    its nearest for id masks (and for images with ``mode="nearest"``)."""
    arr = np.asarray(img)
    if arr.shape[0] == up_size:
        return arr
    if arr.ndim == 2 or mode != "bilinear":
        return resize_nearest(arr, up_size, up_size)
    return resize_bilinear(np.ascontiguousarray(arr), up_size, up_size)


def extract_bboxes(mask: np.ndarray) -> np.ndarray:
    """[H,W,K] instance masks → [K,4] (x1,y1,x2,y2) boxes (an empty
    instance → zeros)."""
    m = np.asarray(mask)
    if m.ndim == 2:
        m = m[..., None]
    boxes = np.zeros((m.shape[-1], 4), dtype=np.int32)
    for i in range(m.shape[-1]):
        cols = np.where(m[:, :, i].any(axis=0))[0]
        rows = np.where(m[:, :, i].any(axis=1))[0]
        if len(cols):
            boxes[i] = (cols[0], rows[0], cols[-1] + 1, rows[-1] + 1)
    return boxes


def _unnormalize(images) -> np.ndarray:
    """[-1,1] float → uint8 (no-op for uint8 inputs)."""
    arr = images.cpu().numpy() if isinstance(images, torch.Tensor) else np.asarray(images)
    if arr.dtype == np.uint8:
        return arr
    return np.clip((arr + 1) * 127.5, 0, 255).astype(np.uint8)


def _stego_overlay(original: np.ndarray, mask, up_size: int, alpha: float = 1.0) -> np.ndarray:
    ids = upsample_img(mask_to_ids(mask), up_size)
    return overlay_mask(upsample_img(original, up_size), ids, alpha=alpha)


def _lost_boxed(img: np.ndarray, lostmask, up_size: int, width: int = 4) -> np.ndarray:
    """Draw the LOST binary mask's bbox (scaled to up_size) in red.  A
    [H, W, 1] mask (the datasets' ``lostbboxmask``) is the binary map
    itself: the JAX package takes its argmax over the one channel, which is
    0 everywhere, and draws no box."""
    m = np.asarray(lostmask)
    if m.ndim == 3 and m.shape[-1] == 1:
        m = m[..., 0]
    m = mask_to_ids(m) > 0 if m.ndim == 3 else m > 0
    scale = up_size / m.shape[0]
    out = upsample_img(img, up_size)
    for box in extract_bboxes(m.astype(np.uint8)):
        if box.any():
            out = overlay_bbox(out, np.round(box * scale), width=width)
    return out


# ----------------------------------------------------------------------
# the named figure zoo

def draw_grid_img(samples, save_path, ncol: int = 7, padding: int = 2,
                  up_size: int | None = None):
    """Plain sample grid."""
    imgs = [_unnormalize(s) for s in samples]
    if up_size:
        imgs = [upsample_img(s, up_size) for s in imgs]
    return draw_grid(imgs, save_path, ncol=ncol, padding=padding)


# cluster grids and interpolation grids are the same writer
draw_grid_clustervis = draw_grid_img
draw_grid_interp = draw_grid_img


def draw_grid_stego(samples, masks, original_images, save_path, padding: int = 5,
                    up_size: int = 256, alpha: float = 1.0):
    """One row: [original, stego-overlay, sample...]."""
    tiles = [upsample_img(_unnormalize(original_images[0]), up_size),
             _stego_overlay(_unnormalize(original_images[0]), masks[0], up_size, alpha)]
    tiles += [upsample_img(_unnormalize(s), up_size) for s in samples]
    return draw_grid(tiles, save_path, ncol=len(tiles), padding=padding)


def draw_grid_random_stego_with_mask(samples, masks, original_images, save_path, ncol: int = 4,
                                     padding: int = 5, up_size: int = 256, alpha: float = 1.0):
    """Interleaved (overlay, sample) pairs."""
    tiles = []
    for s, m, o in zip(samples, masks, original_images):
        tiles.append(_stego_overlay(_unnormalize(o), m, up_size, alpha))
        tiles.append(upsample_img(_unnormalize(s), up_size))
    return draw_grid(tiles, save_path, ncol=2 * ncol, padding=padding)


def draw_grid_lost_bbox(samples, lostmask, original_images, save_path, padding: int = 5,
                        up_size: int = 256, bbox_width: int = 4):
    """One row: [original+box, sample+box...]."""
    tiles = [_lost_boxed(_unnormalize(original_images[0]), lostmask[0], up_size, bbox_width)]
    tiles += [_lost_boxed(_unnormalize(s), m, up_size, bbox_width)
              for s, m in zip(samples, lostmask)]
    return draw_grid(tiles, save_path, ncol=len(tiles), padding=padding)


def draw_grid_random_lost_with_box(samples, lostmask, save_path, ncol: int = 8,
                                   padding: int = 5, up_size: int = 256, bbox_width: int = 4):
    """Samples with their LOST box drawn."""
    tiles = [_lost_boxed(_unnormalize(s), m, up_size, bbox_width)
             for s, m in zip(samples, lostmask)]
    return draw_grid(tiles, save_path, ncol=ncol, padding=padding)


def draw_grid_stego_chainvis(chain, masks, original_images, save_path, padding: int = 2,
                             alpha: float = 1.0):
    """[K,B,H,W,C] chain → per-sample rows [overlay, x0_t1, ... x0_tK], at
    the chain's own size."""
    chain = _unnormalize(chain)
    k, b = chain.shape[:2]
    size = chain.shape[2]
    tiles = []
    for i in range(b):
        tiles.append(_stego_overlay(_unnormalize(original_images[i]), masks[i], size, alpha))
        tiles += [chain[j, i] for j in range(k)]
    return draw_grid(tiles, save_path, ncol=k + 1, padding=padding)


def draw_grid_lost_chainvis(chain, lostmask, original_images, save_path, padding: int = 2,
                            bbox_width: int = 2):
    """[K,B,H,W,C] chain → per-sample rows [original+box, x0_t...]."""
    chain = _unnormalize(chain)
    k, b = chain.shape[:2]
    size = chain.shape[2]
    tiles = []
    for i in range(b):
        tiles.append(_lost_boxed(_unnormalize(original_images[i]), lostmask[i], size,
                                 bbox_width))
        tiles += [chain[j, i] for j in range(k)]
    return draw_grid(tiles, save_path, ncol=k + 1, padding=padding)


def draw_grid_condscale(samples, save_path, n_samples: int, padding: int = 2):
    """[n_samples * n_scales] flat list → rows = samples, cols = scales."""
    return draw_grid([_unnormalize(s) for s in samples], save_path,
                     ncol=len(samples) // n_samples, padding=padding)


def draw_grid_condscale_stego(masks, original_images, samples, save_path, n_samples: int,
                              padding: int = 2, up_size: int = 256, alpha: float = 1.0):
    """Per sample a separate ``_sub{i}.png`` row: [original, overlay, scales...]."""
    samples = _unnormalize(samples)
    samples = samples.reshape(n_samples, -1, *samples.shape[1:])
    save_path = Path(save_path)
    out = []
    for i in range(n_samples):
        tiles = [upsample_img(_unnormalize(original_images[i]), up_size),
                 _stego_overlay(_unnormalize(original_images[i]), masks[i], up_size, alpha)]
        tiles += [upsample_img(s, up_size) for s in samples[i]]
        out.append(draw_grid(tiles, save_path.with_name(save_path.stem + f"_sub{i}.png"),
                             ncol=len(tiles), padding=padding))
    return out


def draw_grid_scoremix(samples, save_path, ncol: int = 16, padding: int = 2):
    """Score-mix panel: rows = pairs, cols = mixing weights."""
    return draw_grid([_unnormalize(s) for s in samples], save_path, ncol=ncol, padding=padding)


# the histogram's raster: a white 400 × 800 canvas (the JAX figure's 8 × 4
# inches at 100 dpi), a black frame around a plot of HIST_H rows and
# HIST_BINS × HIST_BAR columns, bars in matplotlib's default blue
HIST_BINS, HIST_BAR, HIST_H = 100, 6, 300
HIST_ORIGIN = (350, 100)          # (row of the baseline, column of the first bar)
HIST_COLOR = np.array([31, 119, 180], np.uint8)


def hist_image(data) -> tuple[np.ndarray, np.ndarray]:
    """(uint8 [400, 800, 3] figure, bar heights in pixels) of
    ``np.histogram(data, 100)``: bar i is HIST_BAR columns wide and
    ``round(count_i · HIST_H / max count)`` rows tall."""
    counts, _ = np.histogram(np.asarray(data).ravel(), bins=HIST_BINS)
    img = np.full((400, 800, 3), 255, np.uint8)
    base, left = HIST_ORIGIN
    heights = np.rint(counts * (HIST_H / max(int(counts.max()), 1))).astype(np.int64)
    for i, h in enumerate(heights):
        img[base - h:base, left + i * HIST_BAR:left + (i + 1) * HIST_BAR] = HIST_COLOR
    right = left + HIST_BINS * HIST_BAR
    img[base, left - 1:right + 1] = 0                     # the frame
    img[base - HIST_H - 1, left - 1:right + 1] = 0
    img[base - HIST_H - 1:base + 1, left - 1] = 0
    img[base - HIST_H - 1:base + 1, right] = 0
    return img, heights


def cluster_hist_vis_fn(data, save_path="cluster_hist_vis.png") -> Path:
    """Images-per-cluster histogram (100 bins), rasterised by `hist_image`."""
    save_path = Path(save_path)
    save_path.parent.mkdir(parents=True, exist_ok=True)
    write_png(save_path, hist_image(data)[0])
    return save_path


def condscale_sweep_images(trainer, cond: np.ndarray, scales: Sequence[float], image_size: int,
                           channels: int = 3, layout=None, sampling_method: str = "ddim",
                           num_steps: int = 50, seed: int = 0,
                           x_T: torch.Tensor | None = None) -> np.ndarray:
    """One condition sampled at several guidance weights in ONE sampler
    call: the weights ride as a per-sample [n] tensor through the guided
    denoiser's doubled batch (`guidance.guided_score` broadcasts them).
    ``x_T`` [n, H, W, C] fixes the start; by default it is drawn from a
    generator seeded with ``seed``.  Returns uint8 [len(scales), H, W, C]."""
    from ..training.state import make_sample_fn

    dev = trainer.device
    n = len(scales)
    w = torch.as_tensor(np.asarray(scales, np.float32), device=dev)
    sample = make_sample_fn(
        trainer.model, trainer.diffusion, sampling_method=sampling_method,
        num_steps=num_steps, cond_scale=w, scale_type=trainer.scale_type,
        clip_denoised=trainer.clip_denoised, dtp=trainer.dtp, device=dev)
    cond = np.asarray(cond, np.float32)
    cond_rep = np.repeat(cond[None], n, axis=0)
    layout_rep = None
    if layout is not None:
        layout = layout if isinstance(layout, torch.Tensor) else torch.as_tensor(layout)
        layout_rep = layout.unsqueeze(0).expand(n, *layout.shape).contiguous()
    imgs, _ = sample(trainer._bound_model(use_ema=True),
                     torch.Generator(device=dev).manual_seed(int(seed)), n, image_size, channels,
                     cond=cond_rep, layout=layout_rep, x_T=x_T)
    return imgs.cpu().numpy()

"""PIL's point, enhance and affine operations on uint8 RGB images, in numpy.

The operations RandAugment applies (`selfsup/mae_finetune.py
_rand_augment`), each equal to its PIL counterpart pixel for pixel on
[H, W, 3] uint8 arrays (`tests/test_torch_mae_finetune.py` holds them
against PIL):

  * `autocontrast`, `equalize`, `invert`, `posterize`, `solarize`: the
    look-up tables of ``PIL.ImageOps`` (per channel, from the channel's
    histogram for the first two);
  * `enhance`: ``PIL.ImageEnhance`` ``Color`` / ``Contrast`` /
    ``Brightness`` / ``Sharpness`` — ``Image.blend(degenerate, image,
    factor)`` in float32 (``in1 + factor·(in2 − in1)``, truncated; clipped
    to [0, 255] when the factor extrapolates), the degenerate image being
    the grey conversion (``L = (19595 R + 38470 G + 7471 B + 2¹⁵) >> 16``,
    ITU-R 601-2 in fixed point), the grey image of the rounded mean of that
    conversion, black, or PIL's 3×3 SMOOTH filter (kernel (1 1 1, 1 5 1,
    1 1 1) / 13 in float32, the border copied);
  * `affine`: ``Image.transform(size, AFFINE, (a, b, c, d, e, f),
    BILINEAR)`` — output pixel (x, y) samples the input at
    (a·(x + ½) + b·(y + ½) + c, d·(x + ½) + e·(y + ½) + f), in double
    precision; outside [0, W) × [0, H) it is 0, inside the bilinear mix of
    the four neighbours (clipped to the edge), truncated to uint8;
    `rotate` builds PIL's rotation matrix about the centre.
"""

from __future__ import annotations

import math

import numpy as np

__all__ = ["autocontrast", "equalize", "invert", "posterize", "solarize", "enhance",
           "affine", "rotate", "to_grey"]


def _lut(img: np.ndarray, luts: list[np.ndarray]) -> np.ndarray:
    out = np.empty_like(img)
    for c, lut in enumerate(luts):
        out[..., c] = lut[img[..., c]]
    return out


def autocontrast(img: np.ndarray) -> np.ndarray:
    """``ImageOps.autocontrast(img)`` (cutoff 0): each channel's [lo, hi] to [0, 255]."""
    luts = []
    ix = np.arange(256)
    for c in range(img.shape[-1]):
        h = np.bincount(img[..., c].ravel(), minlength=256)
        nz = np.nonzero(h)[0]
        lo, hi = int(nz[0]), int(nz[-1])
        if hi <= lo:
            luts.append(ix.astype(np.uint8))
            continue
        scale = 255.0 / (hi - lo)
        offset = -lo * scale
        luts.append(np.clip((ix * scale + offset).astype(np.int64), 0, 255).astype(np.uint8))
    return _lut(img, luts)


def equalize(img: np.ndarray) -> np.ndarray:
    """``ImageOps.equalize(img)``: each channel's histogram flattened."""
    luts = []
    for c in range(img.shape[-1]):
        h = np.bincount(img[..., c].ravel(), minlength=256)
        histo = h[h > 0]
        step = (int(histo.sum()) - int(histo[-1])) // 255 if len(histo) > 1 else 0
        if not step:
            luts.append(np.arange(256, dtype=np.uint8))
            continue
        n = step // 2 + np.concatenate([[0], np.cumsum(h)[:-1]])
        luts.append(np.minimum(n // step, 255).astype(np.uint8))
    return _lut(img, luts)


def invert(img: np.ndarray) -> np.ndarray:
    return 255 - img


def posterize(img: np.ndarray, bits: int) -> np.ndarray:
    """Keep the top ``bits`` bits of every channel."""
    return img & np.uint8(~(2 ** (8 - bits) - 1) & 0xFF)


def solarize(img: np.ndarray, threshold: int) -> np.ndarray:
    """Levels at or above ``threshold`` inverted."""
    return np.where(img < threshold, img, 255 - img).astype(np.uint8)


def to_grey(img: np.ndarray) -> np.ndarray:
    """PIL's RGB → L: (19595 R + 38470 G + 7471 B + 0x8000) >> 16."""
    rgb = img.astype(np.int64)
    return ((rgb[..., 0] * 19595 + rgb[..., 1] * 38470 + rgb[..., 2] * 7471 + 0x8000)
            >> 16).astype(np.uint8)


def _smooth(img: np.ndarray) -> np.ndarray:
    """``img.filter(ImageFilter.SMOOTH)``: the 3×3 kernel / 13 in float32 on the
    interior, the one-pixel border copied, rounded and clipped to uint8."""
    out = img.copy()
    h, w = img.shape[:2]
    if h < 3 or w < 3:
        return out
    k = (np.array([1, 1, 1, 1, 5, 1, 1, 1, 1], np.float32) / np.float32(13)).astype(np.float32)
    f = img.astype(np.float32)
    acc = np.zeros((h - 2, w - 2, img.shape[2]), np.float32)
    for r, dy in enumerate((1, 0, -1)):                  # kernel rows meet rows y+1, y, y−1
        row = f[1 + dy:h - 1 + dy]
        part = (row[:, 0:w - 2] * k[3 * r] + row[:, 1:w - 1] * k[3 * r + 1]) \
            + row[:, 2:w] * k[3 * r + 2]
        acc = acc + part
    out[1:-1, 1:-1] = np.where(acc <= 0, 0, np.where(acc >= 255, 255, acc + np.float32(0.5))
                               ).astype(np.uint8)
    return out


def _blend(im1: np.ndarray, im2: np.ndarray, alpha: float) -> np.ndarray:
    """``Image.blend(im1, im2, alpha)``: float32 ``im1 + alpha·(im2 − im1)``,
    truncated (clipped to [0, 255] outside 0 ≤ alpha ≤ 1)."""
    a = np.float32(alpha)
    if a == 0.0:
        return im1.copy()
    if a == 1.0:
        return im2.copy()
    v = im1.astype(np.float32) + a * (im2.astype(np.float32) - im1.astype(np.float32))
    if 0.0 <= a <= 1.0:
        return v.astype(np.uint8)
    return np.where(v <= 0, 0, np.where(v >= 255, 255, v)).astype(np.uint8)


def enhance(img: np.ndarray, kind: str, factor: float) -> np.ndarray:
    """``ImageEnhance.{Color, Contrast, Brightness, Sharpness}(img).enhance(factor)``."""
    if kind == "color":
        degenerate = np.repeat(to_grey(img)[..., None], 3, axis=-1)
    elif kind == "contrast":
        grey = to_grey(img)
        mean = int(np.bincount(grey.ravel(), minlength=256) @ np.arange(256) / grey.size + 0.5)
        degenerate = np.full_like(img, mean)
    elif kind == "brightness":
        degenerate = np.zeros_like(img)
    elif kind == "sharpness":
        degenerate = _smooth(img)
    else:
        raise ValueError(kind)
    return _blend(degenerate, img, factor)


def affine(img: np.ndarray, matrix) -> np.ndarray:
    """``Image.transform(img.size, Image.AFFINE, matrix, Image.BILINEAR)`` (zero fill)."""
    a, b, c, d, e, f = (float(v) for v in matrix)
    h, w = img.shape[:2]
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64) + 0.5
    xin = a * xs + b * ys + c
    yin = d * xs + e * ys + f
    inside = (xin >= 0.0) & (xin < w) & (yin >= 0.0) & (yin < h)
    xin, yin = xin - 0.5, yin - 0.5
    x0 = np.floor(xin).astype(np.int64)
    y0 = np.floor(yin).astype(np.int64)
    dx, dy = (xin - x0)[..., None], (yin - y0)[..., None]
    xa, xb = np.clip(x0, 0, w - 1), np.clip(x0 + 1, 0, w - 1)
    ya = np.clip(y0, 0, h - 1)
    has_b = (y0 + 1 >= 0) & (y0 + 1 < h)
    yb = np.clip(y0 + 1, 0, h - 1)
    src = img.astype(np.float64)
    p, q = src[ya, xa], src[ya, xb]
    v1 = p + (q - p) * dx
    r, s = src[yb, xa], src[yb, xb]
    v2 = np.where(has_b[..., None], r + (s - r) * dx, v1)
    v = v1 + (v2 - v1) * dy
    out = v.astype(np.int64)
    return np.where(inside[..., None], np.clip(out, 0, 255), 0).astype(np.uint8)


def rotate(img: np.ndarray, angle: float) -> np.ndarray:
    """``Image.rotate(angle, resample=BILINEAR)`` (about the centre, same size)."""
    angle = angle % 360.0
    if angle == 0:
        return img.copy()
    h, w = img.shape[:2]
    cx, cy = w / 2, h / 2
    t = -math.radians(angle)
    m = [round(math.cos(t), 15), round(math.sin(t), 15), 0.0,
         round(-math.sin(t), 15), round(math.cos(t), 15), 0.0]
    m[2] = m[0] * -cx + m[1] * -cy
    m[5] = m[3] * -cx + m[4] * -cy
    m[2] += cx
    m[5] += cy
    return affine(img, m)

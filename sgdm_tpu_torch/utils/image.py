"""`read_image`: a PNG or a JPEG by its content, as ``Image.open`` reads it.

The file's magic bytes pick the reader, never its suffix (ImageNet's train
set holds a PNG named ``.JPEG``): PNG → `utils/png.py decode_png`, JPEG →
`utils/jpeg.py decode_jpeg` (host C++).  ``mode`` is what PIL's
``convert(mode)`` gives: "RGB" [H, W, 3] or "L" [H, W] (PIL's L24 of the
RGB: ``(R·19595 + G·38470 + B·7471 + 2^15) >> 16``).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from .jpeg import decode_jpeg, is_jpeg
from .png import decode_png

__all__ = ["read_image", "rgb_to_l"]

_PNG = b"\x89PNG\r\n\x1a\n"


def rgb_to_l(rgb: np.ndarray) -> np.ndarray:
    """PIL's RGB → "L" (L24), uint8 [H, W, 3] → [H, W]."""
    c = rgb.astype(np.int32)
    return ((c[..., 0] * 19595 + c[..., 1] * 38470 + c[..., 2] * 7471 + 0x8000) >> 16
            ).astype(np.uint8)


def read_image(path: str | Path, mode: str = "RGB") -> np.ndarray:
    """uint8 pixels of a PNG or JPEG file, as ``Image.open(path).convert(mode)``."""
    if mode not in ("RGB", "L"):
        raise ValueError(f"mode must be 'RGB' or 'L', got {mode!r}")
    with open(path, "rb") as f:
        data = f.read()
    if is_jpeg(data):
        return decode_jpeg(data, mode, str(path))
    if data[:8] == _PNG:
        rgb = decode_png(data, path=str(path))
        return rgb if mode == "RGB" else rgb_to_l(rgb)
    raise ValueError(f"{path}: neither a PNG nor a JPEG file")

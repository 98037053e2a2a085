"""JPEG files without PIL: the host C++ decoder of ``native/jpeg.cpp``.

`decode_jpeg` gives what ``np.asarray(Image.open(f).convert("RGB"))`` (or
``convert("L")``) gives under PIL built on libjpeg-turbo with its defaults,
bit for bit: sequential (SOF0, SOF1) and progressive (SOF2) Huffman files
of 8-bit samples; grey, YCbCr at any sampling factors in {1, 2}, Adobe RGB,
CMYK and YCCK; the islow IDCT, fancy upsampling and libjpeg's colour
tables.  What it cannot decode the way libjpeg does (arithmetic coding,
12-bit, lossless and hierarchical frames, DNL, other sampling factors, a
progressive file that libjpeg would block-smooth) and truncated or corrupt
data raise `ValueError` naming what was met.

Two ctypes calls a file, each releasing the interpreter lock: the header
(width, height, components) and the decode into a C-contiguous uint8 array
this module allocates.  The decoder keeps no global state, so the loader's
threads decode at once.
"""

from __future__ import annotations

import ctypes

import numpy as np

from ..native import load_library

__all__ = ["jpeg_header", "decode_jpeg", "is_jpeg"]

_ERR_LEN = 256
_MODES = {"RGB": 0, "L": 1}


def is_jpeg(data: bytes) -> bool:
    return data[:3] == b"\xff\xd8\xff"


def jpeg_header(data: bytes, name: str = "") -> tuple[int, int, int]:
    """(width, height, components) of a JPEG file's frame."""
    info = (ctypes.c_int32 * 4)()
    err = ctypes.create_string_buffer(_ERR_LEN)
    if load_library("jpeg").jpeg_header(data, len(data), info, err, _ERR_LEN) != 0:
        raise ValueError(f"{name + ': ' if name else ''}JPEG: {err.value.decode()}")
    return info[0], info[1], info[2]


def decode_jpeg(data: bytes, mode: str = "RGB", name: str = "") -> np.ndarray:
    """uint8 [H, W, 3] (``mode="RGB"``) or [H, W] (``"L"``) of a JPEG file's
    bytes, as PIL's ``Image.open(f).convert(mode)``."""
    if mode not in _MODES:
        raise ValueError(f"mode must be one of {sorted(_MODES)}, got {mode!r}")
    w, h, _ = jpeg_header(data, name)
    out = np.empty((h, w, 3) if mode == "RGB" else (h, w), np.uint8)
    err = ctypes.create_string_buffer(_ERR_LEN)
    if load_library("jpeg").jpeg_decode(data, len(data), out.ctypes.data, _MODES[mode], err,
                                        _ERR_LEN) != 0:
        raise ValueError(f"{name + ': ' if name else ''}JPEG: {err.value.decode()}")
    return out

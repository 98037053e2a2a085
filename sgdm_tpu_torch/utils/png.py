"""PNG files with the standard library alone (zlib + struct) and numpy.

The machine with the card has no PIL, so the port writes and reads its
PNGs here:

  * `write_png` writes 8-bit RGB ([H, W, 3]) or grey ([H, W] or [H, W, 1],
    colour type 0) images in one IDAT, every row under filter 0 (None) or
    under the one ``filter_type`` names (the card has no other PNG writer
    to test the reader's filters on);
  * `read_png` reads what ``Image.open(f).convert("RGB")`` reads from a
    non-interlaced PNG of bit depth 8: colour types 0 (grey), 2 (RGB), 3
    (palette), 4 (grey + alpha) and 6 (RGBA); grey and palette files also
    at 1, 2 and 4 bits (PIL writes palettes of up to 16 colours so); rows
    under any of the five filters
    (None, Sub, Up, Average, Paeth; PIL's encoder picks one per row among
    all but Average, other encoders use Average too).  Grey
    is replicated to RGB and alpha is dropped without compositing, as
    ``convert("RGB")`` does.  Interlaced files and bit depths other than 8
    raise (ROADMAP §1 item 5 lists them as left), and so does a JPEG:
    `utils/image.py read_image` reads either by its content.  With
    ``samples=True`` it returns the stored samples instead, as
    ``np.asarray(Image.open(f))`` gives them: palette indices without the
    palette, grey as [H, W] (1-bit grey as 0/1, 2- and 4-bit grey scaled to
    0-255 as PIL's "L" mode), grey + alpha [H, W, 2], RGB(A) [H, W, 3|4]:
    the id masks of the layout conditions are read so;
  * `resize_nearest` picks the source pixel that PIL's ``Image.NEAREST``
    resize picks.

The rows are unfiltered by one call of ``native/resample.cpp
png_unfilter``; `unfilter` with ``plain=True`` is the Python version it is
held against (None, Sub and Up a whole row at a time with numpy; Average
and Paeth depend on the pixel to the left after its own reconstruction, so
they loop over the row's bytes).
"""

from __future__ import annotations

import struct
import zlib
from functools import lru_cache
from pathlib import Path
from typing import Sequence

import numpy as np

from ..native import load_library

__all__ = ["write_png", "read_png", "decode_png", "resize_nearest", "nearest_index", "unfilter"]

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # colour type -> samples a pixel


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def _filter_rows(px: np.ndarray, bpp: int, kind: int) -> np.ndarray:
    """[H, stride] bytes → the same rows under filter ``kind`` (the
    predictors read the unfiltered neighbours, so every row is one pass)."""
    x = px.astype(np.int16)
    left, up, upleft = np.zeros_like(x), np.zeros_like(x), np.zeros_like(x)
    left[:, bpp:], up[1:], upleft[1:, bpp:] = x[:, :-bpp], x[:-1], x[:-1, :-bpp]
    if kind == 0:
        pred = 0
    elif kind == 1:
        pred = left
    elif kind == 2:
        pred = up
    elif kind == 3:
        pred = (left + up) >> 1
    elif kind == 4:
        p = left + up - upleft
        pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
        pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
    else:
        raise ValueError(f"PNG filter types are 0-4, got {kind}")
    return ((x - pred) & 0xFF).astype(np.uint8)


def write_png(path: str | Path, img: np.ndarray, filter_type: int | Sequence[int] = 0) -> None:
    """An 8-bit PNG of uint8 ``img``: [H, W, 3] as RGB (colour type 2),
    [H, W] or [H, W, 1] as grey (colour type 0).  Signature, IHDR, one zlib
    IDAT of rows each led by its filter byte (``filter_type``, 0-4, or one
    per row), IEND, every chunk with its CRC."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[..., 0]
    if img.ndim == 2:
        colour, ch = 0, 1
    elif img.ndim == 3 and img.shape[2] == 3:
        colour, ch = 2, 3
    else:
        raise ValueError(f"want uint8 [H, W, 3], [H, W, 1] or [H, W], got {img.shape}")
    h, w = img.shape[:2]
    kinds = np.broadcast_to(np.asarray(filter_type, np.uint8), (h,))
    px = img.reshape(h, ch * w)
    rows = np.empty_like(px)
    for kind in np.unique(kinds):  # a row's filter reads the unfiltered rows only
        rows[kinds == kind] = _filter_rows(px, ch, int(kind))[kinds == kind]
    rows = np.concatenate([kinds[:, None], rows], axis=1)
    Path(path).write_bytes(
        _SIGNATURE + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, colour, 0, 0, 0))
        + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + _chunk(b"IEND", b""))


def _unfilter_average(filt: bytes, prior: bytes, bpp: int) -> bytearray:
    out = bytearray(filt)
    for i in range(len(out)):
        left = out[i - bpp] if i >= bpp else 0
        out[i] = (out[i] + ((left + prior[i]) >> 1)) & 0xFF
    return out


def _unfilter_paeth(filt: bytes, prior: bytes, bpp: int) -> bytearray:
    out = bytearray(filt)
    for i in range(len(out)):
        if i >= bpp:
            a, c = out[i - bpp], prior[i - bpp]
        else:
            a = c = 0
        b = prior[i]
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        out[i] = (out[i] + pred) & 0xFF
    return out


def unfilter(raw: np.ndarray, h: int, stride: int, bpp: int, plain: bool = False) -> np.ndarray:
    """[H, 1 + stride] filtered scanlines → [H, stride] bytes."""
    if not plain:
        raw = np.ascontiguousarray(raw, dtype=np.uint8)
        out = np.empty((h, stride), np.uint8)
        bad = load_library("resample").png_unfilter(raw.ctypes.data, h, stride, bpp,
                                                               out.ctypes.data)
        if bad:
            raise ValueError(f"unknown PNG row filter {int(raw[bad - 1, 0])}")
        return out
    out = np.empty((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        kind, line = int(raw[y, 0]), raw[y, 1:]
        if kind == 0:
            cur = line
        elif kind == 1:      # Sub: a running sum of every bpp-th byte, mod 256
            cur = np.cumsum(line.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif kind == 2:      # Up
            cur = line + prior
        elif kind == 3:
            cur = np.frombuffer(_unfilter_average(line.tobytes(), prior.tobytes(), bpp),
                                np.uint8)
        elif kind == 4:
            cur = np.frombuffer(_unfilter_paeth(line.tobytes(), prior.tobytes(), bpp),
                                np.uint8)
        else:
            raise ValueError(f"unknown PNG row filter {kind}")
        out[y] = cur
        prior = out[y]
    return out


def read_png(path: str | Path, samples: bool = False) -> np.ndarray:
    """uint8 [H, W, 3] of a PNG, as ``Image.open(path).convert("RGB")``
    gives it, or with ``samples`` the stored samples; raises on what is not
    read (see the module docstring)."""
    return decode_png(Path(path).read_bytes(), samples, str(path))


def decode_png(data: bytes, samples: bool = False, path: str = "PNG") -> np.ndarray:
    """`read_png` of a file's bytes (``path`` names it in errors)."""
    if data[:3] == b"\xff\xd8\xff":
        raise ValueError(f"{path}: a JPEG file, not a PNG (utils/image.py read_image reads both)")
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG")
    pos, idat, hdr, palette = 8, [], None, None
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])[0] != zlib.crc32(kind + body):
            raise ValueError(f"{path}: bad CRC in {kind!r}")
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + n
    if hdr is None:
        raise ValueError(f"{path}: no IHDR")
    w, h, depth, colour, _, _, interlace = hdr
    if interlace:
        raise ValueError(f"{path}: interlaced PNGs are not read (ROADMAP §1 item 5)")
    packed = depth in (1, 2, 4) and colour in (0, 3)
    if not (depth == 8 and colour in _CHANNELS or packed):
        raise ValueError(f"{path}: only 8-bit PNGs of colour type 0, 2, 3, 4 or 6 (or 1, 2 and "
                         f"4-bit grey and palette ones) are read, got bit depth {depth}, colour "
                         f"type {colour} (ROADMAP §1 item 5)")
    ch = _CHANNELS[colour]
    stride = (w * depth + 7) // 8 if packed else ch * w
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size < h * (1 + stride):
        raise ValueError(f"{path}: image data too short")
    px = unfilter(raw[:h * (1 + stride)].reshape(h, 1 + stride), h, stride, ch)
    if packed:  # samples packed high bit first, every row padded to a byte
        bits = np.unpackbits(px, axis=1).reshape(h, -1, depth)[:, :w]
        px = (bits << np.arange(depth - 1, -1, -1, dtype=np.uint8)).sum(-1, dtype=np.uint8)
        if colour == 0 and not (samples and depth == 1):  # PIL reads 1-bit grey as 0/1
            px *= np.uint8(255 // (2 ** depth - 1))
    px = px.reshape(h, w, ch)
    if samples:
        return px[..., 0] if ch == 1 else px
    if colour == 3:
        if palette is None:
            raise ValueError(f"{path}: palette image without PLTE")
        full = np.zeros((256, 3), np.uint8)   # indices past the palette read as black
        full[:len(palette)] = palette[:256]
        return full[px[..., 0]]
    if colour in (0, 4):
        return np.repeat(px[..., :1], 3, axis=2)
    return np.ascontiguousarray(px[..., :3])


@lru_cache(maxsize=256)
def nearest_index(n_in: int, n_out: int) -> np.ndarray:
    """The source index of each output pixel of PIL's NEAREST resize along
    one axis (read-only: the arrays are shared)."""
    # PIL's affine nearest scale: the source coordinate of output pixel i is
    # the running sum (n_in / n_out) / 2 + i · (n_in / n_out), accumulated in
    # double step by step and truncated; the closed form differs from it at
    # some ratios
    step = n_in / n_out
    pos, out = step * 0.5, np.empty(n_out, np.int64)
    for i in range(n_out):
        out[i] = int(pos)
        pos += step
    out.flags.writeable = False
    return out


def resize_nearest(img: np.ndarray, height: int, width: int) -> np.ndarray:
    """[H, W, ...] → [height, width, ...], each pixel the source pixel that
    ``Image.fromarray(img).resize((width, height), Image.NEAREST)`` picks."""
    return img[nearest_index(img.shape[0], height)][:, nearest_index(img.shape[1], width)]

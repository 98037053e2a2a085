"""Remake the JPEG decoder's fixtures in this folder (needs PIL and numpy).

    python tests/fixtures/jpeg/make_fixtures.py

Each ``<name>.jpg`` is written by PIL from smooth synthetic content made
from a fixed seed, and ``<name>.png`` beside it holds PIL's decode of it,
``np.asarray(Image.open(jpg).convert("RGB"))`` (grey files: ``"L"``),
written by the port's `utils/png.py write_png` (Paeth rows).  The port's
decoder must give the PNG's pixels bit for bit (`tests/test_torch_jpeg.py`,
`chip_smoke.py --phases build,images`).  The JPEGs depend on the libjpeg
PIL was built with, so a remake may change their bytes; the decodes are
held against the PIL of the machine that wrote them.
"""

import sys
from pathlib import Path

import numpy as np
from PIL import Image

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parents[2]))
from sgdm_tpu_torch.utils.png import write_png  # noqa: E402

# name: (height, width, channels, save options)
FIXTURES = {
    "grey_q75": (48, 64, 1, dict(quality=75)),
    "s444_q95": (40, 56, 3, dict(quality=95, subsampling=0)),
    "s422_q50": (40, 56, 3, dict(quality=50, subsampling=1)),
    "s420_q75": (40, 56, 3, dict(quality=75, subsampling=2)),
    "progressive_420": (72, 96, 3, dict(quality=80, subsampling=2, progressive=True)),
    "progressive_grey": (50, 70, 1, dict(quality=85, progressive=True)),
    "restart_420": (48, 80, 3, dict(quality=75, subsampling=2, restart_marker_blocks=3)),
    "odd_37x23_420": (23, 37, 3, dict(quality=90, subsampling=2)),
    "odd_37x23_422_progressive": (23, 37, 3, dict(quality=60, subsampling=1, progressive=True)),
    "cmyk_adobe": (40, 52, 4, dict(quality=90)),
    "voc_500x375_a": (375, 500, 3, dict(quality=75)),
    "voc_500x375_b": (375, 500, 3, dict(quality=90)),
    "voc_375x500_a": (500, 375, 3, dict(quality=75)),
    "voc_375x500_b": (500, 375, 3, dict(quality=85, progressive=True)),
    "coco_640x480": (480, 640, 3, dict(quality=80)),
    "coco_480x640_grey": (640, 480, 1, dict(quality=80)),
}


def content(h: int, w: int, c: int, seed: int) -> np.ndarray:
    """Smooth synthetic content: soft-edged discs over a gradient."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    a = (rng.uniform(40, 200, c) + 60 * (x / w - y / h)[..., None]).astype(np.float64)
    for _ in range(6):
        cy, cx, r = rng.uniform(0, h), rng.uniform(0, w), rng.uniform(0.1, 0.4) * max(h, w)
        m = np.clip(1 - np.hypot(y - cy, x - cx) / r, 0, 1)[..., None]
        a = a * (1 - m) + rng.uniform(0, 255, c) * m
    a = np.clip(a, 0, 255).astype(np.uint8)
    return a[..., 0] if c == 1 else a


def main() -> None:
    for seed, (name, (h, w, c, opts)) in enumerate(FIXTURES.items()):
        arr = content(h, w, c, seed)
        im = Image.fromarray(arr, "CMYK" if c == 4 else None)
        jpg = HERE / f"{name}.jpg"
        im.save(jpg, "JPEG", **opts)
        mode = "L" if c == 1 else "RGB"
        write_png(HERE / f"{name}.png", np.asarray(Image.open(jpg).convert(mode)), filter_type=4)
        print(name, jpg.stat().st_size, (HERE / f"{name}.png").stat().st_size)


if __name__ == "__main__":
    main()

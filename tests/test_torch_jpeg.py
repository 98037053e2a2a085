"""The port's JPEG decoder (`sgdm_tpu_torch/utils/jpeg.py`, host C++ in
`native/jpeg.cpp`) against PIL, bit for bit.

  * every committed fixture (`tests/fixtures/jpeg/`, remade by its
    `make_fixtures.py`) decodes to the PNG of PIL's decode beside it;
  * files PIL writes here from a seed, across grey, 4:4:4, 4:2:2 and 4:2:0,
    sequential and progressive, restart intervals, qualities 50 to 100,
    sizes that are not whole MCUs, Adobe CMYK and Adobe RGB, decode equal to
    ``Image.open(f).convert("RGB")`` and ``convert("L")``;
  * what it cannot decode as libjpeg does raises `ValueError` naming it:
    arithmetic coding, 12-bit, lossless, a DNL height, sampling factors
    past 2, a progressive file whose scans leave AC bits unsent (libjpeg
    would smooth it), a truncated file (PIL raises on that one too);
  * `utils/image.py read_image` picks the reader by content, not suffix;
    threads decode at once.
"""

import io
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
from PIL import Image, ImageFile

from sgdm_tpu_torch.utils.image import read_image, rgb_to_l
from sgdm_tpu_torch.utils.jpeg import decode_jpeg, jpeg_header
from sgdm_tpu_torch.utils.png import read_png, write_png

FIXTURES = Path(__file__).resolve().parent / "fixtures" / "jpeg"
FIXTURE_NAMES = sorted(p.stem for p in FIXTURES.glob("*.jpg"))


def test_the_fixtures_are_all_there():
    assert len(FIXTURE_NAMES) == 16
    assert all((FIXTURES / f"{n}.png").exists() for n in FIXTURE_NAMES)
    assert sum(p.stat().st_size for p in FIXTURES.iterdir()) < 1 << 20


@pytest.mark.parametrize("name", FIXTURE_NAMES)
def test_fixture_decodes_to_pils_decode(name):
    data = (FIXTURES / f"{name}.jpg").read_bytes()
    want = read_png(FIXTURES / f"{name}.png", samples=True)
    mode = "L" if want.ndim == 2 else "RGB"
    got = decode_jpeg(data, mode)
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert np.array_equal(got, want)


def _content(rng, h, w, c):
    y, x = np.mgrid[0:h, 0:w]
    planes = [127 + 70 * np.sin(x * rng.uniform(0.01, 0.2) + y * rng.uniform(0.01, 0.2) + k)
              + rng.normal(0, 12, (h, w)) for k in range(c)]
    a = np.clip(np.stack(planes, -1), 0, 255).astype(np.uint8)
    return a[..., 0] if c == 1 else a


def _jpeg(rng, h, w, c, **opts) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(_content(rng, h, w, c), "CMYK" if c == 4 else None).save(buf, "JPEG", **opts)
    return buf.getvalue()


# (height, width, components, save options)
CASES = {
    "grey": (45, 61, 1, dict(quality=75)),
    "grey-progressive": (45, 61, 1, dict(quality=90, progressive=True)),
    "444-q95": (33, 50, 3, dict(quality=95, subsampling=0)),
    "422-q50": (33, 50, 3, dict(quality=50, subsampling=1)),
    "420-q75": (33, 50, 3, dict(quality=75, subsampling=2)),
    "420-q100": (40, 40, 3, dict(quality=100, subsampling=2)),
    "444-progressive": (70, 33, 3, dict(quality=85, subsampling=0, progressive=True)),
    "422-progressive": (70, 33, 3, dict(quality=70, subsampling=1, progressive=True)),
    "420-progressive": (70, 33, 3, dict(quality=80, subsampling=2, progressive=True)),
    "420-restart-blocks": (50, 83, 3, dict(quality=75, subsampling=2, restart_marker_blocks=5)),
    "444-restart-rows": (50, 83, 3, dict(quality=75, subsampling=0, restart_marker_rows=1)),
    "420-progressive-restart": (50, 83, 3, dict(quality=75, progressive=True,
                                                restart_marker_blocks=2)),
    "420-37x23": (23, 37, 3, dict(quality=90, subsampling=2)),
    "422-1x1": (1, 1, 3, dict(quality=90, subsampling=1)),
    "420-2x5": (5, 2, 3, dict(quality=90, subsampling=2)),
    "420-3x17": (17, 3, 3, dict(quality=90, subsampling=2)),
    "420-voc": (375, 500, 3, dict(quality=80)),
    "cmyk": (31, 47, 4, dict(quality=90)),
    "cmyk-progressive": (31, 47, 4, dict(quality=90, progressive=True)),
    "adobe-rgb": (31, 47, 3, dict(quality=90, keep_rgb=True)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_decode_equals_pil(case):
    h, w, c, opts = CASES[case]
    data = _jpeg(np.random.default_rng(sorted(CASES).index(case)), h, w, c, **opts)
    assert jpeg_header(data) == (w, h, c)
    for mode in ("RGB", "L"):
        want = np.asarray(Image.open(io.BytesIO(data)).convert(mode))
        assert np.array_equal(decode_jpeg(data, mode), want), mode


def _patched(data: bytes, marker: bytes, offset: int, value: int) -> bytes:
    """``data`` with the byte ``offset`` past ``marker`` set to ``value``."""
    i = data.index(marker)
    out = bytearray(data)
    out[i + offset] = value
    return bytes(out)


def _progressive_dc_only(rng) -> bytes:
    """A progressive file cut after its first scan (DC only), then EOI."""
    data = _jpeg(rng, 40, 40, 3, quality=80, progressive=True)
    first = data.index(b"\xff\xda")
    second = data.index(b"\xff\xda", first + 2)
    return data[:second] + b"\xff\xd9"


@pytest.mark.parametrize("case,match", [
    ("arithmetic", "arithmetic"), ("12-bit", "12-bit"), ("lossless", "lossless"),
    ("dnl-height", "DNL"), ("sampling-3", "sampling factors"), ("unsent-ac", "AC bits unsent"),
    ("truncated-entropy", "truncated"), ("truncated-header", "truncated"),
    ("not-jpeg", "SOI"),
])
def test_refuses_what_it_does_not_decode(case, match):
    rng = np.random.default_rng(7)
    base = _jpeg(rng, 40, 56, 3, quality=80)
    sof = b"\xff\xc0"
    data = {
        "arithmetic": lambda: _patched(base, sof, 1, 0xC9),
        "12-bit": lambda: _patched(base, sof, 4, 12),
        "lossless": lambda: _patched(base, sof, 1, 0xC3),
        "dnl-height": lambda: _patched(_patched(base, sof, 5, 0), sof, 6, 0),
        "sampling-3": lambda: _patched(base, sof, 11, 0x31),
        "unsent-ac": lambda: _progressive_dc_only(rng),
        "truncated-entropy": lambda: base[:len(base) * 2 // 3],
        "truncated-header": lambda: base[:base.index(b"\xff\xda") + 4],
        "not-jpeg": lambda: b"\x89PNG" + base[4:],
    }[case]()
    with pytest.raises(ValueError, match=match):
        decode_jpeg(data)


def test_pil_refuses_the_truncated_file_too():
    base = _jpeg(np.random.default_rng(7), 40, 56, 3, quality=80)
    assert not ImageFile.LOAD_TRUNCATED_IMAGES
    with pytest.raises(OSError, match="truncated"):
        Image.open(io.BytesIO(base[:len(base) * 2 // 3])).convert("RGB")


def test_read_image_goes_by_content(tmp_path):
    rng = np.random.default_rng(3)
    img = _content(rng, 20, 30, 3)
    Image.fromarray(img).save(tmp_path / "a.JPEG", "PNG")          # a PNG named .JPEG
    (tmp_path / "b.png").write_bytes(_jpeg(rng, 21, 13, 3, quality=90))   # a JPEG named .png
    write_png(tmp_path / "c.jpg", img[..., 0])
    assert np.array_equal(read_image(tmp_path / "a.JPEG"), img)
    assert np.array_equal(read_image(tmp_path / "a.JPEG", "L"),
                          np.asarray(Image.fromarray(img).convert("L")))
    for name in ("b.png", "c.jpg"):
        for mode in ("RGB", "L"):
            want = np.asarray(Image.open(tmp_path / name).convert(mode))
            assert np.array_equal(read_image(tmp_path / name, mode), want), (name, mode)
    assert np.array_equal(rgb_to_l(img), np.asarray(Image.fromarray(img).convert("L")))
    (tmp_path / "d.jpg").write_bytes(b"GIF89a")
    with pytest.raises(ValueError, match="neither"):
        read_image(tmp_path / "d.jpg")
    with pytest.raises(ValueError, match="read_image"):
        read_png(tmp_path / "b.png")


def test_threads_decode_at_once():
    datas = [(FIXTURES / f"{n}.jpg").read_bytes() for n in FIXTURE_NAMES if "voc" in n]
    want = [decode_jpeg(d) for d in datas]
    with ThreadPoolExecutor(8) as pool:
        got = list(pool.map(decode_jpeg, datas * 8))
    assert all(np.array_equal(g, want[i % len(datas)]) for i, g in enumerate(got))

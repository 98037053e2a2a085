"""The port's PNG reader and writer (`sgdm_tpu_torch/utils/png.py`) against
PIL: FID reference directories are written by PIL (`sgdm_tpu/eval/harness.py
generate_fid_reference_dir`), whose encoder picks a filter per row, and the
JAX engine reads them with ``Image.open(f).convert("RGB")``.

  * PIL-written RGB, L, LA, P and RGBA files read bit for bit as PIL
    converts them; PIL's adaptive encoder covers filters 0, 1, 2 and 4 (it
    never picks Average);
  * every colour type (0, 2, 3, 4, 6) under every filter (0-4), encoded
    here row by row, read as PIL decodes it;
  * `write_png` under every filter, grey and RGB, decoded by PIL;
  * palette and grey files with a tRNS chunk read as PIL converts them
    (transparency dropped);
  * interlaced files, 16-bit files and JPEGs raise.
"""

import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from sgdm_tpu_torch.utils.png import _chunk, _filter_rows, read_png, write_png

MODES = ["RGB", "L", "LA", "P", "RGBA"]


def _pattern(kind: str, size: int = 48) -> np.ndarray:
    """uint8 [S, S, 4]: bands of smooth gradients and noise ("mixed"), or
    planes, which PIL's encoder codes under Paeth ("plane")."""
    yy, xx = np.mgrid[0:size, 0:size]
    rng = np.random.default_rng(size)
    if kind == "plane":
        return np.stack([128 + xx - yy, 100 + 2 * xx - 2 * yy, 90 + xx // 2 - yy,
                         200 - xx], -1).astype(np.uint8)
    smooth = np.stack([(xx * 4) % 256, (yy * 4) % 256, ((xx + yy) * 2) % 256, (xx * yy) % 256], -1)
    noise = rng.integers(0, 256, (size, size, 4))
    return np.where((yy // 8 % 2)[..., None] == 0, smooth, noise).astype(np.uint8)


def _pil_image(mode: str, kind: str) -> Image.Image:
    img = _pattern(kind)
    if mode == "P":
        return Image.fromarray(img[..., :3]).convert("P", palette=Image.ADAPTIVE, colors=200)
    return Image.fromarray(img, "RGBA").convert(mode)


def _filters(path) -> set:
    data = path.read_bytes()
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", data[pos + 8:pos + 8 + n])
        elif kind == b"IDAT":
            idat.append(data[pos + 8:pos + 8 + n])
        pos += 12 + n
    w, h, _, colour = hdr[:4]
    ch = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[colour]
    return set(np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
               .reshape(h, 1 + ch * w)[:, 0].tolist())


def _pil_rgb(path) -> np.ndarray:
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


@pytest.mark.parametrize("kind", ["mixed", "plane"])
@pytest.mark.parametrize("mode", MODES)
def test_pil_written_file_reads_as_pil_converts(tmp_path, mode, kind):
    p = tmp_path / "a.png"
    _pil_image(mode, kind).save(p)
    got = read_png(p)
    assert got.dtype == np.uint8 and got.shape == (48, 48, 3)
    np.testing.assert_array_equal(got, _pil_rgb(p))


def test_pil_fixtures_cover_the_filters_pil_writes(tmp_path):
    seen = set()
    for mode in MODES:
        for kind in ("mixed", "plane"):
            p = tmp_path / f"{mode}_{kind}.png"
            _pil_image(mode, kind).save(p)
            seen |= _filters(p)
    assert seen == {0, 1, 2, 4}


def _encode(path, px: np.ndarray, colour: int, kind: int, palette=None, trns=None):
    """A PNG of the bytes ``px`` [H, W, ch], every row under filter ``kind``."""
    h, w, ch = px.shape
    rows = _filter_rows(px.reshape(h, w * ch), ch, kind)
    rows = np.concatenate([np.full((h, 1), kind, np.uint8), rows], axis=1)
    body = _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, colour, 0, 0, 0))
    if palette is not None:
        body += _chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    if trns is not None:
        body += _chunk(b"tRNS", trns)
    body += _chunk(b"IDAT", zlib.compress(rows.tobytes())) + _chunk(b"IEND", b"")
    path.write_bytes(b"\x89PNG\r\n\x1a\n" + body)


@pytest.mark.parametrize("kind", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("colour", [0, 2, 3, 4, 6])
def test_every_colour_type_under_every_filter(tmp_path, colour, kind):
    rng = np.random.default_rng(10 * colour + kind)
    ch = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[colour]
    px = np.concatenate([_pattern("plane", 24)[..., :ch],
                         rng.integers(0, 256, (8, 24, ch)).astype(np.uint8)])  # [32, 24, ch]
    palette = None
    if colour == 3:
        px = px % 40
        palette = rng.integers(0, 256, (40, 3))
    p = tmp_path / "f.png"
    _encode(p, px, colour, kind, palette)
    assert _filters(p) == {kind}
    got = read_png(p)
    np.testing.assert_array_equal(got, _pil_rgb(p))
    if colour == 3:
        want = palette[px[..., 0]]
    elif colour in (0, 4):
        want = np.repeat(px[..., :1], 3, axis=2)
    else:
        want = px[..., :3]
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("shape", [(17, 13, 3), (17, 13), (9, 11, 1)])
def test_writer_under_every_filter_decodes_in_pil(tmp_path, shape, kind):
    img = np.random.default_rng(kind).integers(0, 256, shape, dtype=np.uint8)
    p = tmp_path / "w.png"
    write_png(p, img, filter_type=kind)
    assert _filters(p) == {kind}
    with Image.open(p) as im:
        assert im.mode == ("RGB" if len(shape) == 3 and shape[2] == 3 else "L")
        np.testing.assert_array_equal(np.asarray(im), img.reshape(im.size[1], im.size[0], -1)
                                      .squeeze(-1) if im.mode == "L" else img)
    want = img if img.ndim == 3 and img.shape[2] == 3 else np.repeat(
        img.reshape(*img.shape[:2], 1), 3, axis=2)
    np.testing.assert_array_equal(read_png(p), want)


def test_transparency_is_dropped_as_pil_converts(tmp_path):
    img = _pattern("mixed")
    pal = Image.fromarray(img[..., :3]).convert("P", palette=Image.ADAPTIVE, colors=16)
    pal.save(tmp_path / "p.png", transparency=3)
    grey = Image.fromarray(img[..., 0])
    grey.save(tmp_path / "g.png", transparency=7)
    for name in ("p.png", "g.png"):
        with Image.open(tmp_path / name) as im:
            assert "transparency" in im.info
        np.testing.assert_array_equal(read_png(tmp_path / name), _pil_rgb(tmp_path / name))


@pytest.mark.parametrize("colours", [2, 4, 16])
def test_packed_palettes_and_grey_read_as_pil_converts(tmp_path, colours):
    """PIL writes palettes of up to 16 colours, and 1-bit images, at 1, 2 or 4 bits a pixel."""
    img = _pattern("mixed")
    Image.fromarray(img[..., :3]).convert("P", palette=Image.ADAPTIVE, colors=colours).save(
        tmp_path / "p.png")
    Image.fromarray(img[..., 0]).convert("1").save(tmp_path / "b.png")
    rng = np.random.default_rng(colours)
    depth = {2: 1, 4: 2, 16: 4}[colours]
    ids = rng.integers(0, colours, (5, 11)).astype(np.uint8)
    bits = np.unpackbits(ids[..., None], axis=-1)[..., 8 - depth:].reshape(5, -1)
    _encode(tmp_path / "g.png", np.packbits(bits, axis=1)[..., None], 0, 4)   # grey, Paeth
    raw = bytearray((tmp_path / "g.png").read_bytes())
    raw[16:24] = struct.pack(">II", 11, 5)
    raw[24] = depth
    raw[29:33] = struct.pack(">I", zlib.crc32(bytes(raw[12:29])) & 0xFFFFFFFF)
    (tmp_path / "g.png").write_bytes(bytes(raw))
    for name in ("p.png", "b.png", "g.png"):
        np.testing.assert_array_equal(read_png(tmp_path / name), _pil_rgb(tmp_path / name))


def _interlaced(path):
    write_png(path, np.zeros((4, 4, 3), np.uint8))
    raw = bytearray(path.read_bytes())
    raw[28] = 1                                    # IHDR's interlace byte
    raw[29:33] = struct.pack(">I", zlib.crc32(bytes(raw[12:29])) & 0xFFFFFFFF)
    path.write_bytes(bytes(raw))


@pytest.mark.parametrize("case,match", [("interlaced", "interlaced"), ("16-bit", "8-bit"),
                                        ("rgb16", "8-bit"), ("jpeg", "JPEG")])
def test_refuses_what_it_does_not_read(tmp_path, case, match):
    p = tmp_path / "x.png"
    if case == "interlaced":
        _interlaced(p)
    elif case == "16-bit":
        Image.fromarray(np.full((4, 4), 1000, np.uint16)).save(p)
    elif case == "rgb16":
        _encode(p, np.zeros((2, 2, 6), np.uint8), 2, 0)       # bit depth 8 patched to 16
        raw = bytearray(p.read_bytes())
        raw[24] = 16
        raw[29:33] = struct.pack(">I", zlib.crc32(bytes(raw[12:29])) & 0xFFFFFFFF)
        p.write_bytes(bytes(raw))
    else:
        Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(p, format="JPEG")
    with pytest.raises(ValueError, match=match):
        read_png(p)

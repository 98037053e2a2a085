"""``--mask-dir`` of the port's `generate` against the JAX package's
`_build_layouts` (`sgdm_tpu/generate.py`), which reads the masks with PIL:

  * `read_png(samples=True)` gives what ``np.asarray(Image.open(p))`` gives
    for PIL-written palette (4- and 8-bit), grey (1- and 8-bit), grey +
    alpha, RGB and RGBA files, and 2- and 4-bit grey written here;
  * `resize_nearest` picks PIL's ``Image.NEAREST`` pixels at ratios that are
    not whole numbers;
  * `masks_to_layouts`' one-hot layouts and n-hot conds equal
    `_build_layouts`' arrays (fewer masks than samples, cycled, and more);
    an id ≥ layout_dim raises in both;
  * `generate(mask_dir=…)` gives the images of `generate(layout=…)` with
    those arrays, bit for bit, and so does ``--mask-dir`` on the CLI.
"""

import struct
import types
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from sgdm_tpu.generate import _build_layouts
from sgdm_tpu_torch.data import transforms as tt
from sgdm_tpu_torch.generate import generate, main as generate_main, masks_to_layouts
from sgdm_tpu_torch.models.factory import UNETCA_FAST_VOC64
from sgdm_tpu_torch.utils.png import read_png, resize_nearest, write_png

from torch_port_common import one_torch_thread  # noqa: F401

K = 5
PX = 16


def _ids(rng, h, w, k=K, ignore=True):
    m = rng.integers(0, k, (h, w)).astype(np.uint8)
    if ignore:
        m[rng.random((h, w)) < 0.1] = 255   # the ignore label
    return m


def _grey_png(path, samples: np.ndarray, depth: int):
    """A grey PNG of ``depth``-bit samples, rows under filter 0."""
    h, w = samples.shape
    bits = np.unpackbits(samples[..., None], axis=-1)[..., 8 - depth:].reshape(h, -1)
    rows = np.packbits(bits, axis=1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1).tobytes()
    chunk = lambda k, b: (struct.pack(">I", len(b)) + k + b
                          + struct.pack(">I", zlib.crc32(k + b) & 0xFFFFFFFF))
    path.write_bytes(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth,
                                                                       0, 0, 0, 0))
                     + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


@pytest.mark.parametrize("kind", ["P4", "P8", "L", "1", "LA", "RGB", "RGBA", "L2", "L4"])
def test_stored_samples_read_as_pil_gives_them(tmp_path, kind):
    rng = np.random.default_rng(len(kind))
    p = tmp_path / "m.png"
    if kind in ("L2", "L4"):
        depth = int(kind[1])
        _grey_png(p, rng.integers(0, 2 ** depth, (7, 13)).astype(np.uint8), depth)
    elif kind.startswith("P"):
        colours = 12 if kind == "P4" else 40
        im = Image.fromarray(rng.integers(0, colours, (9, 14)).astype(np.uint8), "L").convert("P")
        im.putpalette(rng.integers(0, 256, 3 * colours).astype(np.uint8).tolist())
        im.save(p)
    elif kind == "1":
        Image.fromarray(rng.random((9, 14)) < 0.5).save(p)
    else:
        ch = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4}[kind]
        Image.fromarray(rng.integers(0, 256, (9, 14, ch)).astype(np.uint8).squeeze(), kind).save(p)
    with Image.open(p) as im:
        want = np.asarray(im)
    got = read_png(p, samples=True)
    np.testing.assert_array_equal(got, want.astype(np.uint8))
    assert got.shape == want.shape


@pytest.mark.parametrize("hw,out", [((24, 24), (16, 16)), ((48, 80), (64, 64)),
                                    ((100, 37), (64, 48)), ((21, 64), (100, 100)),
                                    ((64, 64), (48, 48)), ((333, 129), (64, 64))])
def test_resize_nearest_picks_pils_pixels(hw, out):
    rng = np.random.default_rng(hw[0])
    for a in (rng.integers(0, 256, hw).astype(np.uint8),
              rng.integers(0, 256, (*hw, 3)).astype(np.uint8)):
        want = np.asarray(Image.fromarray(a).resize((out[1], out[0]), Image.NEAREST))
        np.testing.assert_array_equal(resize_nearest(a, *out), want)


def _write_masks(d, rng):
    """Four masks in name order: palette, grey, RGB (ids in R) at 24 px and
    grey at the sample size."""
    d.mkdir()
    a, b, c, e = (_ids(rng, 24, 24), _ids(rng, 24, 24), _ids(rng, 24, 24), _ids(rng, PX, PX))
    pal = Image.fromarray(a, "L").convert("P")
    pal.putpalette((np.arange(768) % 251).astype(np.uint8).tolist())
    pal.save(d / "a.png")
    Image.fromarray(b, "L").save(d / "b.png")
    Image.fromarray(np.stack([c, 255 - c, c // 2], -1), "RGB").save(d / "c.png")
    write_png(d / "d.png", e)   # the port's own writer: what chip_smoke writes
    return d


@pytest.mark.parametrize("n", [3, 10])
@pytest.mark.parametrize("method", ["stegoclusterlayout", "layout"])
def test_layouts_equal_jax_build_layouts(tmp_path, method, n):
    d = _write_masks(tmp_path / "masks", np.random.default_rng(3))
    cond_dim = K + 2 if method == "stegoclusterlayout" else 0
    stub = types.SimpleNamespace(condition_cfg={method: {"how": "oracle", "layout_dim": K}})
    want_l, want_a = _build_layouts(stub, method, n, PX, str(d), None, None, cond_dim)
    got_l, got_a = masks_to_layouts(d, n, PX, K, cond_dim if method == "stegoclusterlayout" else 0)
    assert got_l.dtype == np.float32 and got_l.shape == (n, PX, PX, K)
    np.testing.assert_array_equal(got_l, want_l)
    if method == "stegoclusterlayout":
        np.testing.assert_array_equal(got_a, want_a)
        assert got_a.shape == (n, cond_dim)
    else:
        assert got_a is None and want_a is None


def test_id_beyond_layout_dim_raises(tmp_path):
    d = tmp_path / "masks"
    d.mkdir()
    m = _ids(np.random.default_rng(4), PX, PX)
    m[3, 3] = K
    Image.fromarray(m, "L").save(d / "a.png")
    stub = types.SimpleNamespace(condition_cfg={"layout": {"how": "oracle", "layout_dim": K}})
    with pytest.raises(SystemExit, match="layout_dim"):
        _build_layouts(stub, "layout", 2, PX, str(d), None, None, 0)
    with pytest.raises(ValueError, match=f"mask id {K} >= layout_dim {K}"):
        masks_to_layouts(d, 2, PX, K)
    with pytest.raises(IndexError):
        tt.segmask_to_ids(m, K)
    with pytest.raises(ValueError, match="no .png"):
        masks_to_layouts(tmp_path, 2, PX, K)


def test_transforms_equal_jax():
    from sgdm_tpu.data import transforms as jt

    m = _ids(np.random.default_rng(5), 9, 7)
    f2c = {i: i // 2 for i in range(K)}
    for fc in (None, f2c):
        np.testing.assert_array_equal(tt.segmask_to_onehot(m, K, fc),
                                      jt.segmask_to_onehot(m, K, fc))
        np.testing.assert_array_equal(tt.segmask_to_ids(m, K, fc), jt.segmask_to_ids(m, K, fc))
        np.testing.assert_array_equal(tt.mask_to_attr_nhot(m, K + 1, fc),
                                      jt.mask_to_attr_nhot(m, K + 1, fc))
    box = np.asarray([1.5, 2.0, 6.0, 5.9])
    np.testing.assert_array_equal(tt.bbox_to_mask((8, 7), box), jt.bbox_to_mask((8, 7), box))


CA = dict(UNETCA_FAST_VOC64, image_size=PX, model_channels=32, channel_mult=(1, 2),
          num_res_blocks=1, attention_resolutions=(2,), num_heads=4, context_dim=8,
          cond_token_num=1, cond_dim=K, layout_dim=K, dropout=0.0)


def test_generate_mask_dir_equals_layouts(tmp_path, one_torch_thread, capsys):
    d = _write_masks(tmp_path / "masks", np.random.default_rng(6))
    kw = dict(n=6, batch_size=4, steps=4, cond_scale=2.0, seed=0, device="cpu",
              dtype=torch.float32)
    imgs = generate(CA, mask_dir=d, **kw)
    layouts, attrs = masks_to_layouts(d, 6, PX, K, K)
    torch.testing.assert_close(generate(CA, layout=layouts, cond=attrs, **kw), imgs,
                               rtol=0, atol=0)
    # stegoclusterlayout's cond is the n-hot of each mask's classes
    torch.testing.assert_close(generate(CA, layout=layouts, **kw), imgs, rtol=0, atol=0)
    with pytest.raises(ValueError, match="mask_dir is for the layout methods"):
        generate(CA, mask_dir=d, layout=layouts, **kw)
    generate_main(["--family", "unetca", "--mask-dir", str(d), "--image-size", str(PX),
                   "--model-channels", "32", "--cond-dim", str(K), "--layout-dim", str(K),
                   "--n", "2", "--steps", "4", "--device", "cpu", "--sampler", "plms",
                   "--out", str(tmp_path / "out")])
    assert "sampled (2, 16, 16, 3)" in capsys.readouterr().out
    assert len(list((tmp_path / "out").glob("*.png"))) == 2

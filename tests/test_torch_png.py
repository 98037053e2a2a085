"""The port writes its sample PNGs with the standard library alone
(`sgdm_tpu_torch/generate.py write_png`, `read_png`): the machine with the
card has no PIL.  PIL, which this host has, decodes the files as the check;
`generate(out_dir=...)` names the files as `sgdm_tpu/generate.py` does
(``{i:06d}_c{id}.png`` with ids, ``{i:06d}.png`` without, in sample order)."""

import ast
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from sgdm_tpu_torch.generate import _write_pngs, generate, read_png, write_png
from sgdm_tpu_torch.models.factory import UNET_FAST_IN64

ROOT = Path(__file__).resolve().parents[1]
TINY = dict(UNET_FAST_IN64, image_size=8, model_channels=32, channel_mult=[1],
            num_res_blocks=1, attention_resolutions=[], cond_dim=4)


@pytest.mark.parametrize("h,w", [(1, 1), (7, 5), (5, 7), (64, 64)])
def test_written_png_decodes_to_the_array(tmp_path, h, w):
    img = np.random.default_rng(h * 100 + w).integers(0, 256, (h, w, 3), dtype=np.uint8)
    p = tmp_path / "a.png"
    write_png(p, img)
    with Image.open(p) as im:
        assert im.mode == "RGB" and im.size == (w, h)
        got = np.asarray(im)
    np.testing.assert_array_equal(got, img)
    np.testing.assert_array_equal(read_png(p), img)


def test_reader_refuses_what_it_does_not_read(tmp_path):
    img = np.zeros((4, 4, 3), np.uint8)
    Image.fromarray(img).convert("L").save(tmp_path / "g.png")
    with pytest.raises(ValueError, match="8-bit RGB"):
        read_png(tmp_path / "g.png")
    (tmp_path / "x.png").write_bytes(b"not a png")
    with pytest.raises(ValueError, match="not a PNG"):
        read_png(tmp_path / "x.png")
    write_png(tmp_path / "c.png", img)
    raw = bytearray((tmp_path / "c.png").read_bytes())
    raw[20] ^= 1                                   # inside IHDR's data: its CRC fails
    (tmp_path / "c.png").write_bytes(bytes(raw))
    with pytest.raises(ValueError, match="CRC"):
        read_png(tmp_path / "c.png")


def test_writes_without_pil(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "PIL", None)          # `import PIL` now raises
    monkeypatch.setitem(sys.modules, "PIL.Image", None)
    with pytest.raises(ImportError):
        import PIL  # noqa: F401
    imgs = np.random.default_rng(0).integers(0, 256, (3, 6, 9, 3), dtype=np.uint8)
    paths = _write_pngs(imgs, [], tmp_path)
    assert [p.name for p in paths] == ["000000.png", "000001.png", "000002.png"]
    for p, img in zip(paths, imgs):
        np.testing.assert_array_equal(read_png(p), img)


def test_generate_names_files_as_the_jax_package(tmp_path):
    """Labels cycle over the samples; file i is ``{i:06d}_c{label}``, as
    `sgdm_tpu/generate.py` names it, and holds image i of the result."""
    labels = [3, 1, 2]
    imgs = generate(TINY, n=5, batch_size=2, steps=4, labels=labels, seed=0, device="cpu",
                    out_dir=tmp_path)
    names = sorted(p.name for p in tmp_path.iterdir())
    want = [f"{i:06d}_c{labels[i % len(labels)]}.png" for i in range(5)]
    assert names == want
    for i, name in enumerate(want):
        np.testing.assert_array_equal(read_png(tmp_path / name), imgs[i].numpy())


def test_generate_without_ids_numbers_the_files(tmp_path):
    cfg = dict(TINY, cond_dim=0)
    imgs = generate(cfg, n=3, steps=4, seed=1, device="cpu", out_dir=tmp_path)
    assert sorted(p.name for p in tmp_path.iterdir()) == [f"{i:06d}.png" for i in range(3)]
    assert imgs.dtype == torch.uint8
    np.testing.assert_array_equal(read_png(tmp_path / "000002.png"), imgs[2].numpy())


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted((ROOT / "sgdm_tpu_torch").rglob("*.py")) +
                         [ROOT / "chip_smoke.py"], ids=lambda p: str(p.relative_to(ROOT)))
def test_port_does_not_import_pil(path):
    assert not any(m.split(".")[0] == "PIL" for m in _imports(path)), path


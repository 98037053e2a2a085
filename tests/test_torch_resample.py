"""PIL's resamplers and the PNG row unfilters in the port's host C++
(`native/resample.cpp`) and in numpy, against PIL and each other, bit for
bit.

  * `resize_bilinear` and `resize_bicubic`, native and plain, equal
    ``Image.resize(..., BILINEAR / BICUBIC)`` on grey and RGB images, up and
    down, at the sizes the segmentation datasets use; ``img.resize(size)``
    with no filter is the bicubic one;
  * bicubic's negative lobes: PIL rounds a negative fixed-point weight as
    ``(int)(-0.5 + w · 2^22)``; rounding it the positive way moves pixels;
  * `resize_window` is that window of the whole resize, on strided views;
    `scale_crop_resize` (the datasets' one-call image chain) equals its
    numpy composition;
  * the native PNG unfilter equals the Python one on every filter and
    pixel width.
"""

import numpy as np
import pytest
from PIL import Image

from sgdm_tpu_torch.data import transforms
from sgdm_tpu_torch.data.transforms import (resize_bicubic, resize_bilinear, resize_window,
                                            scale_crop_resize)
from sgdm_tpu_torch.utils.png import unfilter

FILTERS = {"bilinear": (resize_bilinear, Image.BILINEAR), "bicubic": (resize_bicubic, Image.BICUBIC)}
# (source h, w) -> output (h, w): the VOC scale, img4unsup, the final resize,
# upscales, one-pixel edges
SHAPES = [((375, 500), (260, 346)), ((375, 500), (300, 300)), ((224, 224), (64, 64)),
          ((60, 90), (235, 352)), ((23, 37), (23, 80)), ((23, 37), (9, 37)), ((1, 1), (5, 3)),
          ((7, 5), (1, 1)), ((480, 640), (320, 320))]


@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("plain", [False, True], ids=["native", "plain"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}->{s[1]}")
@pytest.mark.parametrize("name", sorted(FILTERS))
def test_resize_equals_pil(name, shape, plain, channels):
    (h, w), (oh, ow) = shape
    rng = np.random.default_rng(h * w + oh)
    img = rng.integers(0, 256, (h, w, channels)[:2 if channels == 1 else 3], dtype=np.uint8)
    fn, pil = FILTERS[name]
    want = np.asarray(Image.fromarray(img).resize((ow, oh), pil))
    got = fn(img, oh, ow, plain=plain)
    assert got.dtype == np.uint8 and np.array_equal(got, want)


def test_default_resize_is_bicubic():
    img = np.random.default_rng(0).integers(0, 256, (224, 224, 3), dtype=np.uint8)
    assert np.array_equal(np.asarray(Image.fromarray(img).resize((64, 64))),
                          resize_bicubic(img, 64, 64))


def test_bicubic_rounds_negative_weights_as_pil():
    index, weight = transforms._taps(224, 64, "bicubic")
    assert (weight < 0).any()
    # the same weights with a negative one rounded the positive way
    scale = 224 / 64
    support, ss = 2.0 * scale, 1.0 / scale
    positive_way = weight.copy()
    for xx in range(64):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), 224) - xmin
        w = [transforms._bicubic_filter((x + xmin - center + 0.5) * ss) for x in range(xmax)]
        ww = 0.0
        for v in w:
            ww += v
        positive_way[xx, :xmax] = [int(0.5 + v / ww * (1 << 22)) for v in w]
    assert (positive_way != weight).any()
    assert (positive_way[weight >= 0] == weight[weight >= 0]).all()
    img = np.random.default_rng(0).integers(0, 256, (200, 224), dtype=np.uint8)
    want = np.asarray(Image.fromarray(img).resize((64, 200), Image.BICUBIC))
    assert np.array_equal(resize_bicubic(img, 200, 64, plain=True), want)
    assert np.array_equal(resize_bicubic(img, 200, 64), want)
    taps = img[:, index].astype(np.int64)                 # [200, 64, ksize]
    wrong = np.clip(((taps * positive_way).sum(-1) + (1 << 21)) >> 22, 0, 255)
    assert (wrong != want).sum() == 2                     # pixels the other rounding moves


@pytest.mark.parametrize("name", sorted(FILTERS))
def test_window_is_the_crop_of_the_whole(name):
    rng = np.random.default_rng(5)
    img = rng.integers(0, 256, (120, 90, 3), dtype=np.uint8)
    whole = FILTERS[name][0](img, 250, 187)
    assert np.array_equal(resize_window(img, 250, 187, name, (13, 20, 224, 150)),
                          whole[13:237, 20:170])
    view = img[10:100, 5:80]                              # rows strided
    assert np.array_equal(resize_window(view, 64, 64, name),
                          FILTERS[name][0](np.ascontiguousarray(view), 64, 64))
    assert np.array_equal(resize_window(img[:, ::-1], 40, 40, name),   # columns reversed: copied
                          FILTERS[name][0](np.ascontiguousarray(img[:, ::-1]), 40, 40))


@pytest.mark.parametrize("grey", [False, True], ids=["rgb", "grey"])
def test_scale_crop_resize_equals_its_composition(grey):
    rng = np.random.default_rng(6)
    img = rng.integers(0, 256, (375, 500) if grey else (375, 500, 3), dtype=np.uint8)
    native = scale_crop_resize(img, 260, 346, 17, 101, 224, 64, unsup=300)
    plain = scale_crop_resize(img, 260, 346, 17, 101, 224, 64, unsup=300, plain=True)
    assert all(np.array_equal(a, b) for a, b in zip(native, plain))
    assert scale_crop_resize(img, 260, 346, 0, 0, 224, 64)[1] is None


@pytest.mark.parametrize("bpp", [1, 2, 3, 4])
@pytest.mark.parametrize("kind", [0, 1, 2, 3, 4, "mixed"])
def test_native_unfilter_equals_python(kind, bpp):
    rng = np.random.default_rng(bpp)
    h, stride = 37, bpp * 29
    raw = rng.integers(0, 256, (h, 1 + stride), dtype=np.uint8)
    raw[:, 0] = rng.integers(0, 5, h) if kind == "mixed" else kind
    assert np.array_equal(unfilter(raw, h, stride, bpp), unfilter(raw, h, stride, bpp, plain=True))
    raw[5, 0] = 9
    for plain in (False, True):
        with pytest.raises(ValueError, match="filter 9"):
            unfilter(raw, h, stride, bpp, plain=plain)


@pytest.mark.parametrize("onehot", [True, False], ids=["onehot", "ids"])
@pytest.mark.parametrize("relabel", [False, True], ids=["ids", "fine-to-coarse"])
def test_encode_mask_equals_the_numpy_encoding(relabel, onehot):
    """The native gather + encoding of an id mask against the numpy chain
    (gather, `segmask_to_ids`, one-hot, `mask_to_attr_nhot`) bit for bit,
    and the same errors: KeyError on a value the mapping lacks, IndexError
    on an id past the classes."""
    from sgdm_tpu_torch.data.transforms import (RandomScaleCrop, encode_mask,
                                                mask_to_attr_nhot, segmask_to_onehot)

    rng = np.random.default_rng(8)
    k = 27 if relabel else 21
    f2c = {i: (i * 7) % 27 for i in range(182)} if relabel else None
    m = rng.integers(0, 182 if relabel else 21, (375, 500)).astype(np.uint8)
    m[:5] = 255
    t = RandomScaleCrop(224, 64)
    rows, cols = t.mask_indices(m.shape, 346, 260, 33, 17)
    got = encode_mask(m[:, ::-1], rows, cols, k, f2c, onehot=onehot)   # strided columns too
    want = encode_mask(m[:, ::-1], rows, cols, k, f2c, onehot=onehot, plain=True)
    assert all(g.dtype == w.dtype and np.array_equal(g, w) for g, w in zip(got, want))
    crop = m[:, ::-1][rows[:, None], cols[None, :]]
    assert np.array_equal(got[1], mask_to_attr_nhot(crop, k, f2c))
    if onehot:
        assert np.array_equal(got[0], segmask_to_onehot(crop, k, f2c))
    for plain in (False, True):
        if relabel:
            with pytest.raises(KeyError):
                encode_mask(m, rows, cols, k, {i: 0 for i in range(100)}, plain=plain)
        with pytest.raises(IndexError, match="num_classes"):
            encode_mask(m, rows, cols, 5, f2c, plain=plain)

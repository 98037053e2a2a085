"""`sgdm_tpu_torch/data/transforms.py resize_bilinear` against PIL's
``Image.resize(..., Image.BILINEAR)``, bit for bit: random uint8 images
(RGB and grey) ×2 up, ÷16 down, to the ImageNet reader's 224-px cluster
size, to and from odd sizes, and along one axis only."""

import numpy as np
import pytest
from PIL import Image

from sgdm_tpu_torch.data.transforms import resize_bilinear

SIZES = [  # (h, w) -> (height, width)
    ((32, 32), (64, 64)),      # x2 up
    ((1024, 1024), (64, 64)),  # /16 down (FFHQ 1024 -> 64)
    ((64, 64), (224, 224)),    # size4cluster
    ((37, 23), (64, 64)),      # odd up
    ((17, 31), (5, 9)),        # odd down
    ((64, 64), (64, 32)),      # one axis
    ((5, 7), (200, 3)),        # up one way, down the other
    ((100, 3), (100, 17)),
]


@pytest.mark.parametrize("channels", [3, None], ids=["rgb", "grey"])
@pytest.mark.parametrize("src,dst", SIZES, ids=lambda v: "x".join(map(str, v)))
def test_matches_pil(src, dst, channels):
    rng = np.random.default_rng(hash((src, dst)) % 2**32)
    img = rng.integers(0, 256, src + ((channels,) if channels else ()), dtype=np.uint8)
    want = np.asarray(Image.fromarray(img).resize(dst[::-1], Image.BILINEAR))
    got = resize_bilinear(img, *dst)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_same_size_is_a_copy_and_smooth_images_stay_smooth():
    img = np.tile(np.arange(0, 256, 4, dtype=np.uint8), (64, 1))[..., None].repeat(3, 2)
    same = resize_bilinear(img, 64, 64)
    assert same is not img and np.array_equal(same, img)
    big = resize_bilinear(img, 128, 128)
    want = np.asarray(Image.fromarray(img).resize((128, 128), Image.BILINEAR))
    np.testing.assert_array_equal(big, want)
    with pytest.raises(TypeError):
        resize_bilinear(img.astype(np.float32), 8, 8)

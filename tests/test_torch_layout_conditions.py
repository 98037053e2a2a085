"""The port's conditioning glue (`conditioning/condition.py`) and its
`SyntheticSegImages` against the JAX package's: the three layout methods of
`prepare_condition_kwargs`, `prepare_sampling_kwargs`, `randomsample_cond`,
`layout_dim_of`, and `layout_to_device` (uint8 id masks become one-hot on the
device, out-of-range ids raise, binary [.., 1] masks and float maps pass
through).  Everything here is exact: equal keys, equal arrays.
"""

import numpy as np
import pytest
import torch

from sgdm_tpu.conditioning import condition as jcond
from sgdm_tpu.data.synthetic import SyntheticSegImages as JSyntheticSegImages
from sgdm_tpu_torch.conditioning import condition as tcond
from sgdm_tpu_torch.data.synthetic import SyntheticSegImages, collate

CFG = {"clusterlayout": {"how": "lost", "layout_dim": 1},
       "layout": {"how": "oracle", "layout_dim": 6},
       "stegoclusterlayout": {"layout_dim": 6}}


def _batch(onehot_on_device=False):
    data = SyntheticSegImages(size=16, num_classes=5, length=8, seed=3,
                              onehot_on_device=onehot_on_device)
    return collate([data[i] for i in range(4)])


@pytest.mark.parametrize("onehot_on_device", [False, True], ids=["onehot", "uint8-ids"])
def test_synthetic_seg_images_match_the_jax_package(onehot_on_device):
    kw = dict(size=16, num_classes=5, length=8, seed=3, onehot_on_device=onehot_on_device)
    ours, theirs = SyntheticSegImages(**kw), JSyntheticSegImages(**kw)
    for i in (0, 3, 7):
        a, b = ours[i], theirs[i]
        assert a.keys() == b.keys()
        for key in a:
            assert np.asarray(a[key]).dtype == np.asarray(b[key]).dtype, key
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    item = ours[1]
    assert item["stegomask"].shape == ((16, 16) if onehot_on_device else (16, 16, 6))
    assert item["stego_attr"].sum() == 2 and item["lostbboxmask"].shape == (16, 16, 1)


@pytest.mark.parametrize("how", ["lost", "oracle", "stego"])
@pytest.mark.parametrize("method", ["clusterlayout", "layout", "stegoclusterlayout"])
@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
def test_prepare_condition_kwargs_layout_methods(method, how, training):
    batch = _batch()
    cfg = {k: dict(v, how=how) for k, v in CFG.items()}
    got = tcond.prepare_condition_kwargs(method, batch, cond_drop_prob=0.2, training=training,
                                         condition_cfg=cfg)
    ref = jcond.prepare_condition_kwargs(method, batch, cond_drop_prob=0.2, training=training,
                                         condition_cfg=cfg)
    assert got.keys() == ref.keys()
    assert got["cond_drop_prob"] == ref["cond_drop_prob"] == (0.2 if training else 1.0)
    for key in ("cond", "layout"):
        if key in ref:
            np.testing.assert_array_equal(got[key], ref[key])
    assert "layout" in got


def test_prepare_sampling_kwargs_and_randomsample():
    batch = dict(_batch(), label=np.eye(5, dtype=np.float32)[[0, 1, 2, 3]],
                 label_random=np.eye(5, dtype=np.float32)[[4, 4, 0, 1]])
    for method, rand in (("stegoclusterlayout", False), ("label", True), ("label", False),
                         (None, False)):
        got = tcond.prepare_sampling_kwargs(method, batch, 2.5, random_sample_condition=rand,
                                            condition_cfg=CFG)
        ref = jcond.prepare_sampling_kwargs(method, batch, 2.5, random_sample_condition=rand,
                                            condition_cfg=CFG)
        assert got.keys() == ref.keys() and "cond_drop_prob" not in got
        assert got["cond_scale"] == 2.5
        for key in ("cond", "layout"):
            if ref.get(key) is not None:
                np.testing.assert_array_equal(got[key], ref[key])
    with pytest.raises(ValueError, match="unsupported"):
        tcond.randomsample_cond("stegoclusterlayout", batch, True)
    with pytest.raises(ValueError, match="cond_drop_prob"):
        tcond.prepare_condition_kwargs("layout", batch, cond_drop_prob=0.0, condition_cfg=CFG)
    with pytest.raises(ValueError, match="how"):
        tcond.prepare_condition_kwargs("layout", batch, cond_drop_prob=0.1, condition_cfg={})


def test_layout_dim_of():
    for method in ("clusterlayout", "layout", "stegoclusterlayout", "label", None):
        assert tcond.layout_dim_of(method, CFG) == jcond.layout_dim_of(method, CFG)
    assert tcond.layout_dim_of("layout", None) == 0


@pytest.mark.parametrize("as_tensor", [False, True], ids=["numpy", "tensor"])
def test_layout_to_device_expands_uint8_ids(as_tensor):
    ids = _batch(onehot_on_device=True)["stegomask"]
    assert ids.dtype == np.uint8 and ids.shape == (4, 16, 16)
    ref = np.asarray(jcond.layout_to_device(ids, 6))
    got = tcond.layout_to_device(torch.from_numpy(ids) if as_tensor else ids, 6)
    assert got.dtype == torch.float32 and tuple(got.shape) == (4, 16, 16, 6)
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(got.numpy(), _batch()["stegomask"])  # the host one-hot
    single = tcond.layout_to_device(ids[0].astype(np.int64), 6)  # [H, W], any integer type
    np.testing.assert_array_equal(single.numpy(), ref[0])


def test_layout_to_device_rejects_out_of_range_ids():
    ids = np.zeros((2, 4, 4), np.uint8)
    ids[1, 2, 3] = 6
    with pytest.raises(ValueError, match="layout_dim|outside"):
        jcond.layout_to_device(ids, 6)
    with pytest.raises(ValueError, match="outside"):
        tcond.layout_to_device(ids, 6)
    # an integer TENSOR must not slip through as a float map (it would reach
    # the model as a 4-pixel-wide "one-hot")
    with pytest.raises(ValueError, match="outside"):
        tcond.layout_to_device(torch.from_numpy(ids), 6)
    with pytest.raises(ValueError, match="outside"):
        tcond.layout_to_device(np.full((2, 4, 4), -1, np.int64), 6)
    with pytest.raises(ValueError, match="layout_dim"):
        tcond.layout_to_device(ids, 0)


def test_layout_to_device_passes_maps_through():
    batch = _batch()
    for layout in (batch["stegomask"], batch["lostbboxmask"],
                   _batch(onehot_on_device=True)["lostbboxmask"]):  # the last: uint8 [.., 1]
        ref = np.asarray(jcond.layout_to_device(layout, 6))
        got = tcond.layout_to_device(layout, 6)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), ref)
    assert tcond.layout_to_device(None, 6) is None

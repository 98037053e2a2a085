"""The port's FID Inception (`sgdm_tpu_torch/eval/inception.py`), its
resizes and its metric dict (`eval/fid_engine.py`) against the JAX
package's, on the CPU, on the same weights.

One JAX network for the file: `FIDInceptionV3().init` jitted on a small
input (parameter shapes do not depend on the input size), carried over by
`models.convert.inception_from_flax`.

  * the forward at 139 px: pool3, logits and spatial (343-wide at this
    size) within max|Δ| / max|ref| ≤ 1e-4;
  * the resizes to 299 against the JAX package's (clean: PIL's float32
    bicubic, per image; bilinear: `jax.image.resize`) on the 0-255 scale:
    bicubic ≤ 2e-3, bilinear ≤ 1e-4;
  * `get_fid_dict(debug=False)` of both packages on two dirs of 8
    PIL-written 64-px PNGs with nearest_k=3: FID, sFID, fid_tf and IS
    (s1, s10) within 1e-3 relative, PRDC equal.
"""

import numpy as np
import pytest
import torch
from PIL import Image
from threadpoolctl import threadpool_limits

from sgdm_tpu_torch.eval.fid_engine import InceptionExtractor, get_fid_dict, resize_299
from sgdm_tpu_torch.eval.inception import FIDInceptionV3, build_inception, random_params
from sgdm_tpu_torch.models.convert import inception_from_flax

FORWARD_TOL = 1e-4
BICUBIC_TOL = 2e-3      # on 0-255: torch's antialiased bicubic vs PIL's, 8.4e-4 measured at 64 → 299
BILINEAR_TOL = 1e-4     # on 0-255: 3.1e-5 measured
METRIC_RTOL = 1e-3


@pytest.fixture(scope="module")
def jax_net():
    import jax
    import jax.numpy as jnp

    from sgdm_tpu.eval.inception import FIDInceptionV3 as JaxInception

    model = JaxInception()
    params = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.zeros((1, 139, 139, 3)))["params"]
    return model, params


def test_forward_matches_jax_on_its_weights(jax_net):
    import jax
    import jax.numpy as jnp

    model, params = jax_net
    x = np.random.default_rng(0).uniform(-1, 1, (2, 139, 139, 3)).astype(np.float32)
    ref = jax.jit(model.apply)({"params": params}, jnp.asarray(x))
    net = build_inception(inception_from_flax(params))
    with torch.no_grad():
        got = net(torch.from_numpy(x.transpose(0, 3, 1, 2)))
    assert got["spatial"].shape == (2, 7 * 7 * 7)
    for k in ("pool3", "logits", "spatial"):
        want = np.asarray(ref[k])
        assert got[k].shape == want.shape
        err = np.abs(got[k].numpy() - want).max() / np.abs(want).max()
        assert err <= FORWARD_TOL, (k, err)


def test_weights_carry_every_parameter(jax_net):
    sd = inception_from_flax(jax_net[1])
    with torch.device("meta"):                                          # shapes only
        want = FIDInceptionV3().state_dict()
    assert {k: tuple(v.shape) for k, v in sd.items()} == {k: tuple(v.shape) for k, v in want.items()}
    assert sum(v.numel() for v in sd.values()) == 23_850_960
    own, again = random_params(0), random_params(0)
    assert own.keys() == sd.keys()
    assert all(torch.equal(own[k], again[k]) for k in own)             # deterministic
    w = own["Mixed_6e.branch7x7_2.conv.weight"]                        # lecun_normal, fan-in
    assert abs(float(w.std()) * (192 * 7) ** 0.5 - 1.0) < 0.05


@pytest.mark.parametrize("size", [32, 64])
@pytest.mark.parametrize("mode,tol", [("clean", BICUBIC_TOL), ("bilinear", BILINEAR_TOL)])
def test_resize_matches_the_jax_engine(mode, tol, size):
    from sgdm_tpu.eval.fid_engine import InceptionExtractor as JaxExtractor

    imgs = np.random.default_rng(size).integers(0, 256, (3, size, size, 3), dtype=np.uint8)
    want = np.asarray(JaxExtractor._resize_batch(None, imgs, mode))   # [-1, 1], NHWC
    got = resize_299(torch.from_numpy(imgs), mode).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (3, 299, 299, 3)
    assert np.abs(got - want).max() * 127.5 <= tol


def _png_dirs(root):
    """Two dirs of 8 PIL-written 64-px RGB PNGs: smooth blobs and noise."""
    rng = np.random.default_rng(3)
    yy, xx = np.mgrid[0:64, 0:64] / 64.0
    dirs = []
    for name in ("a", "b"):
        d = root / name
        d.mkdir()
        for i in range(8):
            if name == "a":
                cy, cx = rng.uniform(0.2, 0.8, 2)
                blob = np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / 0.05)
                img = np.stack([blob * c for c in rng.uniform(0.3, 1.0, 3)], -1) * 255
            else:
                img = rng.uniform(0, 255, (64, 64, 3))
            Image.fromarray(img.astype(np.uint8)).save(d / f"img{i}.png")
        dirs.append(d)
    return dirs


def test_fid_dict_matches_the_jax_engine(jax_net, tmp_path, monkeypatch):
    import sgdm_tpu.eval.fid_engine as jax_engine

    _, params = jax_net
    a, b = _png_dirs(tmp_path)
    monkeypatch.setattr(jax_engine, "random_params", lambda seed=0: params)
    monkeypatch.delenv("SGDM_INCEPTION_WEIGHTS", raising=False)
    monkeypatch.setattr(jax_engine, "_DEFAULT_WEIGHTS", [])         # the JAX engine's own paths
    ex = InceptionExtractor(batch_size=8, device="cpu")
    ex.model = build_inception(inception_from_flax(params))
    # six 2048-wide sqrtm: one BLAS thread, as the suite's workers share the cores
    with threadpool_limits(1, user_api="blas"):
        want, want_fid = jax_engine.get_fid_dict(
            a, b, jax_engine.InceptionExtractor(batch_size=8), nearest_k=3)
        got, fid = get_fid_dict(a, b, ex, nearest_k=3)
    assert got.keys() == want.keys() and fid == got["clean_fid_raw"]
    for k in ("clean_fid_raw", "sfid", "fid_tf", "is_tf_s1", "is_tf_s10"):
        assert want[k] > 0 and abs(got[k] - want[k]) <= METRIC_RTOL * abs(want[k]), (k, got[k],
                                                                                      want[k])
    for k in ("precision", "recall", "density", "coverage"):
        assert got[k] == want[k], k

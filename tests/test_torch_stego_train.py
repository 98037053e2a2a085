"""The port's STEGO training (`sgdm_tpu_torch/selfsup/stego_train.py`)
against the JAX package's (`sgdm_tpu/selfsup/stego_train.py`) on the CPU,
float32, each term fed the JAX package's ``jax.random`` draws.

  * `_bilinear_sample` (align-corners coordinates, the edges included)
    within 1e-6;
  * `contrastive_correlation_loss`: the loss, its three terms and the
    gradient with respect to the code within LOSS_TOL = 1e-5, for the
    default flags and with ``stabilize`` / no ``zero_clamp`` / no
    ``pointwise``;
  * `cluster_probe_loss` with α None (the hard one-hot) and 2, and its
    gradient with respect to the centres; `linear_probe_loss` with label
    255 and its gradients;
  * `precompute_knns` on a 10-image dataset: the same neighbours;
  * `train_stego` for two steps (batch 4, the published feature_samples 11
    and neg_samples 5) on one tiny trunk, the JAX initial head and centres
    (``init=``) and the JAX draws (``draws=``): every head parameter and
    centre within PARAM_TOL = 2e-6 of JAX's (Adam moves them by ≈ lr a
    step: 5e-4 head, 5e-3 centres).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import traverse_util

from sgdm_tpu.models.vit import VisionTransformer as JaxViT
from sgdm_tpu.selfsup import ssl_backbone as jax_sb
from sgdm_tpu.selfsup import stego as jax_stego
from sgdm_tpu.selfsup import stego_train as jax_st
from sgdm_tpu_torch.models.convert import stego_from_flax, vit_from_flax
from sgdm_tpu_torch.models.vit import VisionTransformer
from sgdm_tpu_torch.selfsup import ssl_backbone as sb
from sgdm_tpu_torch.selfsup import stego_train as st
from torch_port_common import perturbed_flat, unflatten

TINY = dict(patch_size=8, embed_dim=32, depth=2, num_heads=2, pretrain_img_size=32)
LOSS_TOL = 1e-5
PARAM_TOL = 2e-6


def _t(a):
    return torch.from_numpy(np.asarray(a, dtype=np.float32).copy())


def jax_draws(key, b: int, feature_samples: int = 11, neg_samples: int = 5) -> dict:
    """The draws JAX's `contrastive_correlation_loss` makes from ``key``."""
    n = feature_samples * feature_samples
    k1, k2, k3 = jax.random.split(key, 3)
    return dict(coords1=_t(jax.random.uniform(k1, (b, n, 2), minval=-1.0, maxval=1.0)),
                coords2=_t(jax.random.uniform(k2, (b, n, 2), minval=-1.0, maxval=1.0)),
                perms=[torch.from_numpy(np.asarray(
                    jax.random.permutation(jax.random.fold_in(k3, i), b)).astype(np.int64))
                    for i in range(neg_samples)])


def test_bilinear_sample():
    rng = np.random.default_rng(0)
    img = rng.standard_normal((7, 9, 4)).astype(np.float32)
    coords = rng.uniform(-1, 1, (50, 2)).astype(np.float32)
    coords[:6] = [[-1, -1], [1, 1], [-1, 1], [1, -1], [0, 0], [1, 0.3]]
    ref = np.asarray(jax_st._bilinear_sample(jnp.asarray(img), jnp.asarray(coords)))
    ours = st._bilinear_sample(_t(img), _t(coords)).numpy()
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("flags", [{}, {"stabilize": True}, {"zero_clamp": False},
                                   {"pointwise": False}], ids=lambda f: "-".join(f) or "default")
def test_contrastive_correlation_loss(flags):
    rng = np.random.default_rng(1)
    b, fs, ns = 4, 5, 3
    feats, feats_pos = (rng.standard_normal((b, 6, 6, 16)).astype(np.float32) for _ in range(2))
    code, code_pos = (rng.standard_normal((b, 6, 6, 7)).astype(np.float32) for _ in range(2))
    key = jax.random.PRNGKey(2)

    def jax_loss(c):
        return jax_st.contrastive_correlation_loss(
            key, jnp.asarray(feats), jnp.asarray(feats_pos), c, jnp.asarray(code_pos),
            feature_samples=fs, neg_samples=ns, **flags)

    (ref_loss, ref_aux), ref_grad = jax.value_and_grad(jax_loss, has_aux=True)(jnp.asarray(code))
    c = _t(code).requires_grad_(True)
    loss, aux = st.contrastive_correlation_loss(_t(feats), _t(feats_pos), c, _t(code_pos),
                                                **jax_draws(key, b, fs, ns), **flags)
    loss.backward()
    assert abs(float(loss.detach()) - float(ref_loss)) <= LOSS_TOL
    for k in ("pos_intra", "pos_inter", "neg_inter"):
        assert abs(float(aux[k]) - float(ref_aux[k])) <= LOSS_TOL, k
    np.testing.assert_allclose(c.grad.numpy(), np.asarray(ref_grad), rtol=0, atol=LOSS_TOL)


@pytest.mark.parametrize("alpha", [None, 2.0])
def test_cluster_probe_loss(alpha):
    rng = np.random.default_rng(3)
    code = rng.standard_normal((2, 5, 5, 7)).astype(np.float32)
    cl = rng.standard_normal((6, 7)).astype(np.float32)
    ref, ref_g = jax.value_and_grad(
        lambda c: jax_st.cluster_probe_loss(jnp.asarray(code), c, alpha))(jnp.asarray(cl))
    c = _t(cl).requires_grad_(True)
    loss = st.cluster_probe_loss(_t(code), c, alpha)
    loss.backward()
    assert abs(float(loss) - float(ref)) <= 1e-6
    np.testing.assert_allclose(c.grad.numpy(), np.asarray(ref_g), rtol=0, atol=1e-6)


def test_linear_probe_loss_ignores_255():
    rng = np.random.default_rng(4)
    code = rng.standard_normal((2, 4, 4, 7)).astype(np.float32)
    w = rng.standard_normal((7, 5)).astype(np.float32)
    b = rng.standard_normal(5).astype(np.float32)
    labels = rng.integers(0, 5, (2, 4, 4))
    labels[0, :2] = 255
    ref, ref_g = jax.value_and_grad(jax_st.linear_probe_loss, argnums=(1, 2))(
        jnp.asarray(code), jnp.asarray(w), jnp.asarray(b), jnp.asarray(labels), 5)
    tw, tb = _t(w).requires_grad_(True), _t(b).requires_grad_(True)
    loss = st.linear_probe_loss(_t(code), tw, tb, torch.from_numpy(labels), 5)
    loss.backward()
    assert abs(float(loss) - float(ref)) <= 1e-6
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(ref_g[0]), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(ref_g[1]), rtol=0, atol=1e-6)
    # every label ignored: zero, as JAX's max(mask.sum(), 1)
    none = st.linear_probe_loss(_t(code), tw, tb, torch.full((2, 4, 4), 255), 5)
    assert float(none) == 0.0


class _Images:
    """A map dataset of seeded ``img4unsup`` images."""

    def __init__(self, n: int, size: int):
        rng = np.random.default_rng(6)
        self.imgs = rng.integers(0, 256, (n, size, size, 3), dtype=np.uint8)

    def __len__(self):
        return len(self.imgs)

    def __getitem__(self, i):
        return {"img4unsup": self.imgs[i]}


@pytest.fixture(scope="module")
def backbones():
    jm = JaxViT(**TINY)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))["params"]
    flat = perturbed_flat(shapes, seed=31)
    tm = VisionTransformer(**TINY)
    tm.load_state_dict(vit_from_flax(flat, tm), strict=True)
    return (jax_sb.SSLBackbone("tiny", jm, unflatten(flat), image_size=32),
            sb.SSLBackbone("tiny", tm, image_size=32, device="cpu"))


def test_precompute_knns(backbones):
    jb, tb = backbones
    ds = _Images(10, 40)
    ref = jax_st.precompute_knns(jb, ds, k=3, batch_size=4)
    ours = st.precompute_knns(tb, ds, k=3, batch_size=4)
    assert ours.shape == (10, 3) and ours.dtype == np.int64
    assert np.array_equal(ours, ref)


def test_train_stego_steps_match_jax(backbones, monkeypatch):
    jb, tb = backbones
    monkeypatch.setattr(jax_sb, "get_ssl_backbone", lambda *a, **k: jb)
    monkeypatch.setattr(st, "get_ssl_backbone", lambda *a, **k: tb)
    ds = _Images(8, 40)
    kw = dict(dim=6, n_classes=5, steps=2, batch_size=4, image_size=32, knn_k=2, seed=0,
              log_every=1)
    ref = jax_st.train_stego(ds, **kw)

    # the JAX run's initial head and centres, and its draws, handed to the port
    featurizer = jax_stego.DinoFeaturizer(dim=6, backbone=jb.model)
    init = featurizer.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))["params"]
    flat = traverse_util.flatten_dict(dict(init, backbone=jb.params), sep="/")
    head = {k: v for k, v in stego_from_flax(flat).items() if not k.startswith("model.")}
    clusters = _t(jax.random.normal(jax.random.PRNGKey(1), (5, 6)))
    keys, key = [], jax.random.PRNGKey(2)
    for _ in range(2):
        key, sub = jax.random.split(key)
        keys.append(sub)
    monkeypatch.setattr(st, "_init_head", lambda *a: (head, clusters))
    monkeypatch.setattr(st, "draw_contrastive", lambda gen, b: jax_draws(keys.pop(0), b))
    seen = []
    ours = st.train_stego(ds, **kw, report=seen.append, device="cpu")
    assert not keys                                           # one draw a step
    assert [r["step"] for r in seen] == [1, 2] and all(np.isfinite(r["loss"]) for r in seen)
    ref_flat = traverse_util.flatten_dict(dict(ref.params), sep="/")
    ref_head = {k: v for k, v in stego_from_flax(ref_flat).items() if not k.startswith("model.")}
    state = ours.model.state_dict()
    for k, v in ref_head.items():
        moved = float((v - head[k]).abs().max())
        assert moved > 0, k                                   # the step moved it
        np.testing.assert_allclose(state[k].numpy(), v.numpy(), rtol=0, atol=PARAM_TOL,
                                   err_msg=k)
    np.testing.assert_allclose(ours.clusters.numpy(), np.asarray(ref.clusters), rtol=0,
                               atol=PARAM_TOL)
    # the trunk is frozen: the port's is the backbone it was given
    assert all(torch.equal(state[f"model.{k}"], v) for k, v in tb.model.state_dict().items())

"""The test phase's paper figures: both packages' `run_test_and_all_exploration`
with every ``vis`` toggle on, and the denoising chain against JAX's.

  * Two cases, an IN64-like run (`SyntheticImages`, cluster ids) and a
    VOC64-like one (`SyntheticSegImages`: STEGO masks and LOST boxes),
    16-px images.  Each package's trainer is a stub whose sampler returns
    the SAME arrays (a function of the batch's conditions: the samples and
    a 3-slot ``pred_x0`` chain), the guidance sweep
    (`papervis.condscale_sweep_images`) is patched to one function in both,
    kNN and t-SNE embed with one stub backbone, and the Fréchet distance is
    stubbed (held elsewhere).  Requirement: the same files, and equal
    pixels in each, but the two the port draws without matplotlib
    (``tsne.png``, ``cluster_hist_vis.png``: there, present), with the JAX
    package's LOST-box overlay repaired for [H, W, 1] masks (its argmax
    over one channel draws no box; ROADMAP §3); the kNN metrics within
    1e-5 relative.
  * The ``pred_x0`` chain (uint8) of 4 guided DDIM steps of a tiny
    `UNetModel` with perturbed flax weights bridged to the port, from a
    shared x_T: within 1 level of JAX's (DDIM's tolerance in
    `test_torch_sampling_ca.py`).
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgdm_tpu.eval import harness as jharness
from sgdm_tpu.eval import papervis as jpv
from sgdm_tpu_torch.eval import harness
from sgdm_tpu_torch.eval import papervis as pv
from sgdm_tpu_torch.utils.png import read_png

from torch_port_common import SMALL_UNET, perturbed_flat, unflatten, one_thread

pytestmark = pytest.mark.usefixtures("one_thread")

PX, B, K_CHAIN = 16, 8, 3
ALL_TOGGLES = ("random", "random_stego_with_mask", "random_lost_with_box", "samecondition",
               "interp", "same_cluster_same_lost", "same_cluster_diff_lost",
               "diff_cluster_same_lost", "same_stego_diff_cluster", "diff_z_same_stego",
               "kmeans_vis", "cluster_hist_vis", "chainvis", "stego_chainvis", "lost_chainvis",
               "condscale", "knn", "knn_vis", "tsne", "tsne_vis")
NOT_PIXEL_EQUAL = {"tsne.png", "cluster_hist_vis.png"}


def _fake_samples(cond, b, size, c):
    """uint8 [B, H, W, C] and a [K, B, H, W, C] chain from the conditions."""
    code = np.rint(np.asarray(cond, np.float64).reshape(b, -1) @
                   np.arange(1, np.asarray(cond).reshape(b, -1).shape[1] + 1) * 7).astype(int)
    base = np.arange(size * size * c).reshape(size, size, c)
    imgs = np.stack([(base * (i % 5 + 1) + code[i] * 13 + i) % 256 for i in range(b)])
    chain = np.stack([(imgs + 40 * k) % 256 for k in range(K_CHAIN)])
    return imgs.astype(np.uint8), chain.astype(np.uint8)


def _fake_sweep(trainer, cond, scales, image_size, channels=3, **kw):
    n = len(scales)
    return _fake_samples(np.repeat(np.asarray(cond)[None], n, 0) * np.arange(1, n + 1)[:, None],
                         n, image_size, channels)[0]


class _Backbone:
    def transform_batch(self, imgs):
        return np.asarray(imgs, np.float32)

    def batch_encode_feat(self, x):
        return np.asarray(x, np.float32).reshape(len(x), -1)[:, ::5] / 255.0


class _Trainer:
    def __init__(self, log_dir, port: bool):
        self.port, self.log_dir = port, log_dir
        self.device = torch.device("cpu")
        self.condition_method, self.condition_cfg = "cluster", {"cluster": {"k": 4}}
        self.cond_scale, self.cond_drop_prob = 2.0, 0.1
        self.diff_params = {"sampling_test": "ddim", "num_timesteps_test": 2}
        self.tracker, self.global_step = None, 0

    def sampling_progressive(self, b, size, c, rng, cond=None, layout=None, cond_scale=None,
                             sampling_method=None, num_steps=None, **kw):
        imgs, chain = _fake_samples(np.asarray(cond), b, size, c)
        if self.port:
            return torch.from_numpy(imgs), {"pred_x0": torch.from_numpy(chain)}
        return imgs, {"pred_x0": chain}


def _cfg(tmp_path, seg: bool):
    from sgdm_tpu_torch.data.synthetic import SyntheticImages

    kind = "SyntheticSegImages" if seg else "SyntheticImages"
    params = dict(size=PX, num_classes=4, length=32, seed=0, cond_key="cluster")
    ds = {"target": f"sgdm_tpu.data.synthetic.{kind}", "params": params}
    ref = harness.generate_fid_reference_dir(SyntheticImages(size=PX, num_classes=4, length=20,
                                                             seed=5), tmp_path / "ref")
    vis = {k: True for k in ALL_TOGGLES}
    vis.update(interp_c={"n": 3, "samples": 2}, chainvis_c={"samples": 3})
    return {"data": {"target": "sgdm_tpu.data.datamodule.DataModuleFromConfig",
                     "params": dict(batch_size=B, num_workers=2, train=ds, validation=ds),
                     "fid_train_image_dir": str(ref), "test_fid_num": 16,
                     "name": "voc64" if seg else "in64"},
            "exp": {"cond_scale": True}, "vis": vis, "debug": True}


def _lost_repaired(real):
    def boxed(img, lostmask, up_size, width=4):
        m = np.asarray(lostmask)
        return real(img, m[..., 0] if m.ndim == 3 and m.shape[-1] == 1 else m, up_size, width)
    return boxed


@pytest.mark.parametrize("seg", [False, True], ids=["in64", "voc64"])
def test_every_toggle_draws_the_jax_figures(tmp_path, monkeypatch, seg):
    import sgdm_tpu.selfsup.ssl_backbone as jssl
    import sgdm_tpu_torch.selfsup.ssl_backbone as tssl

    fake_fid = lambda *a, **k: ({"clean_fid_raw": 1.0}, 1.0)
    for mod in (harness, jharness):
        monkeypatch.setattr(mod, "get_fid_dict", fake_fid)
    monkeypatch.setattr(harness, "_extractor", lambda device: None)
    monkeypatch.setattr(jharness, "_extractor", lambda: None)
    for mod in (pv, jpv):
        monkeypatch.setattr(mod, "condscale_sweep_images", _fake_sweep)
    monkeypatch.setattr(jpv, "_lost_boxed", _lost_repaired(jpv._lost_boxed))
    monkeypatch.setattr(jssl, "get_ssl_backbone", lambda *a, **k: _Backbone())
    monkeypatch.setattr(tssl, "get_ssl_backbone", lambda *a, **k: _Backbone())

    cfg = _cfg(tmp_path, seg)
    runs = {}
    for name, mod in (("port", harness), ("jax", jharness)):
        d = tmp_path / name
        d.mkdir()
        runs[name] = mod.run_test_and_all_exploration(_Trainer(d, name == "port"), cfg)
    port, jax_dir = tmp_path / "port" / "papervis", tmp_path / "jax" / "papervis"
    files = sorted(p.name for p in port.iterdir())
    assert files == sorted(p.name for p in jax_dir.iterdir())
    want = {"chainvis.png", "condscale_sweep.png", "knn_grid.png", "tsne.png",
            "cluster_hist_vis.png", "cluster_random_uncurated_0.png",
            "cluster_samecondition_1.png", "cluster_interp_0.png"}
    if seg:
        want |= {"stego_chainvis.png", "lost_chainvis.png",
                 "cluster_random_stego_with_mask_0.png", "cluster_random_lost_with_box_1.png",
                 "cluster_diff_z_same_stego_1_0.png"}   # same_n 11 > B: no LOST groups
    assert want <= set(files), sorted(want - set(files))
    assert any(f.startswith("cluster") and f[7:-4].isdigit() for f in files)   # kmeans_vis
    for f in files:
        if f not in NOT_PIXEL_EQUAL:
            a, b = read_png(port / f), read_png(jax_dir / f)
            assert a.shape == b.shape and np.array_equal(a, b), f
    assert sorted(runs["port"]) == sorted(runs["jax"])
    for k in ("knn_mean_nn_dist", "knn_mean_k_dist"):
        assert runs["port"][k] == pytest.approx(runs["jax"][k], rel=1e-5)
    samples = sorted(p.name for p in (tmp_path / "port" / "test_ddim2_s2.0_rank0").iterdir())
    assert samples == sorted(p.name for p in (tmp_path / "jax" / "test_ddim2_s2.0_rank0").iterdir())


def test_pred_x0_chain_matches_jax():
    from sgdm_tpu.diffusion import GaussianDiffusion as JGaussianDiffusion
    from sgdm_tpu.diffusion.guidance import make_guided_denoiser as jguided
    from sgdm_tpu.models.unet import UNetModel as JUNetModel
    from sgdm_tpu_torch.diffusion.core import GaussianDiffusion
    from sgdm_tpu_torch.models.convert import from_flax
    from sgdm_tpu_torch.models.factory import create_denoiser
    from sgdm_tpu_torch.training.state import make_sample_fn

    rng = np.random.default_rng(3)
    x_T = rng.standard_normal((2, PX, PX, 3)).astype(np.float32)
    cond = np.eye(10, dtype=np.float32)[[1, 7]]
    jm = JUNetModel(use_pallas=False, **SMALL_UNET)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(x_T),
                            jnp.zeros((2,), jnp.int32), cond=jnp.asarray(cond))["params"]
    flat = perturbed_flat(shapes, seed=4)
    jparams = unflatten(flat)
    tm = create_denoiser(**SMALL_UNET)
    tm.load_state_dict(from_flax(flat, tm))

    def apply_fn(x, t, cond_drop_mask=None, **kw):
        return jm.apply({"params": jparams}, x, t, cond_drop_mask=cond_drop_mask, **kw)

    guided = jguided(apply_fn, scale_type="imagen")
    with jax.disable_jit():
        _, jinter = JGaussianDiffusion().sample(
            "ddim", lambda x, t: guided(x, t, cond_scale=2.0, cond=jnp.asarray(cond)),
            jax.random.PRNGKey(1), x_T.shape, num_steps=4, x_T=jnp.asarray(x_T),
            log_num_per_prog=4)
    sample = make_sample_fn(tm, GaussianDiffusion(), num_steps=4, cond_scale=2.0,
                            log_num_per_prog=4, device="cpu")
    _, inter = sample(tm, torch.Generator().manual_seed(0), 2, PX, 3,
                      cond=torch.from_numpy(cond), x_T=torch.from_numpy(x_T))
    got, want = inter["pred_x0"].numpy(), np.asarray(jinter["pred_x0"])
    assert got.shape == want.shape == (4, 2, PX, PX, 3) and got.dtype == np.uint8
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    assert len(np.unique(got)) > 50        # a real chain, not a constant

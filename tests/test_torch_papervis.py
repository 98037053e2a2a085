"""The port's paper figures (`sgdm_tpu_torch/eval/papervis.py`) against the
JAX package's on the same uint8 arrays and masks drawn from a seed.

  * every grid, overlay and chain figure, `extract_bboxes`, `mask_to_ids`
    and `upsample_img` (PIL's bilinear and nearest, which the JAX module
    calls): requirement **exact pixels**, for masks as class ids, one-hot
    and channels-first one-hot;
  * the images-per-cluster histogram (matplotlib in the JAX package, drawn
    in numpy here): its bar heights are ``np.histogram(data, 100)``'s
    counts on the raster's scale, read back from the PNG;
  * `condscale_sweep_images`: one sampler call with a per-sample weight
    equals one run per weight from the same x_T, through the doubled batch
    and the fused ResBlock route, within DDIM's SAMPLE_TOL (uint8 levels).
"""

import numpy as np
import pytest
import torch

from sgdm_tpu.eval import papervis as jpv
from sgdm_tpu_torch.eval import papervis as pv
from sgdm_tpu_torch.utils.png import read_png

from torch_port_common import one_thread

pytestmark = pytest.mark.usefixtures("one_thread")

RNG = np.random.default_rng(0)
SIZE, UP = 16, 40
SAMPLE_TOL = 4          # uint8 levels: chip_smoke's DDIM SAMPLE_TOL


def _imgs(n, size=SIZE):
    return RNG.integers(0, 256, (n, size, size, 3), dtype=np.uint8)


def _masks(n, form, k=5, size=SIZE):
    ids = RNG.integers(0, k, (n, size, size))
    if form == "ids":
        return ids
    onehot = np.eye(k, dtype=np.float32)[ids]
    return onehot if form == "onehot" else onehot.transpose(0, 3, 1, 2)


def _lost(n, size=SIZE):
    """Binary box masks [n, H, W] (the JAX package draws the boxes of these;
    of the datasets' [n, H, W, 1] it draws none, see below)."""
    m = np.zeros((n, size, size), np.float32)
    for i in range(n):
        y0, x0 = RNG.integers(0, size // 2, 2)
        m[i, y0:y0 + 5, x0:x0 + 6] = 1
    return m


def _same(tmp_path, name, port_fn, jax_fn, *args, **kw):
    a, b = tmp_path / f"port_{name}.png", tmp_path / f"jax_{name}.png"
    port_fn(*args, a, **kw)
    jax_fn(*args, b, **kw)
    pa, pb = read_png(a), read_png(b)
    assert pa.shape == pb.shape and np.array_equal(pa, pb), name


@pytest.mark.parametrize("form", ["ids", "onehot", "channels_first"])
def test_mask_to_ids_and_overlays_equal_jax(form):
    m = _masks(1, form)[0]
    ids = pv.mask_to_ids(m)
    assert np.array_equal(ids, jpv.mask_to_ids(m)) and ids.dtype == np.int32
    img = _imgs(1)[0]
    assert np.array_equal(pv.overlay_mask(img, ids, 0.3), jpv.overlay_mask(img, ids, 0.3))
    assert np.array_equal(pv._stego_overlay(img, m, UP), jpv._stego_overlay(img, m, UP))
    lost = _lost(1)[0]
    boxed = pv._lost_boxed(img, lost, UP)
    assert np.array_equal(boxed, jpv._lost_boxed(img, lost, UP))
    assert (boxed == [255, 0, 0]).all(-1).sum() > 0
    # the datasets' [H, W, 1] lostbboxmask: the port draws the same box; the
    # JAX package's argmax over the one channel draws none (ROADMAP §3)
    assert np.array_equal(pv._lost_boxed(img, lost[..., None], UP), boxed)
    assert np.array_equal(jpv._lost_boxed(img, lost[..., None], UP), pv.upsample_img(img, UP))


@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
def test_upsample_and_bboxes_equal_jax(mode):
    img = _imgs(1)[0]
    assert np.array_equal(pv.upsample_img(img, 37, mode), jpv.upsample_img(img, 37, mode))
    ids = RNG.integers(0, 9, (SIZE, SIZE)).astype(np.int32)
    assert np.array_equal(pv.upsample_img(ids, 37), jpv.upsample_img(ids, 37))
    inst = np.zeros((SIZE, SIZE, 3), np.uint8)
    inst[2:5, 3:9, 0] = 1
    inst[10:, :2, 2] = 1
    assert np.array_equal(pv.extract_bboxes(inst), jpv.extract_bboxes(inst))
    box = np.array([2, 3, 11, 14])
    assert np.array_equal(pv.overlay_bbox(img, box, width=2), jpv.overlay_bbox(img, box, width=2))


FIGURES = ["grid", "grid_grey", "chain", "img", "img_up", "stego", "random_stego", "lost_bbox",
           "random_lost", "stego_chain", "lost_chain", "condscale", "condscale_stego", "scoremix"]


MASKED = ("stego", "random_stego", "stego_chain", "condscale_stego")


@pytest.mark.parametrize("fig,form", [(f, "ids") for f in FIGURES]
                         + [(f, form) for f in MASKED for form in ("onehot", "channels_first")])
def test_figures_equal_jax_pixel_for_pixel(tmp_path, fig, form):
    n = 4
    s, o = _imgs(n), _imgs(n)
    m = _masks(n, form)
    f32 = s.astype(np.float32) / 127.5 - 1.0           # the [-1, 1] float path of _unnormalize
    chain = _imgs(3 * n).reshape(3, n, SIZE, SIZE, 3)
    if fig == "grid":
        _same(tmp_path, fig, pv.draw_grid, jpv.draw_grid, list(s), ncol=3, padding=1)
    elif fig == "grid_grey":
        _same(tmp_path, fig, pv.draw_grid, jpv.draw_grid, s[..., 0], ncol=2)
    elif fig == "chain":
        _same(tmp_path, fig, pv.draw_chain_grid, jpv.draw_chain_grid, chain)
    elif fig == "img":
        _same(tmp_path, fig, pv.draw_grid_img, jpv.draw_grid_img, f32, ncol=2)
    elif fig == "img_up":
        _same(tmp_path, fig, pv.draw_grid_img, jpv.draw_grid_img, s, ncol=2, up_size=UP)
    elif fig == "stego":
        _same(tmp_path, fig, pv.draw_grid_stego, jpv.draw_grid_stego, s, m, o, up_size=UP)
    elif fig == "random_stego":
        _same(tmp_path, fig, pv.draw_grid_random_stego_with_mask,
              jpv.draw_grid_random_stego_with_mask, s, m, f32, ncol=2, up_size=UP)
    elif fig == "lost_bbox":
        _same(tmp_path, fig, pv.draw_grid_lost_bbox, jpv.draw_grid_lost_bbox, s, _lost(n), o,
              up_size=UP)
    elif fig == "random_lost":
        _same(tmp_path, fig, pv.draw_grid_random_lost_with_box,
              jpv.draw_grid_random_lost_with_box, s, _lost(n), ncol=2, up_size=UP)
    elif fig == "stego_chain":
        _same(tmp_path, fig, pv.draw_grid_stego_chainvis, jpv.draw_grid_stego_chainvis, chain,
              m, o)
    elif fig == "lost_chain":
        _same(tmp_path, fig, pv.draw_grid_lost_chainvis, jpv.draw_grid_lost_chainvis, chain,
              _lost(n), o)
    elif fig == "condscale":
        _same(tmp_path, fig, pv.draw_grid_condscale, jpv.draw_grid_condscale, s, n_samples=2)
    elif fig == "condscale_stego":
        a = pv.draw_grid_condscale_stego(m, o, s, tmp_path / "p.png", n_samples=2, up_size=UP)
        b = jpv.draw_grid_condscale_stego(m, o, s, tmp_path / "j.png", n_samples=2, up_size=UP)
        assert [p.name for p in a] == ["p_sub0.png", "p_sub1.png"] and len(b) == 2
        assert all(np.array_equal(read_png(x), read_png(y)) for x, y in zip(a, b))
    else:
        _same(tmp_path, fig, pv.draw_grid_scoremix, jpv.draw_grid_scoremix, s, ncol=2)


@pytest.mark.parametrize("seed", [0, 1])
def test_histogram_bars_are_np_histogram(tmp_path, seed):
    data = np.random.default_rng(seed).integers(1, 400, 500)
    path = pv.cluster_hist_vis_fn(data, tmp_path / "hist.png")
    img = read_png(path)
    counts, _ = np.histogram(data, bins=100)
    base, left = pv.HIST_ORIGIN
    blue = np.all(img == pv.HIST_COLOR, axis=-1)
    for i, c in enumerate(counts):
        cols = blue[:, left + i * pv.HIST_BAR:left + (i + 1) * pv.HIST_BAR]
        heights = cols.sum(0)
        assert (heights == heights[0]).all()
        assert heights[0] == round(c * pv.HIST_H / counts.max()), (i, c)
        assert not blue[base:, left + i * pv.HIST_BAR].any()   # bars stand on the baseline
    assert img.shape == (400, 800, 3)


class _SweepTrainer:
    """What `condscale_sweep_images` reads of a trainer, around a tiny UNet."""

    def __init__(self):
        from sgdm_tpu_torch.diffusion.core import GaussianDiffusion
        from sgdm_tpu_torch.models.factory import create_denoiser

        torch.manual_seed(0)
        self.device = torch.device("cpu")
        self.model = create_denoiser(
            image_size=8, in_channels=3, model_channels=32, out_channels=3, num_res_blocks=1,
            attention_resolutions=(4,), channel_mult=(1, 2), num_heads=2, cond_dim=4,
            condition_method="label", use_scale_shift_norm=True)
        with torch.no_grad():
            for p in self.model.parameters():
                p.add_(0.05 * torch.randn_like(p))
        self.diffusion = GaussianDiffusion(num_timesteps=20)
        self.scale_type, self.clip_denoised, self.dtp = "imagen", True, 1.0

    def _bound_model(self, use_ema):
        return self.model


def test_condscale_sweep_is_one_run_per_scale_from_the_same_x_T(monkeypatch):
    from sgdm_tpu_torch.models import layers
    from sgdm_tpu_torch.training import state as state_mod

    tr = _SweepTrainer()
    scales = [0.0, 1.0, 2.0, 4.0]
    cond = np.eye(4, dtype=np.float32)[1]
    x_T = torch.randn((len(scales), 8, 8, 3), generator=torch.Generator().manual_seed(3))
    batches, fused = [], []
    real_guided, real_fused = state_mod.make_guided_denoiser, layers.fused_resblock

    def guided(apply_fn, scale_type="imagen"):
        def counted(x, t, **kw):
            batches.append(x.shape[0])
            return apply_fn(x, t, **kw)
        return real_guided(counted, scale_type)

    def fused_route(*a, **k):
        fused.append(1)
        return real_fused(*a, **k)

    monkeypatch.setattr(state_mod, "make_guided_denoiser", guided)
    monkeypatch.setattr(layers, "fused_resblock", fused_route)
    sweep = pv.condscale_sweep_images(tr, cond, scales, image_size=8, num_steps=4, x_T=x_T)
    assert sweep.shape == (4, 8, 8, 3) and sweep.dtype == np.uint8
    assert batches == [2 * len(scales)] * 4        # one doubled batch a step: the tensor weight
    assert fused, "the sweep left the fused ResBlock route"
    for i, s in enumerate(scales):
        one = pv.condscale_sweep_images(tr, cond, [s], image_size=8, num_steps=4,
                                        x_T=x_T[i:i + 1])
        diff = np.abs(one[0].astype(int) - sweep[i].astype(int)).max()
        assert diff <= SAMPLE_TOL, (s, diff)

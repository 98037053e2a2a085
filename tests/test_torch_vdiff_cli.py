"""The port's v-diffusion CLI (`sgdm_tpu_torch/diffusion/vdiff_cli.py`) against
`sgdm_tpu/diffusion/vdiff_cli.py`, in float32 on the CPU.

  * the helpers: `parse_prompt`, `spherical_dist_loss`, the schedules and
    `jnp.linspace`'s float32 grid, PIL's LANCZOS cover-resize and crop;
  * `make_cutouts` against ``jax.image.scale_and_translate`` at 1e-6, fed
    the JAX function's own crop sizes and offsets (shrinking, enlarging,
    ``cut_pow`` ≠ 1);
  * the guidance functions on a narrow cc12m-shaped net: `make_cfg_model_fn`
    and `make_cond_model_fn` (the gradient through the net) give the JAX
    package's guided v at rtol 1e-4;
  * the CLI end to end on that net, patched into both packages' `_MODELS`
    with ``monkeypatch``, from one ``.pth``: ``modify-image`` (deterministic)
    agrees within 1e-4 before the PNG and within one level after it;
    ``make-grid`` pixel for pixel; ``cfg-sample`` and a CLIP-guided
    ``clip-sample`` (a stub encoder plug) run in the port and write finite
    PNGs; the error messages.
"""

from __future__ import annotations

import math
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgdm_tpu.diffusion import vdiff_cli as jvc
from sgdm_tpu.models import zoo_vdiff as jzv
from sgdm_tpu_torch.diffusion import vdiff_cli as tvc
from sgdm_tpu_torch.models import zoo_vdiff as tzv
from sgdm_tpu_torch.models.convert import vdiff_from_flax
from sgdm_tpu_torch.utils.image import read_image
from sgdm_tpu_torch.utils.png import write_png

from test_torch_zoo_vdiff import jax_tree, narrow, random_flat
from torch_port_common import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")
CPU = torch.device("cpu")


def test_parse_prompt_matches():
    for p in ["a cat", "a cat:1.5", "a: cat :2", "https://x/y.png:2", "https://x/y.png",
              "x.npy:-1", "p:0"]:
        for w in (3.0, 1.0):
            assert tvc.parse_prompt(p, w) == jvc.parse_prompt(p, w), p


def test_spherical_dist_loss_matches():
    rng = np.random.default_rng(1)
    x, y = rng.standard_normal((2, 4, 8)).astype(np.float32)
    np.testing.assert_allclose(tvc.spherical_dist_loss(torch.as_tensor(x), torch.as_tensor(y)),
                               jvc.spherical_dist_loss(jnp.asarray(x), jnp.asarray(y)),
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("num", [2, 11, 51, 1001])
def test_linspace_and_schedules_match(num):
    """Within two float32 ulps of ``jnp.linspace`` (XLA fuses its products),
    the schedules at rtol 1e-5."""
    for a, b in ((1, 0), (0, 1)):
        np.testing.assert_allclose(tvc._linspace(a, b, num).numpy(), jnp.linspace(a, b, num),
                                   rtol=0, atol=2.0 ** -23)
    for name in ("yfcc_1", "danbooru_128"):
        _, jmeta = jzv.get_vdiff_model(name)
        for modify in (False, True):
            np.testing.assert_allclose(tvc._schedule(jmeta, num - 1, modify).numpy(),
                                       jvc._schedule(jmeta, num - 1, modify), rtol=1e-5,
                                       atol=1e-7)


@pytest.mark.parametrize("hw, size", [((40, 48), (32, 32)), ((17, 9), (8, 12)),
                                      ((32, 32), (32, 32)), ((24, 20), (40, 40))])
def test_resize_and_center_crop_matches_pil(hw, size):
    from PIL import Image

    img = np.random.default_rng(hw[0]).integers(0, 256, (*hw, 3), dtype=np.uint8)
    want = np.asarray(jvc.resize_and_center_crop(Image.fromarray(img), size))
    np.testing.assert_array_equal(tvc.resize_and_center_crop(img, size), want)


def jax_draws(key, h, w, cut_size, cutn, cut_pow):
    """`jvc.make_cutouts`'s crop sizes and offsets for ``key``."""
    ku, kx, ky = jax.random.split(key, 3)
    max_size, min_size = min(h, w), min(h, w, cut_size)
    sizes = jax.random.uniform(ku, (cutn,)) ** cut_pow * (max_size - min_size) + min_size
    return (torch.as_tensor(np.array(v)) for v in
            (sizes, jax.random.uniform(kx, (cutn,)) * (w - sizes),
             jax.random.uniform(ky, (cutn,)) * (h - sizes)))


@pytest.mark.parametrize("cut_size, cut_pow", [(8, 1.0), (16, 0.5), (16, 2.0), (32, 1.0)])
def test_make_cutouts_matches_scale_and_translate(cut_size, cut_pow):
    h, w, cutn = 20, 24, 5
    imgs = np.random.default_rng(cut_size).uniform(0, 1, (2, h, w, 3)).astype(np.float32)
    key = jax.random.PRNGKey(cut_size)
    want = jvc.make_cutouts(key, jnp.asarray(imgs), cut_size, cutn, cut_pow)
    sizes, ox, oy = jax_draws(key, h, w, cut_size, cutn, cut_pow)
    got = tvc.make_cutouts(torch.as_tensor(imgs).permute(0, 3, 1, 2), cut_size, sizes, ox, oy)
    assert got.shape == (cutn * 2, 3, cut_size, cut_size)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=1e-6, atol=1e-6)


def test_draw_cutouts_ranges():
    gen = torch.Generator().manual_seed(0)
    sizes, ox, oy = tvc.draw_cutouts(gen, 20, 24, 8, 1000, 1.0)
    assert 8 <= float(sizes.min()) and float(sizes.max()) <= 20
    assert float(ox.min()) >= 0 and float((ox + sizes).max()) <= 24
    assert float(oy.min()) >= 0 and float((oy + sizes).max()) <= 20


# ---------------------------------------------------------------------------
# a narrow cc12m-shaped net in both packages
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def net():
    """(JAX cfg, port cfg, flat weights, JAX apply, port model)."""
    jcfg, tcfg = narrow(jzv._MODELS["cc12m_1_cfg"], jzv), narrow(tzv._MODELS["cc12m_1_cfg"])
    flat = random_flat(jcfg, 21)
    module = jzv._module_from_cfg(jcfg)
    params = jax_tree(flat)
    japply = jax.jit(lambda x, t, ce: module.apply(params, x, t, ce))
    model = tzv.VDiffUNet(tcfg).eval().requires_grad_(False)
    model.load_state_dict(vdiff_from_flax(flat, tcfg, model))
    return jcfg, tcfg, flat, japply, model


def nchw(x: np.ndarray) -> torch.Tensor:
    return torch.as_tensor(x).permute(0, 3, 1, 2)


def nhwc(x: torch.Tensor) -> np.ndarray:
    return x.permute(0, 2, 3, 1).numpy()


def test_cfg_model_fn_matches(net):
    jcfg, _, _, japply, model = net
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    t = np.asarray([0.3, 0.8], np.float32)
    embeds = rng.standard_normal((3, jcfg.clip_dim)).astype(np.float32)
    weights = np.asarray([-2.0, 1.5, 1.5], np.float32)
    want = jvc.make_cfg_model_fn(japply, embeds, weights)(jnp.asarray(x), jnp.asarray(t))
    with torch.no_grad():
        got = tvc.make_cfg_model_fn(lambda x_, t_, ce: model(x_, t_, ce), embeds, weights)(
            nchw(x), torch.as_tensor(t))
    np.testing.assert_allclose(nhwc(got), want, rtol=1e-4, atol=1e-4 * float(np.abs(want).max()))


def test_cond_model_fn_matches(net):
    """v − (−∂loss/∂x)·σ/α, the gradient through the net and the cutouts."""
    jcfg, _, _, japply, model = net
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    t = np.asarray([0.35, 0.6], np.float32)
    ce = rng.standard_normal((2, jcfg.clip_dim)).astype(np.float32)
    proj = rng.standard_normal((3, 5)).astype(np.float32)
    target = rng.standard_normal((2, 5)).astype(np.float32)
    key = jax.random.PRNGKey(9)
    sizes, ox, oy = jax_draws(key, 32, 32, 16, 4, 1.0)

    def jloss(x_, t_, pred):
        cuts = jvc.make_cutouts(key, (pred + 1) / 2, 16, 4)
        emb = jnp.mean(cuts, axis=(1, 2)) @ proj
        return jvc.spherical_dist_loss(emb.reshape(4, 2, -1), target[None]).mean(0).sum() * 5000

    def tloss(x_, t_, pred):
        cuts = tvc.make_cutouts((pred + 1) / 2, 16, sizes, ox, oy)
        emb = cuts.mean(dim=(2, 3)) @ torch.as_tensor(proj)
        return tvc.spherical_dist_loss(emb.reshape(4, 2, -1),
                                       torch.as_tensor(target)[None]).mean(0).sum() * 5000

    want = jvc.make_cond_model_fn(lambda x_, t_: japply(x_, t_, jnp.asarray(ce)), jloss)(
        jnp.asarray(x), jnp.asarray(t))
    plain = np.asarray(japply(jnp.asarray(x), jnp.asarray(t), jnp.asarray(ce)))
    with torch.no_grad():
        got = tvc.make_cond_model_fn(lambda x_, t_: model(x_, t_, torch.as_tensor(ce)), tloss)(
            nchw(x), torch.as_tensor(t))
    scale = float(np.abs(want - plain).max())
    assert scale > 1e-2 * float(np.abs(plain).max())         # the guidance moves v
    np.testing.assert_allclose(nhwc(got), want, rtol=1e-4, atol=1e-4 * scale)


@pytest.mark.parametrize("method", ["ddim", "prk", "plms", "pie", "plms2", "iplms"])
@pytest.mark.parametrize("reverse", [False, True])
def test_run_sampler_dispatch_matches(method, reverse):
    """Each method, forward and reverse, on the analytic v-model of
    `tests/test_torch_v_objective.py` (the JAX sampler op by op), within
    1e-5 of max|x| = 2.4: the CLI's schedule starts at α = 0.0067."""
    from test_torch_v_objective import analytic_v, eager, inputs

    jfn, tfn = analytic_v(0.5)
    jx, tx = inputs(5)
    _, meta = jzv.get_vdiff_model("cc12m_1_cfg")
    steps = np.asarray(jvc._schedule(meta, 4, for_modify=reverse))
    want = eager(jvc.run_sampler, method, jfn, jx, steps, is_reverse=reverse)
    got = tvc.run_sampler(method, tfn, tx, torch.as_tensor(steps), is_reverse=reverse)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_ddpm_cannot_reverse():
    with pytest.raises(SystemExit, match="cannot be"):
        tvc.run_sampler("ddpm", None, None, None, is_reverse=True)


# ---------------------------------------------------------------------------
# the CLI end to end
# ---------------------------------------------------------------------------

@pytest.fixture()
def zoo(net, monkeypatch, tmp_path):
    """The narrow net under both cc12m names in both packages, its weights
    in ``net.pth``; runs in ``tmp_path``."""
    jcfg, tcfg, flat, _, _ = net
    for name in ("cc12m_1", "cc12m_1_cfg"):
        monkeypatch.setitem(jzv._MODELS, name, jcfg)
        monkeypatch.setitem(tzv._MODELS, name, tcfg)
    torch.save(vdiff_from_flax(flat, tcfg), tmp_path / "net.pth")
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("SGDM_CLIP_ENCODER", raising=False)
    return str(tmp_path / "net.pth")


def smooth_png(path, h: int, w: int, seed: int) -> None:
    yy, xx = np.mgrid[0:h, 0:w]
    phase = np.random.default_rng(seed).uniform(0, 6, 3)
    img = 127.5 + 120 * np.sin(xx[..., None] / 5 + yy[..., None] / 7 + phase)
    write_png(path, img.astype(np.uint8))


@pytest.mark.parametrize("method", ["plms2"])
def test_modify_image_matches_jax(zoo, tmp_path, monkeypatch, method):
    smooth_png(tmp_path / "init.png", 40, 48, 0)
    np.save(tmp_path / "e.npy", np.random.default_rng(6).standard_normal(16).astype(np.float32))
    argv = ["modify-image", "init.png", "--embed", "e.npy:2", "--checkpoint", zoo,
            "--clip-encoder", "none", "--steps", "4", "--method", method,
            "--max-timestep", "0.9", "--seed", "3"]
    floats = {}
    to_pil, to_image = jvc._to_pil, tvc._to_image
    monkeypatch.setattr(jvc, "_to_pil", lambda x: floats.setdefault("jax", np.asarray(x))
                        is None or to_pil(x))
    monkeypatch.setattr(tvc, "_to_image", lambda x: floats.setdefault("port", np.asarray(x))
                        is None or to_image(x))
    jvc.main(argv + ["-o", "jax.png"])
    tvc.main(argv + ["-o", "port.png", "--device", "cpu"])
    want, got = floats["jax"], floats["port"].transpose(1, 2, 0)
    assert got.shape == want.shape == (32, 32, 3)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * float(np.abs(want).max()))
    diff = np.abs(read_image("port.png").astype(int) - read_image("jax.png").astype(int))
    assert diff.max() <= 1


def test_make_grid_matches_jax(tmp_path):
    paths = []
    for i in range(5):
        smooth_png(tmp_path / f"im{i}.png", 6, 4, i)
        paths.append(str(tmp_path / f"im{i}.png"))
    for extra in ([], ["--nrow", "4"]):
        jvc.main(["make-grid", *paths, "-o", str(tmp_path / "jax.png"), *extra])
        tvc.main(["make-grid", *paths, "-o", str(tmp_path / "port.png"), *extra])
        grid = read_image(tmp_path / "port.png")
        np.testing.assert_array_equal(grid, read_image(tmp_path / "jax.png"))
        ncol = 4 if extra else 3
        assert grid.shape == (6 * math.ceil(5 / ncol), 4 * ncol, 3)
        np.testing.assert_array_equal(grid[6:12, 0:4], read_image(paths[ncol]))


def test_make_grid_refuses_mixed_sizes(tmp_path):
    smooth_png(tmp_path / "a.png", 6, 4, 0)
    smooth_png(tmp_path / "b.png", 4, 6, 1)
    with pytest.raises(SystemExit, match="size"):
        tvc.main(["make-grid", str(tmp_path / "a.png"), str(tmp_path / "b.png")])


def _read_outs(n: int) -> np.ndarray:
    imgs = np.stack([read_image(f"out_{i:05}.png") for i in range(n)])
    assert imgs.shape == (n, 32, 32, 3)
    return imgs


def test_cfg_sample_runs_and_is_seeded(zoo, tmp_path):
    np.save(tmp_path / "e.npy", np.ones(16, np.float32))
    argv = ["cfg-sample", "--embed", "e.npy:3", "--checkpoint", zoo, "--steps", "3", "-n", "3",
            "-bs", "2", "--device", "cpu", "--clip-encoder", "none"]
    tvc.main(argv)
    first = _read_outs(3)
    tvc.main(argv)
    np.testing.assert_array_equal(_read_outs(3), first)
    tvc.main(argv + ["--seed", "1"])
    assert not np.array_equal(_read_outs(3), first)
    smooth_png(tmp_path / "init.png", 32, 32, 5)
    tvc.main(argv + ["--init", "init.png", "-st", "0.5", "--method", "ddim"])
    _read_outs(3)


_PLUGIN_SRC = """
import numpy as np
import torch

class _StubEncoder:
    embed_dim = 16
    input_resolution = 8
    def __init__(self, device):
        self.proj = torch.linspace(-1, 1, 48, device=device).reshape(3, 16)
    def encode_text(self, texts):
        rng = np.random.default_rng(len(texts[0]))
        return rng.standard_normal((len(texts), 16)).astype(np.float32)
    def encode_image_fn(self, imgs):
        return imgs.mean(dim=(2, 3)) @ self.proj

def build(model_name, device):
    return _StubEncoder(device)
"""


def test_clip_sample_guided_runs(zoo, tmp_path, monkeypatch):
    """cutouts, the CLIP loss and the gradient through the net, with an
    encoder plug; 32 px < 256 doubles the prediction first."""
    (tmp_path / "stub_clip_plugin.py").write_text(_PLUGIN_SRC)
    monkeypatch.syspath_prepend(str(tmp_path))
    sys.modules.pop("stub_clip_plugin", None)
    argv = ["clip-sample", "a prompt:1", "--clip-encoder", "stub_clip_plugin:build",
            "--checkpoint", zoo, "--steps", "3", "--method", "ddim", "--cutn", "2",
            "--device", "cpu"]
    tvc.main(argv + ["-cs", "0"])
    plain = _read_outs(1)
    tvc.main(argv + ["-cs", "5000"])
    guided = _read_outs(1)
    assert not np.array_equal(plain, guided)
    tvc.main(argv + ["--method", "ddpm", "-cs", "100"])
    _read_outs(1)


def test_cli_errors(zoo, tmp_path):
    with pytest.raises(SystemExit, match="CLIP encoder"):
        tvc.main(["cfg-sample", "a prompt", "--clip-encoder", "none", "--checkpoint", zoo,
                  "--device", "cpu"])
    with pytest.raises(SystemExit, match="checkpoint"):
        tvc.main(["cfg-sample", "--steps", "3", "--device", "cpu"])
    with pytest.raises(SystemExit, match="ddpm"):
        tvc.main(["modify-image", "x.png", "--method", "ddpm", "--device", "cpu"])
    np.save(tmp_path / "e.npy", np.ones(7, np.float32))
    with pytest.raises(SystemExit, match="dim 7"):
        tvc.main(["cfg-sample", "--embed", "e.npy", "--checkpoint", zoo, "--device", "cpu",
                  "--clip-encoder", "none"])


def test_flags_and_defaults_match_jax():
    def options(parser):
        sub = next(a for a in parser._actions if a.dest == "cmd")
        return {name: {a.dest: (tuple(a.option_strings), a.default, a.choices, a.nargs)
                       for a in p._actions if a.dest not in ("help", "device")}
                for name, p in sub.choices.items()}

    assert options(tvc.build_parser()) == options(jvc.build_parser())


def test_random_checkpoint_is_seeded(zoo):
    args = tvc.build_parser().parse_args(["cfg-sample", "--checkpoint", "random:4"])
    a, b = tvc._load_model(args, CPU), tvc._load_model(args, CPU)
    assert all(torch.equal(p, q) for p, q in zip(a.state_dict().values(),
                                                   b.state_dict().values()))
    assert not any(p.requires_grad for p in a.parameters())


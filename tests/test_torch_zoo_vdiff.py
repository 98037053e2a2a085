"""The v-diffusion zoo of the port (`sgdm_tpu_torch/models/zoo_vdiff.py`)
against `sgdm_tpu/models/zoo_vdiff.py`, in float32 on the CPU.

  * each of the eight `_MODELS` entries at narrow widths
    (`dataclasses.replace`: 32 px, three levels, channels 8-32, the
    attention divisor cut by 16 so that the two head rules give 1-4 and
    2-8 heads, cc12m's condition 16 → 32 wide), so every quirk runs: skip order,
    log-SNR vs t, the final ReLU, the GroupNorm(1) pre-norm, nearest vs
    bilinear upsampling, cc12m's modulation.  The same numpy weights go
    through `models/convert.py vdiff_from_flax`; the forward agrees within
    1e-5 of max|v|;
  * the full-width nets on the meta device: `state_dict()` names and shapes
    are `vdiff_torch_key_map`'s for all eight names, and equal the JAX
    package's map;
  * a `.pth` written from numpy loads into both packages (strict; under
    ``"state_dict"`` too) with equal outputs;
  * bilinear ×2 upsampling against ``jax.image.resize`` at the edges, and
    the models' metadata.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgdm_tpu.models import zoo_vdiff as jzv
from sgdm_tpu_torch.models import zoo_vdiff as tzv
from sgdm_tpu_torch.models.convert import vdiff_from_flax

from torch_port_common import one_torch_thread  # noqa: F401

NAMES = list(jzv._MODELS)


def narrow(cfg, package=tzv):
    """``cfg`` cut to 32 px, three levels, channels 8-32."""
    over = dict(size=32, cs=(8, 16, 32), divisor=cfg.divisor // 16 if cfg.divisor else None)
    if cfg.clip_dim:
        over.update(clip_dim=16, cond_width=32)
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    return package._NetCfg(**{**fields, **over})


def random_flat(cfg, seed: int) -> dict[str, np.ndarray]:
    """Flax-shaped random weights of every key (flattened with '/'):
    kernels N(0, 1/fan_in), a residual branch's last convolution (a res
    block's second, attention's out_proj) at a third of that, so that
    activations stay O(1) through the unnormalised nets' 20-odd residual
    blocks (at full gain they reach hundreds, the attention logits
    thousands, where the softmax is an argmax and rounding flips its
    near-ties); biases and norm offsets N(0, 0.1²), norm scales
    1 + N(0, 0.1²), Fourier weights N(0, 0.3²)."""
    rng = np.random.default_rng(seed)
    flat = {}
    for tk, fn, leaf, kind, shape in jzv._iter_params(cfg):
        if leaf is None:
            val = 0.3 * rng.standard_normal(shape)
        elif leaf == "scale":
            val = 1 + 0.1 * rng.standard_normal(shape)
        elif leaf == "bias":
            val = 0.1 * rng.standard_normal(shape)
        else:
            val = rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
            if fn.endswith(("_main_2", "_main_4", "_out_proj")) and kind == "conv":
                val = val / 3
        flat[fn if leaf is None else f"{fn}/{leaf}"] = val.astype(np.float32)
    return flat


def jax_tree(flat):
    tree = {}
    for path, v in flat.items():
        fn, _, leaf = path.partition("/")
        if leaf:
            tree.setdefault(fn, {})[leaf] = jnp.asarray(v)
        else:
            tree[fn] = jnp.asarray(v)
    return {"params": tree}


def model_inputs(cfg, seed: int, b: int = 2):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, cfg.size, cfg.size, 3)).astype(np.float32)
    t = rng.uniform(0.05, 0.95, b).astype(np.float32)
    ce = rng.standard_normal((b, cfg.clip_dim)).astype(np.float32) if cfg.clip_dim else None
    return x, t, ce


def jax_forward(cfg, flat, x, t, ce):
    module = jzv._module_from_cfg(cfg)
    args = (jnp.asarray(x), jnp.asarray(t)) + ((jnp.asarray(ce),) if ce is not None else ())
    return np.asarray(jax.jit(module.apply)(jax_tree(flat), *args))


def port_forward(model, x, t, ce):
    with torch.no_grad():
        v = model(torch.as_tensor(x).permute(0, 3, 1, 2), torch.as_tensor(t),
                  None if ce is None else torch.as_tensor(ce))
    return v.permute(0, 2, 3, 1).numpy()


def assert_v_close(got, want, tol: float = 1e-5):
    err = float(np.abs(got - want).max()) / float(np.abs(want).max())
    assert err <= tol, err


@pytest.mark.usefixtures("one_torch_thread")
@pytest.mark.parametrize("name", NAMES)
def test_narrow_forward_matches(name):
    jcfg, tcfg = narrow(jzv._MODELS[name], jzv), narrow(tzv._MODELS[name])
    flat = random_flat(jcfg, NAMES.index(name))
    x, t, ce = model_inputs(jcfg, 100 + NAMES.index(name))
    model = tzv.VDiffUNet(tcfg)
    model.load_state_dict(vdiff_from_flax(flat, tcfg, model))
    assert_v_close(port_forward(model, x, t, ce), jax_forward(jcfg, flat, x, t, ce))


def test_narrow_nets_exercise_every_quirk():
    """The narrow configs keep each model's quirk: several heads, attention
    with and without the pre-norm, both upsamplers, the final ReLU."""
    cfgs = {n: narrow(tzv._MODELS[n]) for n in NAMES}
    heads = {n: {node[2] for node in _walk(c.spec()) if node[0] == "attn"}
             for n, c in cfgs.items()}
    assert heads["danbooru_128"] == {1, 2, 4} and heads["yfcc_1"] == {2, 4, 8}
    assert heads["wikiart_128"] == set()
    assert {c.up_mode for c in cfgs.values()} == {"nearest", "bilinear"}
    assert {c.final_relu for c in cfgs.values()} == {True, False}


def _walk(spec):
    for node in spec:
        yield node
        if node[0] == "skip":
            yield from _walk(node[1])


def torch_shape(kind: str, shape) -> tuple:
    if kind == "conv":
        k, _, cin, cout = shape
        return (cout, cin, k, k)
    return tuple(shape[::-1]) if kind == "dense" else tuple(shape)


@pytest.mark.parametrize("name", NAMES)
def test_full_width_state_dict_is_the_key_map(name):
    model, meta = tzv.get_vdiff_model(name, "meta")
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    key_map = tzv.vdiff_torch_key_map(name)
    assert got == {k: torch_shape(kind, shape) for k, (_, _, kind, shape) in key_map.items()}
    assert key_map == jzv.vdiff_torch_key_map(name)
    _, jmeta = jzv.get_vdiff_model(name)
    assert dataclasses.asdict(meta) == pytest.approx(dataclasses.asdict(jmeta))


def test_cc12m_has_602m_parameters():
    model, _ = tzv.get_vdiff_model("cc12m_1_cfg", "meta")
    assert sum(p.numel() for p in model.parameters()) == 602_895_947


@pytest.mark.usefixtures("one_torch_thread")
@pytest.mark.parametrize("wrap", [False, True])
@pytest.mark.parametrize("name", ["cc12m_1", "danbooru_128"])
def test_pth_loads_into_both_packages(tmp_path, monkeypatch, name, wrap):
    jcfg, tcfg = narrow(jzv._MODELS[name], jzv), narrow(tzv._MODELS[name])
    monkeypatch.setitem(jzv._MODELS, name, jcfg)
    monkeypatch.setitem(tzv._MODELS, name, tcfg)
    flat = random_flat(jcfg, 7)
    sd = vdiff_from_flax(flat, tcfg)
    path = tmp_path / "net.pth"
    torch.save({"state_dict": sd} if wrap else sd, path)
    x, t, ce = model_inputs(jcfg, 8)
    params = jzv.load_vdiff_torch_checkpoint(name, str(path))
    module, _ = jzv.get_vdiff_model(name)
    args = (jnp.asarray(x), jnp.asarray(t)) + ((jnp.asarray(ce),) if ce is not None else ())
    want = np.asarray(jax.jit(module.apply)(params, *args))
    model = tzv.load_vdiff_torch_checkpoint(name, str(path), "cpu")
    assert_v_close(port_forward(model, x, t, ce), want)
    sd.pop(next(iter(sd)))
    torch.save(sd, path)
    with pytest.raises(RuntimeError, match="Missing key"):
        tzv.load_vdiff_torch_checkpoint(name, str(path), "cpu")


@pytest.mark.parametrize("hw", [(1, 1), (3, 5), (8, 8)])
def test_bilinear_upsampling_matches_jax_resize(hw):
    x = np.random.default_rng(hw[1]).standard_normal((2, *hw, 3)).astype(np.float32)
    want = jax.image.resize(jnp.asarray(x), (2, 2 * hw[0], 2 * hw[1], 3), "linear")
    got = tzv._Resample("up", "bilinear")(torch.as_tensor(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want),
                               rtol=1e-6, atol=1e-6)

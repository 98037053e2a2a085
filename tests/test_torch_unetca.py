"""Tiny `UNetCAModel` of the port against `sgdm_tpu.models.unet.UNetCAModel`
(use_pallas=False, float32, CPU) with every flax leaf perturbed and bridged
by `convert.from_flax`: the three ``cond_token_num`` branches (0 with a
``layout`` concat, 1 with ``stegoclusterlayout``, 3 token conditions pooled
by the first token or by the mean), with and without a drop mask, and a
``num_head_channels`` head split.  Forward parity ≤ 1e-4 relative to
max|eps| (the tolerance of the `UNetModel` test: f32 summation order through
the whole depth).  Plus the gradient of every parameter for the
stegoclusterlayout model in the training route, ≤ 1e-3 of the largest
gradient, and the bridge raising on a leaf left over or missing.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from sgdm_tpu.models.unet import UNetCAModel as JUNetCAModel
from sgdm_tpu_torch.models.convert import from_flax, to_flax
from sgdm_tpu_torch.models.factory import create_denoiser

from torch_port_common import perturbed_flat, unflatten

B, PX, K = 4, 16, 5
BASE = dict(model_channels=32, channel_mult=(1, 2), num_res_blocks=1, attention_resolutions=(2,),
            num_heads=4, context_dim=8)
VARIANTS = {
    "tokens0-layout": dict(cond_token_num=0, condition_method="layout", cond_dim=0),
    "tokens0-none": dict(cond_token_num=0, cond_dim=0),
    "tokens1-stego": dict(cond_token_num=1, condition_method="stegoclusterlayout", cond_dim=K),
    "tokens1-attr": dict(cond_token_num=1, condition_method="attr", cond_dim=K),
    "tokens3-cls": dict(cond_token_num=3, cond_dim=6, use_cls_token_as_pooled=True),
    "tokens3-mean": dict(cond_token_num=3, cond_dim=6, use_cls_token_as_pooled=False),
    "tokens1-headchannels": dict(cond_token_num=1, cond_dim=K, num_head_channels=16),
}
DROPS = {"none": None, "mixed": [False, True, False, True]}


def _fix_special_leaves(flat, rng):
    for key in flat:  # the leaves perturbed_flat knows no rule for
        if key.endswith("gamma"):
            flat[key] = (1 + 0.1 * rng.standard_normal(flat[key].shape)).astype(np.float32)
        elif key.endswith("null_kv"):
            flat[key] = rng.standard_normal(flat[key].shape).astype(np.float32)
    return flat


def _build(variant):
    cfg = dict(BASE, **VARIANTS[variant])
    rng = np.random.default_rng(0)
    x = rng.standard_normal((B, PX, PX, 3)).astype(np.float32)
    t = np.asarray([1, 250, 600, 999], np.int32)
    kw = {}
    layout_dim = 0
    if cfg["cond_token_num"] == 1:
        kw["cond"] = (rng.random((B, K)) > 0.5).astype(np.float32)
    elif cfg["cond_token_num"] > 1:
        kw["cond"] = rng.standard_normal((B, 3, 6)).astype(np.float32)
    if cfg.get("condition_method") in ("layout", "stegoclusterlayout"):
        layout_dim = K
        kw["layout"] = np.eye(K, dtype=np.float32)[rng.integers(0, K, (B, PX, PX))]
    jm = JUNetCAModel(use_pallas=False, **cfg)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(t),
                            **{k: jnp.asarray(v) for k, v in kw.items()})["params"]
    flat = _fix_special_leaves(perturbed_flat(shapes, seed=1), rng)
    tm = create_denoiser(**cfg, layout_dim=layout_dim or None)
    tm.load_state_dict(from_flax(flat, tm))
    return jm, tm, flat, x, t, kw


@pytest.mark.parametrize("drop", DROPS.values(), ids=DROPS.keys())
@pytest.mark.parametrize("variant", VARIANTS)
def test_forward_parity(variant, drop):
    jm, tm, flat, x, t, kw = _build(variant)
    mask = None if drop is None else np.asarray(drop)
    ref = np.asarray(jm.apply({"params": unflatten(flat)}, jnp.asarray(x), jnp.asarray(t),
                              cond_drop_mask=None if mask is None else jnp.asarray(mask),
                              **{k: jnp.asarray(v) for k, v in kw.items()}))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(t),
                 cond_drop_mask=None if mask is None else torch.from_numpy(mask),
                 **{k: torch.from_numpy(v) for k, v in kw.items()}).numpy()
    assert got.shape == ref.shape == (B, PX, PX, 3)
    scale = np.abs(ref).max()
    assert scale > 0.1  # the perturbed out_conv makes the output non-trivial
    assert np.abs(got - ref).max() <= 1e-4 * scale


def test_parameter_gradients_match_in_the_training_route():
    jm, tm, flat, x, t, kw = _build("tokens1-stego")
    mask = np.asarray(DROPS["mixed"])
    g = np.random.default_rng(9).standard_normal((B, PX, PX, 3)).astype(np.float32)
    jkw = {k: jnp.asarray(v) for k, v in kw.items()}

    def f(params):
        return jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(t),
                        cond_drop_mask=jnp.asarray(mask), train=True, **jkw)

    _, vjp = jax.vjp(f, unflatten(flat))
    want = {k: np.asarray(v) for k, v in traverse_util.flatten_dict(vjp(jnp.asarray(g))[0],
                                                                    sep="/").items()}
    out = tm(torch.from_numpy(x), torch.from_numpy(t), cond_drop_mask=torch.from_numpy(mask),
             train=True, **{k: torch.from_numpy(v) for k, v in kw.items()})
    out.backward(torch.from_numpy(g))
    got = to_flax({k: p.grad for k, p in tm.named_parameters()}, tm)
    assert got.keys() == want.keys()
    scale = max(np.abs(v).max() for v in want.values())
    for key, r in want.items():
        assert np.abs(got[key] - r).max() <= 1e-3 * scale, key


def test_bridge_consumes_every_leaf_once_and_raises_otherwise():
    _, tm, flat, *_ = _build("tokens1-stego")
    state = from_flax(flat, tm)
    assert len(state) == len(flat) == len(tm.state_dict())
    for key in ("backbone.mid_attn.null_kv", "backbone.mid_attn.norm.gamma",
                "backbone.mid_attn.context_norm.weight", "backbone.mid_attn.to_context.bias",
                "norm_cond.bias", "backbone.downsample_0.Conv_0.weight",
                "backbone.upsample_1.Conv_0.bias", "to_cond_tokens.weight"):
        assert key in state, key
    assert "backbone.mid_attn.to_q.bias" not in state
    np.testing.assert_array_equal(state["backbone.mid_attn.null_kv"].numpy(),
                                  flat["backbone/mid_attn/null_kv"])
    assert tuple(state["backbone.in_conv.weight"].shape) == (32, 3 + K, 3, 3)
    bad = dict(flat, **{"backbone/mid_attn/stray/gamma": np.zeros((2,), np.float32)})
    with pytest.raises(KeyError, match="left over"):
        from_flax(bad, tm)
    for leaf in ("backbone/mid_attn/null_kv", "backbone/up_attn_1_0/out_norm/gamma",
                 "norm_cond/scale"):
        with pytest.raises(KeyError, match="missing"):
            from_flax({k: v for k, v in flat.items() if k != leaf}, tm)
    with pytest.raises(ValueError, match="shape"):
        from_flax(dict(flat, **{"backbone/mid_attn/null_kv": np.zeros((2, 3), np.float32)}), tm)


def test_model_refuses_a_missing_or_misshapen_condition():
    _, tm, _, x, t, kw = _build("tokens1-stego")
    tx, tt = torch.from_numpy(x), torch.from_numpy(t)
    with pytest.raises(ValueError, match="layout"):
        tm(tx, tt, cond=torch.from_numpy(kw["cond"]))
    with pytest.raises(ValueError, match="cond"):
        tm(tx, tt, layout=torch.from_numpy(kw["layout"]))
    with pytest.raises(ValueError, match="layout_dim"):
        create_denoiser(**dict(BASE, **VARIANTS["tokens1-stego"]))

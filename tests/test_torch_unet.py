"""Tiny `UNetModel` of the port against `sgdm_tpu.models.unet.UNetModel`
(use_pallas=False, float32, CPU) with every flax leaf perturbed and bridged
by `convert.from_flax`.  Forward parity ≤ 1e-4 relative to max|eps|."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgdm_tpu.models.unet import UNetModel as JUNetModel
from sgdm_tpu_torch.models.convert import from_flax
from sgdm_tpu_torch.models.factory import create_denoiser

from torch_port_common import SMALL_UNET, perturbed_flat, unflatten

B, PX = 4, 16
DROPS = {"none": [False] * 4, "mixed": [False, True, False, True], "all": [True] * 4}


def _build(updown=True, method=None):
    cfg = dict(SMALL_UNET, resblock_updown=updown, condition_method=method)
    if method == "cluster_lookup":
        cfg["lookup_table_size"] = 6
    jm = JUNetModel(use_pallas=False, **cfg)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((B, PX, PX, 3)).astype(np.float32)
    t = np.asarray([1, 250, 600, 999], np.int32)
    cond = np.eye(10, dtype=np.float32)[[3, 7, 0, 9]]
    extra = {}
    if method == "clusterlayout":
        extra["layout"] = (rng.random((B, PX, PX, 1)) > 0.5).astype(np.float32)
    elif method == "cluster_lookup":
        extra["image_batch_ids"] = np.asarray([5, 0, 2, 5], np.int32)
    params = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(t),
                            cond=jnp.asarray(cond),
                            **{k: jnp.asarray(v) for k, v in extra.items()})["params"]
    flat = perturbed_flat(params, seed=1)
    tm = create_denoiser(**cfg)
    tm.load_state_dict(from_flax(flat, tm))
    return jm, tm, flat, (x, t, cond, extra)


@pytest.mark.parametrize("updown,method,drop", [
    (True, None, "none"), (True, None, "mixed"), (True, None, "all"),
    (False, None, "mixed"), (True, "clusterlayout", "mixed"),
    (True, "cluster_lookup", "mixed"),
], ids=["updown-nodrop", "updown-mixed", "updown-alldrop", "plainresample-mixed",
        "clusterlayout-mixed", "clusterlookup-mixed"])
def test_forward_parity(updown, method, drop):
    jm, tm, flat, (x, t, cond, extra) = _build(updown, method)
    mask = np.asarray(DROPS[drop])
    jextra = {k: jnp.asarray(v) for k, v in extra.items()}
    ref = np.asarray(jm.apply({"params": unflatten(flat)}, jnp.asarray(x), jnp.asarray(t),
                              cond=jnp.asarray(cond), cond_drop_mask=jnp.asarray(mask),
                              **jextra))
    textra = {k: torch.from_numpy(v) for k, v in extra.items()}
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(t), cond=torch.from_numpy(cond),
                 cond_drop_mask=torch.from_numpy(mask), **textra).numpy()
    assert got.shape == ref.shape == (B, PX, PX, 3)
    scale = np.abs(ref).max()
    assert scale > 0.1  # the perturbed out_conv makes the output non-trivial
    assert np.abs(got - ref).max() <= 1e-4 * scale


def test_bridge_consumes_every_leaf_once():
    _, tm, flat, _ = _build()
    state = from_flax(flat, tm)
    assert len(state) == len(flat) == len(tm.state_dict())
    assert "backbone.GroupNorm32_0.weight" in state
    assert "backbone.down_0_0.skip_proj.weight" not in state  # 32 -> 32: identity
    assert tuple(state["backbone.down_1_0.skip_proj.weight"].shape) == (64, 32, 1, 1)
    np.testing.assert_array_equal(
        state["backbone.down_0_0.in_conv.weight"].numpy(),
        flat["backbone/down_0_0/in_conv/kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(state["time_embed_1.weight"].numpy(),
                                  flat["time_embed_1/kernel"].T)


def test_bridge_raises_on_extra_leaf():
    _, tm, flat, _ = _build()
    bad = dict(flat, **{"backbone/mid_res1/stray/kernel": np.zeros((2, 2), np.float32)})
    with pytest.raises(KeyError, match="left over"):
        from_flax(bad, tm)


def test_bridge_raises_on_missing_leaf():
    _, tm, flat, _ = _build()
    bad = {k: v for k, v in flat.items() if k != "backbone/mid_attn/qkv/bias"}
    with pytest.raises(KeyError, match="missing"):
        from_flax(bad, tm)

"""The Imagen UNet (`sgdm_tpu_torch/models/zoo_imagen.py`) against the JAX
package's, float32 on the CPU, at narrow widths: every flax leaf perturbed
(`perturbed_flat`), bridged by `models/convert.py imagen_from_flax`.
Requirement: within 1e-4 of the larger of 1 and the output's largest value.

  * Three configurations: the default layout (cross-embed stem, learned
    sinusoid, Perceiver resampler, GlobalContext, one-kv-head attention with
    null kv, cross-attention, the 2^-½ skips); the linear attention and
    linear cross-attention with the memory-efficient path, cross-embed
    downsampling and the init-conv residual; the fixed sinusoid with a
    [B, D] text embedding and no attention pooling.
  * The per-sample drop vector [0, 1, …] (the null-token swap), JAX's
    uniform condition-drop draw handed to the port, and the fractional drop
    probability without a draw, which raises in both.
  * `forward_with_cond_scale` at s = 0, 1 and 2.5 (the CFG combine on a
    doubled batch).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgdm_tpu.models import zoo_imagen as jz
from sgdm_tpu_torch.models import zoo_imagen as tz
from sgdm_tpu_torch.models.convert import imagen_from_flax

from torch_port_common import perturbed_flat, unflatten, one_thread

pytestmark = pytest.mark.usefixtures("one_thread")

TOL = 1e-4
BASE = dict(dim=16, dim_mults=(1, 2), text_embed_dim=8, max_text_len=4, attn_dim_head=8,
            attn_heads=2, resnet_groups=4, num_resnet_blocks=1, layer_attns=(False, True),
            layer_cross_attns=(False, True), attn_pool_num_latents=3)
CONFIGS = {
    "default": BASE,
    "linear_memory_efficient": dict(BASE, use_linear_attn=True, use_linear_cross_attn=True,
                                    memory_efficient=True, cross_embed_downsample=True,
                                    init_conv_to_final_conv_residual=True,
                                    num_resnet_blocks=(1, 2), layer_attns=(False, False),
                                    layer_cross_attns=(False, True), num_time_tokens=3),
    "fixed_sinusoid_text_vector": dict(BASE, learned_sinu_pos_emb=False, max_text_len=1,
                                       attn_pool_text=False, final_conv_kernel_size=1,
                                       scale_skip_connection=False,
                                       use_global_context_attn=False),
}


def _bridge(name, b=2):
    kw = CONFIGS[name]
    rng = np.random.default_rng(len(name))
    x = rng.normal(size=(b, 8, 8, 3)).astype(np.float32)
    t = rng.uniform(0, 1, b).astype(np.float32)
    shape = (b, 8) if kw["max_text_len"] == 1 else (b, kw["max_text_len"], 8)
    cond = rng.normal(size=shape).astype(np.float32)
    jm = jz.ImagenUNet(**kw)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(t),
                            cond=jnp.asarray(cond))["params"]
    flat = perturbed_flat(shapes, seed=2)
    tm = tz.ImagenUNet(**kw)
    tm.load_state_dict(imagen_from_flax(flat, tm))
    return jm, unflatten(flat), tm, x, t, cond


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= TOL * max(1.0, np.abs(want).max()), err


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_forward_matches_jax(name):
    jm, params, tm, x, t, cond = _bridge(name)
    drop = np.array([0.0, 1.0], np.float32)        # the second sample takes the null tokens
    apply = jax.jit(jm.apply)
    want = apply({"params": params}, jnp.asarray(x), jnp.asarray(t), cond=jnp.asarray(cond),
                 cond_drop_prob=jnp.asarray(drop))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(t), cond=torch.from_numpy(cond),
                 cond_drop_prob=torch.from_numpy(drop))
        kept = tm(torch.from_numpy(x), torch.from_numpy(t), cond=torch.from_numpy(cond))
        none = tm(torch.from_numpy(x), torch.from_numpy(t))
    _close(got, want)
    assert torch.equal(got[0], kept[0]) and not torch.allclose(got[1], kept[1])
    want_none = apply({"params": params}, jnp.asarray(x), jnp.asarray(t))
    _close(none, want_none)


def test_condition_drop_draw_and_the_fractional_guard(monkeypatch):
    jm, params, tm, x, t, cond = _bridge("default", b=4)
    draws = []
    real = jax.random.uniform

    def recorded(key, shape=(), *a, **k):
        u = real(key, shape, *a, **k)
        draws.append(np.asarray(u))
        return u

    monkeypatch.setattr(jax.random, "uniform", recorded)
    want = jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(t), cond=jnp.asarray(cond),
                    cond_drop_prob=0.5, rngs={"cond_drop": jax.random.PRNGKey(3)})
    monkeypatch.setattr(jax.random, "uniform", real)
    (u,) = draws
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(t), cond=torch.from_numpy(cond),
                 cond_drop_prob=0.5, cond_drop_u=torch.from_numpy(np.array(u)))
    _close(got, want)
    with pytest.raises(ValueError, match="fractional"):
        jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(t), cond=jnp.asarray(cond),
                 cond_drop_prob=0.5)
    with pytest.raises(ValueError, match="fractional"):
        tm(torch.from_numpy(x), torch.from_numpy(t), cond=torch.from_numpy(cond),
           cond_drop_prob=0.5)
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        a = tm(torch.from_numpy(x), torch.from_numpy(t), cond=torch.from_numpy(cond),
               cond_drop_prob=0.5, generator=g)
    assert torch.isfinite(a).all()


@pytest.mark.parametrize("scale", [0.0, 1.0, 2.5])
def test_forward_with_cond_scale_matches_jax(scale):
    jm, params, tm, x, t, cond = _bridge("default")
    want = jax.jit(jm.apply, static_argnums=3, static_argnames="method")(
        {"params": params}, jnp.asarray(x), jnp.asarray(t), scale, jnp.asarray(cond),
        method=jm.forward_with_cond_scale)
    with torch.no_grad():
        got = tm.forward_with_cond_scale(torch.from_numpy(x), torch.from_numpy(t), scale,
                                         torch.from_numpy(cond))
    _close(got, want)


def test_base_unet64_preset():
    with torch.device("meta"):                        # ≈1.7 B parameters: no storage
        m = tz.BaseUnet64(max_text_len=2, text_embed_dim=8)
    assert m.dim == 512 and m.in_out == [(512, 512), (512, 1024), (1024, 1536), (1536, 2048)]
    assert m.layer_attns == (False, True, True, True) and m.num_blocks == (3, 3, 3, 3)
    assert not hasattr(m, "down_0_attn") and hasattr(m, "down_3_attn")

"""`LatentFC`, `VDMUNet` and `DDPMUNet` of the port (`sgdm_tpu_torch/models/zoo.py`)
against `sgdm_tpu/models/zoo.py`, in float32 on the CPU: the JAX module's
parameters, every leaf drawn anew from a numpy seed
(`torch_port_common.perturbed_flat`), carried by `models/convert.py`
(`from_flax` for the MLP, `zoo_from_flax` for the UNets) into the port's
module; the forward agrees within 1e-5 of max|output|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgdm_tpu.models import zoo as jzoo
from sgdm_tpu_torch.models import zoo as tzoo
from sgdm_tpu_torch.models.convert import from_flax, zoo_from_flax

from torch_port_common import one_torch_thread, perturbed_flat, unflatten  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

UNETS = {
    "vdm": dict(dim=8, dim_mults=(1, 2), resnet_block_groups=4),
    "vdm_learned_sinusoidal": dict(dim=8, dim_mults=(1, 2), resnet_block_groups=4,
                                   learned_sinusoidal_cond=True, learned_sinusoidal_dim=8),
    "vdm_init_dim": dict(dim=8, init_dim=12, dim_mults=(1, 2, 2), resnet_block_groups=4,
                         learned_variance=True),
    "ddpm": dict(dim=8, dim_mults=(1, 2), resnet_block_groups=4),
    "ddpm_three_levels": dict(dim=8, init_dim=12, dim_mults=(1, 2, 2), resnet_block_groups=4),
}


def _err(got: np.ndarray, want) -> float:
    want = np.asarray(want)
    return float(np.abs(got - want).max()) / float(np.abs(want).max())


@pytest.mark.parametrize("name", list(UNETS))
def test_unet_forward_matches(name):
    kw = UNETS[name]
    jcls, tcls = (jzoo.DDPMUNet, tzoo.DDPMUNet) if name.startswith("ddpm") \
        else (jzoo.VDMUNet, tzoo.VDMUNet)
    rng = np.random.default_rng(len(name))
    x = rng.standard_normal((2, 16, 16, 3)).astype(np.float32)
    t = rng.uniform(0, 1, 2).astype(np.float32)
    jmod = jcls(**kw)
    shapes = jax.eval_shape(jmod.init, jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(t))
    flat = perturbed_flat(shapes["params"], 3)
    want = jax.jit(jmod.apply)({"params": unflatten(flat)}, jnp.asarray(x), jnp.asarray(t))
    model = tcls(**kw)
    model.load_state_dict(zoo_from_flax(flat, model))
    with torch.no_grad():
        got = model(torch.as_tensor(x), torch.as_tensor(t)).numpy()
        again = model.forward_with_cond_scale(torch.as_tensor(x), torch.as_tensor(t),
                                              cond_scale=3.0, cond=None).numpy()
    assert got.shape == want.shape and _err(got, want) <= 1e-5, _err(got, want)
    np.testing.assert_array_equal(again, got)


@pytest.mark.parametrize("kw", [
    dict(num_layers=3, num_channels=6, model_channels=10, num_time_emb_channels=8),
    dict(num_layers=4, num_time_layers=3, num_channels=6, model_channels=12,
         num_time_emb_channels=9, condition_bias=0.5, time_last_act=True, activation="lrelu",
         last_act="tanh"),
    dict(num_layers=2, num_channels=5, model_channels=7, num_time_emb_channels=4,
         use_norm=False, activation="relu"),
])
def test_latent_fc_forward_matches(kw):
    rng = np.random.default_rng(kw["num_layers"])
    x = rng.standard_normal((3, kw["num_channels"])).astype(np.float32)
    t = rng.uniform(0, 1000, 3).astype(np.float32)
    jmod = jzoo.LatentFC(**kw)
    shapes = jax.eval_shape(jmod.init, jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(t))
    flat = perturbed_flat(shapes["params"], 5)
    want = jmod.apply({"params": unflatten(flat)}, jnp.asarray(x), jnp.asarray(t))
    model = tzoo.LatentFC(**kw).eval()
    model.load_state_dict(from_flax(flat, model))
    with torch.no_grad():
        got = model(torch.as_tensor(x), torch.as_tensor(t)).numpy()
    assert _err(got, want) <= 1e-5, _err(got, want)


def test_port_exports_the_zoo():
    import sgdm_tpu_torch.models as tm

    assert tm.LatentFC is tzoo.LatentFC and tm.VDMUNet is tzoo.VDMUNet

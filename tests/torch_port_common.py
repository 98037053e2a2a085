"""Shared helpers for the `sgdm_tpu_torch` parity tests (tests/test_torch_*.py).

Inputs and weights are drawn with numpy from a seed and handed to both
packages; everything runs in float32 on the CPU.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from flax import traverse_util

SMALL_UNET = dict(
    model_channels=32, channel_mult=(1, 2, 2), num_res_blocks=1,
    attention_resolutions=(2,), num_heads=4, cond_dim=10,
)


def perturbed_flat(params, seed: int) -> dict[str, np.ndarray]:
    """Flatten a flax param tree (arrays or shape structs) with '/' and give
    EVERY leaf a random value (zero-initialised out_conv / proj_out
    included): kernels N(0, 1/fan_in), GroupNorm scales 1 + N(0, 0.1²),
    biases N(0, 0.1²)."""
    rng = np.random.default_rng(seed)
    flat = traverse_util.flatten_dict(params, sep="/")
    out = {}
    for path in sorted(flat):
        shape = tuple(flat[path].shape)
        leaf = path.rsplit("/", 1)[-1]
        if leaf == "bias":
            val = 0.1 * rng.standard_normal(shape)
        elif leaf == "scale":
            val = 1.0 + 0.1 * rng.standard_normal(shape)
        elif leaf == "embedding":
            val = rng.standard_normal(shape)
        else:
            val = rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
        out[path] = val.astype(np.float32)
    return out


def unflatten(flat: dict[str, np.ndarray]):
    import jax.numpy as jnp

    return traverse_util.unflatten_dict({k: jnp.asarray(v) for k, v in flat.items()}, sep="/")


def t32(a) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, dtype=np.float32))


def tiny_trainer_hparams(log_dir, *, seed: int = 23, **over) -> dict:
    """Hyperparameters of a tiny `SelfGuidedDiffusionTrainer` (either
    package's: the targets name `sgdm_tpu.…`, which the port reads as its
    own): a 2-level UNet on 8-px `label`-conditioned images, 20 diffusion
    steps, f32 compute, AdamW at a constant lr, one device."""
    hp = dict(
        condition_method="label", cond_dim=4, cond_scale=2.0, cond_drop_prob=0.1,
        dynamic={"target": "sgdm_tpu.models.factory.create_denoiser",
                 "params": dict(model_channels=16, out_channels=3, num_res_blocks=1,
                                channel_mult=[1, 2], attention_resolutions=[2], num_heads=2,
                                resblock_updown=True, cond_dim=4, condition_method="label",
                                image_size=8, dropout=0.1)},
        diffusion_model={"target": "sgdm_tpu.diffusion.GaussianDiffusion",
                         "params": {"num_timesteps": 20, "num_timesteps_imagelogger": 2}},
        optim={"name": "adamw", "params": {"lr": 1e-3, "wd": 0.01}, "scheduler_config": None},
        pl={"trainer": {"strategy": None}}, compute_dtype="float32", log_dir=str(log_dir),
        seed=seed)
    hp.update(over)
    return hp


def tiny_datamodule_cfg(train_len: int = 32, val_len: int = 16, batch_size: int = 8) -> dict:
    """A `DataModuleFromConfig` config of 8-px `SyntheticImages` with labels."""
    ds = lambda n, seed: {"target": "sgdm_tpu.data.synthetic.SyntheticImages",
                          "params": dict(size=8, num_classes=4, length=n, seed=seed,
                                         cond_key="label")}
    return {"target": "sgdm_tpu.data.datamodule.DataModuleFromConfig",
            "params": dict(batch_size=batch_size, num_workers=2, train=ds(train_len, 0),
                           validation=ds(val_len, 1))}


@pytest.fixture(scope="module")
def one_torch_thread():
    """Run a module's tiny models on one CPU thread: their ops are too small
    to gain from more, and the suite's workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

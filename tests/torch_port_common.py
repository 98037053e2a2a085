"""Shared helpers for the `sgdm_tpu_torch` parity tests (tests/test_torch_*.py).

Inputs and weights are drawn with numpy from a seed and handed to both
packages; everything runs in float32 on the CPU.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from flax import traverse_util

# assert_state_trees_close: a first gradient below NOISE of the largest is
# f32 rounding (2^-23, float32's epsilon); such elements may be at most
# EXEMPT_LEAF of a leaf (or one element) and EXEMPT_TREE of the tree
NOISE, EXEMPT_LEAF, EXEMPT_TREE = 2.0 ** -23, 5e-3, 1e-3

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
def one_thread():
    """`one_torch_thread`, and one thread in the BLAS and OpenMP pools of
    numpy, scipy and sklearn too: the suite's workers share the machine's
    cores, and a module that takes them all slows every other worker."""
    from threadpoolctl import threadpool_limits

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1):
        yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def one_torch_thread():
    """Run a module's tiny models on one CPU thread: their ops are too small
    to gain from more, and the suite's workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_state_tree(state) -> dict:
    """A JAX ``TrainState`` (optax.adamw) as the mapping of
    `models.convert.train_state_to_flax`: counts and '/'-flattened trees."""
    import jax

    adam, sched = state.opt_state[0], state.opt_state[2]
    f = lambda tree: {k: np.asarray(v) for k, v in
                      traverse_util.flatten_dict(jax.tree.map(np.asarray, tree), sep="/").items()}
    # a constant lr keeps no schedule count (an EmptyState); the port counts alike
    sched_count = adam.count if callable(getattr(sched, "count", None)) else sched.count
    return {"step": int(state.step), "count": int(adam.count),
            "schedule_count": int(sched_count),
            "ema_updates": int(state.ema_updates), "params": f(state.params),
            "ema_params": f(state.ema_params), "mu": f(adam.mu), "nu": f(adam.nu)}


def host_state_tree(host, model: torch.nn.Module) -> dict:
    """A one-device host state (`training.checkpoints.state_to_host`) of
    ``model`` as the mapping of `models.convert.train_state_to_flax`."""
    from sgdm_tpu_torch.models.convert import train_state_to_flax
    from sgdm_tpu_torch.training.optim import OptState
    from sgdm_tpu_torch.training.state import TrainState

    t = lambda k: torch.as_tensor(np.asarray(host[k]))
    layout = tuple((name, tuple(shape)) for name, shape in host["layout"])
    state = TrainState(int(host["step"]), t("params"), t("ema_params"),
                       OptState(int(host["count"]), t("mu"), t("nu"),
                                int(host["schedule_count"])),
                       int(host["ema_updates"]), layout)
    return train_state_to_flax(state, model)


def assert_state_trees_close(got: dict, ref: dict, *, lr: float, steps: int, what: str = "",
                             first_grads: dict | None = None):
    """tests/test_torch_train_step.py's tolerances: equal counts; params and
    EMA within 1e-4, μ and ν within 1e-3 of each tree's largest value;
    biases whose reference μ stays below 1e-5 of the largest (a GroupNorm of
    one-channel groups makes their gradient vanish, and Adam turns f32 noise
    there into steps of up to lr) within Adam's bound, 2·lr a step.

    ``first_grads``: the reference's first gradient, flax-keyed, or any
    multiple of it (a JAX run's μ after one step, (1 − β1)·g).  Each element
    of another leaf whose first gradient is nonzero and below NOISE of the
    largest (a sum that cancelled to its rounding) is held to that bound in
    the params and the EMA too: its first Adam step, g / (|g| + eps), takes
    the sign of rounding noise, so each side's may be anything in [−lr, lr].
    Those elements are counted and printed.  Leaving out the key third of a
    ``qkv/bias`` (its gradient vanishes identically: a constant added to
    every key shifts a query's logits by a constant), they may be at most
    EXEMPT_LEAF of a leaf, or one element, and EXEMPT_TREE of the tree.
    Returns {leaf: exempt elements}."""
    for key in ("step", "count", "schedule_count", "ema_updates"):
        assert got[key] == ref[key], (what, key, got[key], ref[key])
    mu_scale = max(np.abs(v).max() for v in ref["mu"].values())
    noise = {k for k, v in ref["mu"].items() if np.abs(v).max() < 1e-5 * mu_scale}
    assert all(k.endswith("/bias") for k in noise), noise
    bound = 2 * lr * steps
    exempt: dict[str, np.ndarray] = {}
    if first_grads is not None:
        g_scale = max(np.abs(v).max() for v in first_grads.values())
        exempt = {leaf: (g != 0) & (np.abs(g) < NOISE * g_scale)
                  for leaf, g in first_grads.items() if leaf not in noise}
        counts = {leaf: int(m.sum()) for leaf, m in exempt.items() if m.any()}
        keys = {leaf: int(m[m.size // 3:2 * m.size // 3].sum())
                for leaf, m in exempt.items() if leaf.endswith("qkv/bias")}
        rest = {leaf: c - keys.get(leaf, 0) for leaf, c in counts.items()}
        n = sum(m.size for m in exempt.values())
        print(f"{what}: {sum(counts.values())} of {n} elements held to Adam's bound "
              f"(first gradient nonzero, below 2^-23 of the largest), "
              f"{sum(keys.values())} of them in qkv biases' key thirds: {counts}")
        over = {leaf: (c, exempt[leaf].size) for leaf, c in rest.items()
                if c > max(1, EXEMPT_LEAF * exempt[leaf].size)}
        assert not over, (what, over)
        assert sum(rest.values()) <= EXEMPT_TREE * n, (what, sum(rest.values()), n)
    for key, rel in (("params", 1e-4), ("ema_params", 1e-4), ("mu", 1e-3), ("nu", 1e-3)):
        scale = max(np.abs(v).max() for v in ref[key].values())
        assert got[key].keys() == ref[key].keys(), (what, key)
        for leaf, r in ref[key].items():
            atol = np.full(r.shape, bound if leaf in noise else rel * scale)
            if leaf in exempt and key in ("params", "ema_params"):
                atol[exempt[leaf]] = bound
            bad = np.abs(got[key][leaf] - r) > atol
            assert not bad.any(), (f"{what} {key} {leaf}: {int(bad.sum())} of {r.size} "
                                   f"elements off, worst {np.abs(got[key][leaf] - r).max()}")
    return {leaf: int(m.sum()) for leaf, m in exempt.items()}


def first_step_grads(run: dict, model) -> dict:
    """The first step's gradient of a one-rank `torch_ranks.train_case` run
    (``return_grads``), flax-keyed."""
    from sgdm_tpu_torch.models.convert import to_flax

    flat = torch.as_tensor(run["metrics"][0]["grads"])
    views, off = {}, 0
    for name, p in model.named_parameters():
        views[name] = flat[off:off + p.numel()].view(p.shape)
        off += p.numel()
    return to_flax(views, model)


def jax_draws(rng, step: int, k: int, b: int, px: int, drop: float, num_timesteps: int = 1000):
    """The global batch's loss draws of the JAX train step at ``step``
    (fast_dropout_rng=False), micro-batch after micro-batch."""
    import jax

    loss_rng, _ = jax.random.split(jax.random.fold_in(rng, step))
    parts = []
    for i in range(k):
        r = loss_rng if k == 1 else jax.random.fold_in(loss_rng, i)
        t_key, noise_key, drop_key = jax.random.split(r, 3)
        m = b // k
        parts.append({"t": np.array(jax.random.randint(t_key, (m,), 0, num_timesteps)),
                      "noise": np.array(jax.random.normal(noise_key, (m, px, px, 3))),
                      "drop_mask": np.array(jax.random.uniform(drop_key, (m,)) < drop)})
    return {key: np.concatenate([p[key] for p in parts]) for key in parts[0]}


# `python -m sgdm_tpu_torch.main` on a tiny label-conditioned UNet and
# `synthetic32` at 8 px: 2 epochs of 4 steps, no image log
TINY_CLI = ["data=synthetic32", "sg.params.condition_method=label", "sg.params.cond_dim=4",
            "sg.params.cond_drop_prob=0.1", "sg.params.cond_scale=2", "data.num_classes=4",
            "+data.params.train.params.cond_key=label", "data.image_size=8",
            "data.params.batch_size=8", "data.params.num_workers=2",
            "dynamic.params.model_channels=16", "dynamic.params.channel_mult=[1]",
            "dynamic.params.num_res_blocks=1", "dynamic.params.attention_resolutions=[]",
            "dynamic.params.num_heads=2", "model.params.num_timesteps=20",
            "pl.trainer.limit_train_batches=4", "pl.trainer.limit_val_batches=1",
            "data.vis_every_iter=1000000000", "data.trainer.max_epochs=1",
            "sg.params.compute_dtype=float32"]


def profiled_cli_run(log_dir) -> "Path":
    """The CLI above with ``profile=true`` on the CPU: the trainer traces
    steps 2-3 of epoch 1.  Returns the trace's directory."""
    from pathlib import Path

    from sgdm_tpu_torch import main as port_main

    port_main.main(["--device", "cpu", *TINY_CLI, "profile=true", f"log_dir={log_dir}"])
    return Path(log_dir) / "profile"

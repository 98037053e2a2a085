"""Training loss of the port (`diffusion/schedule.py q_sample`,
`diffusion/losses.py`, `GaussianDiffusion.loss`) against the JAX package,
float32 on the CPU.  The JAX package's draws (t, noise, drop mask) are
rebuilt with its own calls and handed to the port; a denoiser that is the
same closed form on both sides keeps the model out of the comparison.
Tolerance 1e-6 relative (the same f32 arithmetic)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgdm_tpu.diffusion import GaussianDiffusion as JGaussianDiffusion
from sgdm_tpu.diffusion.losses import p_losses as jax_p_losses
from sgdm_tpu.diffusion.schedule import q_sample as jax_q_sample
from sgdm_tpu_torch.diffusion.core import GaussianDiffusion
from sgdm_tpu_torch.diffusion.guidance import prob_mask_like
from sgdm_tpu_torch.diffusion.losses import pointwise_loss
from sgdm_tpu_torch.diffusion.schedule import q_sample


def jax_draws(rng, shape, num_timesteps, cond_drop_prob):
    """The draws of `sgdm_tpu/diffusion/losses.py p_losses` for ``rng``."""
    t_key, noise_key, drop_key = jax.random.split(rng, 3)
    t = jax.random.randint(t_key, (shape[0],), 0, num_timesteps)
    noise = jax.random.normal(noise_key, shape, dtype=jnp.float32)
    drop = jax.random.uniform(drop_key, (shape[0],)) < cond_drop_prob
    return {"t": np.array(t), "noise": np.array(noise), "drop_mask": np.array(drop)}


def _denoise(xp):
    def fn(x, t, cond_drop_mask=None, cond=None):
        m = cond_drop_mask.astype(np.float32) if xp is jnp else cond_drop_mask.float()
        c = cond.sum(-1) if cond is not None else 0.0
        return 0.5 * x + (1e-3 * t + 0.3 * m + c).reshape(-1, 1, 1, 1)
    return fn


def test_q_sample_matches_jax():
    rng = np.random.default_rng(0)
    x, noise = (rng.standard_normal((4, 8, 8, 3)).astype(np.float32) for _ in range(2))
    t = np.asarray([0, 1, 500, 999])
    jd, td = JGaussianDiffusion(), GaussianDiffusion()
    ref = jax_q_sample(jd.schedule, jnp.asarray(x), jnp.asarray(t), jnp.asarray(noise))
    got = q_sample(td.schedule, torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(noise))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("loss_type", ["l2", "l1", "huber"])
def test_p_losses_with_handed_in_draws_match_jax(loss_type):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((6, 8, 8, 3)).astype(np.float32)
    cond = np.eye(5, dtype=np.float32)[[0, 1, 2, 3, 4, 0]]
    key = jax.random.PRNGKey(3)
    jd = JGaussianDiffusion(loss_type=loss_type)
    loss, aux = jax_p_losses(jd.schedule, _denoise(jnp), key, jnp.asarray(x),
                             cond_kwargs={"cond": jnp.asarray(cond)}, cond_drop_prob=0.5,
                             loss_type=loss_type)
    draws = jax_draws(key, x.shape, 1000, 0.5)
    td = GaussianDiffusion(loss_type=loss_type)
    tl, taux = td.loss(_denoise(torch), None, torch.from_numpy(x),
                       cond_kwargs={"cond": torch.from_numpy(cond)}, cond_drop_prob=0.5,
                       **{k: torch.from_numpy(v) for k, v in draws.items()})
    np.testing.assert_allclose(tl.item(), float(loss), rtol=1e-6)
    np.testing.assert_array_equal(taux["epoch_stats_x"].numpy(), np.asarray(aux["epoch_stats_x"]))
    np.testing.assert_allclose(taux["epoch_stats_y"].numpy(), np.asarray(aux["epoch_stats_y"]),
                               rtol=1e-6)
    assert draws["drop_mask"].any() and not draws["drop_mask"].all()


def test_loss_draws_from_the_generator():
    td = GaussianDiffusion()
    x = torch.zeros(64, 4, 4, 3)
    gen = torch.Generator().manual_seed(0)
    loss, aux = td.loss(_denoise(torch), gen, x, cond_drop_prob=0.25)
    t = aux["epoch_stats_x"]
    assert t.dtype == torch.int64 and 0 <= t.min() and t.max() < 1000 and len(t.unique()) > 30
    assert torch.isfinite(loss)
    gen2 = torch.Generator().manual_seed(0)
    loss2, _ = td.loss(_denoise(torch), gen2, x, cond_drop_prob=0.25)
    assert loss2.item() == loss.item()


def test_pointwise_loss_and_mask():
    a, b = torch.tensor([0.0, 0.5, 3.0]), torch.tensor([0.0, 0.0, 0.0])
    torch.testing.assert_close(pointwise_loss(a, b, "l1"), torch.tensor([0.0, 0.5, 3.0]))
    torch.testing.assert_close(pointwise_loss(a, b, "l2"), torch.tensor([0.0, 0.25, 9.0]))
    torch.testing.assert_close(pointwise_loss(a, b, "huber"), torch.tensor([0.0, 0.125, 2.5]))
    with pytest.raises(NotImplementedError):
        pointwise_loss(a, b, "l3")
    gen = torch.Generator().manual_seed(0)
    assert not prob_mask_like(gen, 100, 0.0).any()
    assert prob_mask_like(gen, 100, 1.0).all()
    per = prob_mask_like(gen, 4, torch.tensor([0.0, 1.0, 0.0, 1.0]))
    assert per.tolist() == [False, True, False, True]

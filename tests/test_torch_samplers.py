"""Every sampler of the JAX registry in the port, against `sgdm_tpu`, in
float32 on the CPU (the UNet trajectories are in
`tests/test_torch_sampler_trajectories.py`).

  * tables: the posterior tables (every beta schedule, both
    parameterizations, v_posterior 0 and 0.1) and the posterior step math;
    PNDM's own ᾱ table and timestep lists; the EDM sigma, gamma and c_noise
    lists as the JAX sampler scans them; the VDM log-SNR the model is fed;
    the continuous-DDIM sub-schedule; all to rtol 1e-6, as
    `tests/test_torch_schedule_ddim.py` holds DDIM's;
  * the JAX package's distribution checks on the analytic Gaussian denoiser
    (`tests/test_samplers.py`, `tests/test_continuous_samplers.py`);
  * the learned VDM schedule through `noise_schedule_from_flax`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgdm_tpu.diffusion import schedule as jsched
from sgdm_tpu.diffusion.core import SAMPLER_REGISTRY as JAX_REGISTRY
from sgdm_tpu.diffusion.core import GaussianDiffusion as JDiffusion
from sgdm_tpu.diffusion.samplers import continuous as jcont
from sgdm_tpu.diffusion.samplers import edm as jedm
from sgdm_tpu.diffusion.samplers import pndm as jpndm
from sgdm_tpu_torch.diffusion import schedule as tsched
from sgdm_tpu_torch.diffusion.core import SAMPLER_REGISTRY, GaussianDiffusion
from sgdm_tpu_torch.diffusion.samplers import continuous as tcont
from sgdm_tpu_torch.diffusion.samplers import ddpm as tddpm
from sgdm_tpu_torch.diffusion.samplers import edm as tedm
from sgdm_tpu_torch.diffusion.samplers import pndm as tpndm
from sgdm_tpu_torch.models.convert import noise_schedule_from_flax

CPU = torch.device("cpu")
POSTERIOR = ("log_one_minus_alphas_cumprod", "posterior_variance",
             "posterior_log_variance_clipped", "posterior_mean_coef1", "posterior_mean_coef2",
             "lvlb_weights")


# ------------------------------------------------------------------ tables

@pytest.mark.parametrize("v_posterior", [0.0, 0.1])
@pytest.mark.parametrize("parameterization", ["eps", "x0"])
@pytest.mark.parametrize("beta_schedule", ["linear", "cosine", "sqrt_linear", "sqrt"])
def test_posterior_tables_match(beta_schedule, parameterization, v_posterior):
    kw = dict(beta_schedule=beta_schedule, parameterization=parameterization,
              v_posterior=v_posterior)
    js = jsched.DiffusionSchedule.create(**kw)
    ts = GaussianDiffusion(**kw).schedule   # v_posterior reaches the schedule
    assert ts.v_posterior == v_posterior
    for name in POSTERIOR:
        np.testing.assert_allclose(ts.f32(name), np.asarray(getattr(js, name)), rtol=1e-6,
                                   err_msg=name)


def test_posterior_step_math_matches():
    rng = np.random.default_rng(0)
    js = jsched.DiffusionSchedule.create(v_posterior=0.1)
    ts = tsched.DiffusionSchedule.create(v_posterior=0.1)
    x0, xt, eps = (rng.standard_normal((4, 3, 3, 2)).astype(np.float32) for _ in range(3))
    t = np.asarray([0, 1, 500, 999], np.int32)
    J, T = (lambda a: jnp.asarray(a)), (lambda a: torch.from_numpy(a))
    pairs = [
        (jsched.q_posterior(js, J(x0), J(xt), J(t)), tsched.q_posterior(ts, T(x0), T(xt), T(t))),
        ((jsched.predict_start_from_noise(js, J(xt), J(t), J(eps)),),
         (tsched.predict_start_from_noise(ts, T(xt), T(t), T(eps)),)),
        ((jsched.predict_noise_from_start(js, J(xt), J(t), J(x0)),),
         (tsched.predict_noise_from_start(ts, T(xt), T(t), T(x0)),)),
        ((jsched.normalize_to_neg_one_to_one(J(x0)),),
         (tsched.normalize_to_neg_one_to_one(T(x0)),)),
        ((js.time_to_sigma(J(t)),), (ts.time_to_sigma(T(t)),)),
    ]
    for want, got in pairs:
        for w, g in zip(want, got):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)
    sigma = np.asarray([0.0, 0.3, 0.5, 0.999], np.float32)
    np.testing.assert_array_equal(ts.sigma_to_time_int(T(sigma)).numpy(),
                                  np.asarray(js.sigma_to_time_int(J(sigma))))


@pytest.mark.parametrize("it", [0, 1, 999])
def test_int_timestep_reads_equal_per_sample_reads(it):
    """An int t (how the ancestral sampler reads its tables, as host floats)
    gives the values of a per-sample t tensor, bit for bit."""
    rng = np.random.default_rng(1)
    ts = tsched.DiffusionSchedule.create(v_posterior=0.1)
    x0, xt = (torch.from_numpy(rng.standard_normal((2, 3, 3, 2)).astype(np.float32))
              for _ in range(2))
    t = torch.full((2,), it, dtype=torch.int32)
    for got, want in zip(tsched.q_posterior(ts, x0, xt, it), tsched.q_posterior(ts, x0, xt, t)):
        torch.testing.assert_close(torch.as_tensor(got).expand_as(want), want, rtol=0, atol=0)
    eps_fn = lambda x, tt: x * 0.5 + tt.float().reshape(-1, 1, 1, 1) * 1e-3
    for got, want in zip(tddpm.p_mean_variance(ts, eps_fn, xt, it),
                         tddpm.p_mean_variance(ts, eps_fn, xt, t)):
        torch.testing.assert_close(torch.as_tensor(got).expand_as(want), want, rtol=0, atol=0)


@pytest.mark.parametrize("T,S,schedule", [(1000, 50, "linear"), (1000, 4, "linear"),
                                          (100, 10, "squaredcos_cap_v2"), (1000, 250, "linear")])
def test_pndm_tables_match(T, S, schedule):
    np.testing.assert_array_equal(tpndm.pndm_alphas_cumprod(T, 1e-4, 2e-2, schedule),
                                  jpndm._pndm_alphas_cumprod(T, 1e-4, 2e-2, schedule))
    warmup, main = tpndm.pndm_time_steps(T, S)
    assert warmup == [int(v) for v in jpndm._warmup_time_steps(T, S)]
    assert main == jpndm._main_time_steps(T, S)
    assert len(warmup) == 12 and len(main) == S - 3


def _scan_inputs(monkeypatch, fn):
    """The xs of the (one) `lax.scan` that ``fn`` runs."""
    seen, real = [], jax.lax.scan

    def scan(f, init, xs, *a, **k):
        seen.append(xs)
        return real(f, init, xs, *a, **k)

    monkeypatch.setattr(jax.lax, "scan", scan)
    fn()
    monkeypatch.undo()
    (xs,) = seen
    return [np.asarray(x) for x in xs]


@pytest.mark.parametrize("N,churn", [(50, 80.0), (18, 0.0)])
def test_edm_lists_match(monkeypatch, N, churn):
    xs = _scan_inputs(monkeypatch, lambda: jedm.edm_sample(
        lambda x, t: jnp.zeros_like(x), jax.random.PRNGKey(0), (1, 2, 2, 1), num_steps=N,
        s_churn=churn))
    sig, gam, cn = (a.astype(np.float32) for a in tedm.edm_schedule(N, s_churn=churn))
    for got, want in zip((sig[:N], sig[1:], gam, cn[:N], cn[1:]), xs[:5]):
        np.testing.assert_array_equal(got, want)
    assert (gam > 0).any() == (churn > 0)


def _recording(seen):
    def denoise(x, t):
        seen.append(t.numpy().copy())
        return torch.zeros_like(x)
    return denoise


class _Stop(Exception):
    """Ends a sampler once what a test reads of it has been built."""


@pytest.mark.parametrize("schedule,steps", [("cosine", 25), ("sqrt_linear", 9)])
def test_vdm_log_snr_fed_to_the_model_matches(schedule, steps):
    jseen, tseen = [], []

    def jdenoise(x, t):   # the JAX scan is compiled: its inputs come back by callback
        jax.debug.callback(lambda v: jseen.append(np.asarray(v).copy()), t, ordered=True)
        return jnp.zeros_like(x)

    img, _ = JDiffusion(beta_schedule=schedule).sample(
        "vdm", jdenoise, jax.random.PRNGKey(0), (2, 2, 2, 1), num_steps=steps)
    jax.block_until_ready(img)
    jax.effects_barrier()
    GaussianDiffusion(beta_schedule=schedule).sample(
        "vdm", _recording(tseen), torch.Generator().manual_seed(0), (2, 2, 2, 1),
        device=CPU, num_steps=steps)
    assert len(tseen) == len(jseen) == steps
    np.testing.assert_allclose(np.stack(tseen), np.stack(jseen), rtol=1e-6)
    assert tseen[0].dtype == np.float32 and (np.diff(np.stack(tseen)[:, 0]) > 0).all()


@pytest.mark.parametrize("eta", [0.0, 0.5])
@pytest.mark.parametrize("schedule", ["cosine", "sqrt_linear"])
def test_ddim_continuous_tables_match(monkeypatch, schedule, eta):
    made = {}

    def recorder(key, cls):
        class Rec(cls):
            def __init__(self, *a):
                super().__init__(*a)
                made[key] = self
                raise _Stop
        return Rec

    monkeypatch.setattr(jcont, "DDIMParams", recorder("jax", jcont.DDIMParams))
    monkeypatch.setattr(tcont, "DDIMParams", recorder("torch", tcont.DDIMParams))
    with pytest.raises(_Stop):
        JDiffusion(beta_schedule=schedule).sample(
            "ddim_continuous", lambda x, t: x, jax.random.PRNGKey(0), (1, 2, 2, 1),
            num_steps=10, ddim_eta=eta)
    with pytest.raises(_Stop):
        GaussianDiffusion(beta_schedule=schedule).sample(
            "ddim_continuous", lambda x, t: x, torch.Generator(), (1, 2, 2, 1), device=CPU,
            num_steps=10, ddim_eta=eta)
    j, t = made["jax"], made["torch"]
    np.testing.assert_array_equal(t.timesteps, j.timesteps)
    for name in ("alphas", "alphas_prev", "sigmas", "sqrt_one_minus_alphas"):
        np.testing.assert_allclose(getattr(t, name), np.asarray(getattr(j, name)), rtol=1e-6,
                                   atol=1e-12, err_msg=name)
    assert (np.asarray(t.sigmas) > 0).any() == (eta > 0)


def test_registry_and_its_errors():
    assert SAMPLER_REGISTRY == JAX_REGISTRY
    diff = GaussianDiffusion()
    with pytest.raises(KeyError, match="euler"):
        diff.sample("euler", lambda x, t: x, torch.Generator(), (1, 4, 4, 3), device=CPU)
    for name in ("vdm", "ddim_continuous"):
        for schedule in ("linear", "sqrt"):
            with pytest.raises(ValueError, match="log-SNR"):
                GaussianDiffusion(num_timesteps=50, beta_schedule=schedule).sample(
                    name, lambda x, t: x, torch.Generator(), (2, 8, 8, 3), device=CPU,
                    num_steps=4)
    with pytest.raises(NotImplementedError, match="cosine"):   # PNDM's own table, as JAX
        GaussianDiffusion(beta_schedule="cosine").sample(
            "pndm", lambda x, t: x, torch.Generator(), (1, 4, 4, 3), device=CPU, num_steps=4)


# ------------------------------------------- the analytic Gaussian denoiser

SHAPE = (256, 4, 4, 1)


def _gaussian_denoiser(diffusion):
    table = torch.as_tensor(diffusion.schedule.f32("sqrt_one_minus_alphas_cumprod"))
    return lambda x, t: table[t.long()].reshape(-1, 1, 1, 1) * x


def _standard_normal(x, atol_mean=0.1, rtol_std=0.12):
    flat = x.double().numpy().ravel()
    assert abs(flat.mean()) < atol_mean, flat.mean()
    assert abs(flat.std() - 1.0) < rtol_std, flat.std()


@pytest.mark.parametrize("name,kw", [("native", {}), ("ddim", {"ddim_eta": 0.0}),
                                     ("ddim", {"ddim_eta": 1.0}), ("plms", {})])
def test_sampler_gives_the_analytic_distribution(name, kw):
    diff = GaussianDiffusion(num_timesteps=1000)
    img, inter = diff.sample(name, _gaussian_denoiser(diff), torch.Generator().manual_seed(6),
                             SHAPE, device=CPU, clip_denoised=False, return_uint8=False, **kw)
    _standard_normal(img)
    assert tuple(inter["x_inter"].shape) == (10, *SHAPE)
    assert inter["pred_x0"].shape[0] == 10


def test_native_uint8_and_repeat_noise():
    diff = GaussianDiffusion(num_timesteps=20)
    img, inter = diff.sample("native", _gaussian_denoiser(diff), torch.Generator(), (8, 4, 4, 1),
                             device=CPU)
    assert img.dtype == torch.uint8 and inter["pred_x0"].dtype == torch.uint8
    one = tddpm.noise_like(torch.Generator().manual_seed(0), (3, 2, 2, 1), CPU, repeat=True)
    assert tuple(one.shape) == (3, 2, 2, 1) and torch.equal(one[0], one[2])


def test_pndm_and_tero_run_on_the_analytic_denoiser():
    diff = GaussianDiffusion(num_timesteps=1000)
    img, _ = diff.sample("pndm", _gaussian_denoiser(diff), torch.Generator().manual_seed(7),
                         (64, 4, 4, 1), device=CPU, num_steps=50, return_uint8=False)
    flat = img.double().numpy().ravel()   # PNDM's own beta table: only a sanity check
    assert np.isfinite(flat).all() and abs(flat.mean()) < 0.3 and 0.5 < flat.std() < 2.0
    img, _ = diff.sample("tero", _gaussian_denoiser(diff), torch.Generator().manual_seed(8),
                         (4, 4, 4, 1), device=CPU, num_steps=40, return_uint8=False)
    assert tuple(img.shape) == (4, 4, 4, 1) and torch.isfinite(img).all()


def test_log_snr_schedules_match_their_formulas_and_jax():
    t = np.linspace(0.01, 0.99, 17)
    lin, cos = tcont.beta_linear_log_snr(t), tcont.alpha_cosine_log_snr(t)
    np.testing.assert_allclose(lin, -np.log(np.expm1(1e-4 + 10 * t ** 2)), rtol=1e-12)
    np.testing.assert_allclose(cos, -np.log(np.cos((t + 0.008) / 1.008 * np.pi / 2) ** -2 - 1),
                               rtol=1e-12)
    assert (np.diff(lin) < 0).all() and (np.diff(cos) < 0).all()
    t32 = t.astype(np.float32)
    for tfn, jfn in ((tcont.beta_linear_log_snr, jcont.beta_linear_log_snr),
                     (tcont.alpha_cosine_log_snr, jcont.alpha_cosine_log_snr)):
        np.testing.assert_allclose(tfn(torch.from_numpy(t32)).numpy(),
                                   np.asarray(jfn(jnp.asarray(t32))), rtol=1e-5)


def test_vdm_q_sample_keeps_unit_variance():
    g = torch.Generator().manual_seed(0)
    x0 = torch.randn((64, 8, 8, 3), generator=g)
    xt, log_snr = tcont.vdm_q_sample(tcont.beta_linear_log_snr, g, x0, torch.full((64,), 0.5))
    assert xt.shape == x0.shape and tuple(log_snr.shape) == (64,)
    assert abs(float(xt.std()) - 1.0) < 0.05


def _vdm_denoiser(x, log_snr):
    return torch.sqrt(torch.sigmoid(-log_snr)).reshape(-1, 1, 1, 1) * x


def test_vdm_and_continuous_ddim_give_the_analytic_distribution():
    img, inter = tcont.vdm_sample(tcont.beta_linear_log_snr, _vdm_denoiser,
                                  torch.Generator().manual_seed(0), (64, 8, 8, 3), device=CPU,
                                  num_steps=50, clip_denoised=False)
    assert tuple(img.shape) == (64, 8, 8, 3) and inter["pred_x0"].shape[0] == 10
    assert abs(float(img.mean())) < 0.1 and abs(float(img.std()) - 1.0) < 0.15
    n_t = 200
    alpha_fn = lambda t: torch.sigmoid(tcont.beta_linear_log_snr(t))
    table = torch.sqrt(1.0 - alpha_fn(torch.as_tensor(np.linspace(0, 1, n_t), dtype=torch.float32)))
    img, _ = tcont.ddim_continuous_sample(
        alpha_fn, lambda x, t: table[t.long()].reshape(-1, 1, 1, 1) * x,
        torch.Generator().manual_seed(0), (64, 8, 8, 3), device=CPU, num_ddpm_timesteps=n_t,
        num_steps=25, clip_denoised=False)
    assert abs(float(img.mean())) < 0.1 and abs(float(img.std()) - 1.0) < 0.15


@pytest.mark.parametrize("name", ["vdm", "ddim_continuous"])
def test_continuous_registry_dispatch(name):
    diff = GaussianDiffusion(num_timesteps=100, beta_schedule="sqrt_linear")
    if name == "vdm":
        denoise = _vdm_denoiser
    else:
        table = torch.sqrt(1.0 - torch.sigmoid(tcont.beta_linear_log_snr(
            torch.as_tensor(np.linspace(0, 1, 100), dtype=torch.float32))))
        denoise = lambda x, t: table[t.long()].reshape(-1, 1, 1, 1) * x
    img, _ = diff.sample(name, denoise, torch.Generator().manual_seed(0), (8, 8, 8, 3),
                         device=CPU, num_steps=10, clip_denoised=False)
    assert tuple(img.shape) == (8, 8, 8, 3) and img.dtype == torch.uint8
    assert 110 < float(img.float().mean()) < 145


# ------------------------------------------------------ the learned schedule

def test_learned_noise_schedule_matches_flax():
    jm = jcont.LearnedNoiseSchedule(log_snr_max=9.2, log_snr_min=-6.9, hidden_dim=32,
                                    frac_gradient=0.25)
    t = np.linspace(0.0, 1.0, 33).astype(np.float32)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(t))["params"]
    # biases away from 0 so |b| is exercised
    params = jax.tree_util.tree_map(lambda a: a + 0.1 * jnp.sign(jnp.cos(jnp.arange(a.size)))
                                    .reshape(a.shape), params)
    tm = tcont.LearnedNoiseSchedule(9.2, -6.9, hidden_dim=32, frac_gradient=0.25)
    tm.load_state_dict(noise_schedule_from_flax(jax.device_get(params), tm))
    want, inter = jax.jit(lambda p, tt: jm.apply({"params": p}, tt, capture_intermediates=True))(
        params, jnp.asarray(t))
    got = tm(torch.from_numpy(t))
    # every dense layer at t = 0, 1 and t, as flax calls them
    with torch.no_grad():
        for k, tt in enumerate((np.zeros_like(t), np.ones_like(t), t)):
            h0 = tm.l0(torch.from_numpy(tt)[:, None])
            h1 = tm.l1(h0)
            h2 = tm.l2(torch.sigmoid(h1))
            for name, h in (("l0", h0), ("l1", h1), ("l2", h2)):
                np.testing.assert_allclose(
                    h.numpy(), np.asarray(inter["intermediates"][name]["__call__"][k]),
                    rtol=1e-6, err_msg=name)
    # the endpoint normalisation divides by net(1) - net(0): float32 rounding
    # of the net's outputs (|net| ≤ n_max) moves the result by up to
    # eps·|slope|·n_max / (net(1) - net(0)) on either side
    n0 = np.asarray(inter["intermediates"]["l0"]["__call__"][0] +
                    inter["intermediates"]["l2"]["__call__"][0])
    n1 = np.asarray(inter["intermediates"]["l0"]["__call__"][1] +
                    inter["intermediates"]["l2"]["__call__"][1])
    tol = 4 * np.finfo(np.float32).eps * 16.1 * np.abs(n1).max() / (n1 - n0).min()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=tol)
    np.testing.assert_allclose(got[0].item(), 9.2, atol=1e-4)
    np.testing.assert_allclose(got[-1].item(), -6.9, atol=1e-4)
    assert (np.diff(got.detach().numpy()) <= 1e-6).all()
    # frac_gradient: a quarter of the gradient goes through, as stop_gradient lets it
    jgrad = jax.jit(jax.grad(lambda p: jm.apply({"params": p}, jnp.asarray(t)).sum()))(params)
    got.sum().backward()
    np.testing.assert_allclose(tm.l1.weight.grad.numpy().T, np.asarray(jgrad["l1"]["kernel"]),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(tm.l0.weight.grad.numpy().T, np.asarray(jgrad["l0"]["kernel"]),
                               rtol=1e-4, atol=1e-6)


def test_vdm_sample_takes_a_learned_schedule():
    tm = tcont.LearnedNoiseSchedule(9.2, -6.9, hidden_dim=16)
    seen = []
    tcont.vdm_sample(tm, _recording(seen), torch.Generator(), (1, 2, 2, 1), device=CPU,
                     num_steps=5)
    with torch.no_grad():
        want = tm(torch.as_tensor(np.linspace(1.0, 0.0, 6), dtype=torch.float32))[:5]
    np.testing.assert_array_equal(np.stack(seen)[:, 0], want.numpy())

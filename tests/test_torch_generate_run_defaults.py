"""`generate --run` with no ``--steps``, ``--out`` or ``--image-size``:
the port's CLI takes the JAX CLI's defaults.

Tiny runs of the port's trainer CLI (8 px; the linear schedule, and the
cosine one that `vdm` and `ddim_continuous` need) are sampled by both
CLIs, each run's ``config.json`` also written as the ``config.yaml`` the
JAX CLI reads.  The JAX CLI restores no checkpoint here (the runs hold the
port's) and its model is a stub that counts its calls: the test reads the
number of model calls its sampler loop makes, not its images.  The JAX CLI
hands 250 steps to every sampler (`sgdm_tpu/generate.py` ``--steps``
default); the port's CLI must make the same number of model calls for each
sampler (DDIM 250, PLMS 251, PNDM 259, tero 500, vdm 250; native every
timestep of the run's diffusion, 100 on a third run), write ``samples/`` PNGs named as JAX names them, and
sample at the run's own image size.  JAX's jitted sampling program cannot
run ``ddim_continuous`` (its ᾱ grid is read on the host inside the trace,
`sgdm_tpu/diffusion/samplers/continuous.py:236-241`): there the port's
calls are held to the 250 steps the JAX CLI hands the sampler.
"""

import json

import jax
import jax.numpy as jnp
import pytest
import torch
import yaml

import sgdm_tpu.generate as jax_generate
import sgdm_tpu.training.state as jax_state
from sgdm_tpu_torch import main as port_main
from sgdm_tpu_torch.diffusion.core import SAMPLER_REGISTRY
from sgdm_tpu_torch.generate import main as generate_main
from sgdm_tpu_torch.generate import read_png
from sgdm_tpu_torch.models.unet import UNetModel

from torch_port_common import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

PX = 8


COSINE = ("vdm", "ddim_continuous")   # the continuous-time samplers need the cosine schedule


def _run(root, schedule, timesteps=1000):
    log_dir = root / f"{schedule}{timesteps}"
    port_main.main([
        "--device", "cpu", "data=synthetic32", "sg.params.condition_method=label",
        "sg.params.cond_dim=10", "sg.params.cond_drop_prob=0.1", "sg.params.cond_scale=2",
        "+data.params.train.params.cond_key=label", f"data.image_size={PX}",
        "data.params.batch_size=4", "data.params.num_workers=1",
        "dynamic.params.model_channels=16", "dynamic.params.channel_mult=[1]",
        "dynamic.params.num_res_blocks=1", "dynamic.params.attention_resolutions=[]",
        "pl.trainer.limit_train_batches=1",
        "pl.trainer.limit_val_batches=1", "data.vis_every_iter=1000000000",
        # a float: PyYAML reads the config's 8e-3 as a string, in both packages
        f"model.params.beta_schedule={schedule}", "model.params.cosine_s=0.008",
        f"model.params.num_timesteps={timesteps}", "data.trainer.max_epochs=0",
        "log_dir=" + str(log_dir)])
    cfg = json.loads((log_dir / "config.json").read_text())
    (log_dir / "config.yaml").write_text(yaml.safe_dump(cfg))
    return log_dir


@pytest.fixture(scope="module")
def runs(tmp_path_factory, one_torch_thread):
    root = tmp_path_factory.mktemp("runs")
    # native makes one call a timestep whatever the steps: a 100-step diffusion
    return {"linear": _run(root, "linear"), "cosine": _run(root, "cosine"),
            "native": _run(root, "linear", 100)}


def _jax_cli_calls(run_dir, cwd, monkeypatch, sampler):
    """Model calls of ``python -m sgdm_tpu.generate --run RUN --sampler S
    --n 1`` (the sampler loop as JAX runs it, a call-counting stub model)."""
    calls, steps = [], []
    real_make = jax_state.make_sample_fn

    def counting_apply(model, params, dropout_rng=None, train=False):
        def apply_fn(x, t, cond_drop_mask=None, **cond_kwargs):
            jax.debug.callback(lambda: calls.append(1))
            return jnp.zeros_like(x)
        return apply_fn

    def recording_make(*a, **k):
        steps.append(k["num_steps"])
        return real_make(*a, **k)

    monkeypatch.chdir(cwd)
    with monkeypatch.context() as m:
        m.setenv("SGDM_FORCE_CPU", "1")
        m.setattr(jax_generate, "_restore", lambda trainer, path: trainer.state)
        m.setattr(jax_state, "_apply_denoiser", counting_apply)
        m.setattr(jax_state, "make_sample_fn", recording_make)
        try:
            jax_generate.main(["--run", str(run_dir), "--sampler", sampler, "--n", "1",
                               "--labels", "3"])
        except jax.errors.TracerArrayConversionError:
            assert sampler == "ddim_continuous"
            return None, steps[0]
    return len(calls), steps[0]


def _port_cli_calls(run_dir, cwd, monkeypatch, sampler, *extra):
    calls = []
    hook = torch.nn.modules.module.register_module_forward_hook(
        lambda mod, args, out: calls.append(1) if isinstance(mod, UNetModel) else None)
    monkeypatch.chdir(cwd)
    try:
        generate_main(["--run", str(run_dir), "--device", "cpu", "--sampler", sampler,
                       "--n", "1", "--labels", "3", *extra])
    finally:
        hook.remove()
    return len(calls)


@pytest.mark.parametrize("sampler", SAMPLER_REGISTRY)
def test_no_steps_makes_the_jax_model_calls(runs, tmp_path, monkeypatch, sampler):
    run_dir = runs["cosine" if sampler in COSINE else "native" if sampler == "native" else "linear"]
    (tmp_path / "jax").mkdir()
    jax_calls, jax_steps = _jax_cli_calls(run_dir, tmp_path / "jax", monkeypatch, sampler)
    assert jax_steps == 250   # the JAX CLI's --steps default, handed to every sampler
    (tmp_path / "port").mkdir()
    port_calls = _port_cli_calls(run_dir, tmp_path / "port", monkeypatch, sampler)
    if jax_calls is None:   # ddim_continuous: one model call a step
        jax_calls = jax_steps
    assert port_calls == jax_calls, (sampler, port_calls, jax_calls)
    assert port_calls == {"native": 100, "ddim": 250, "plms": 251, "pndm": 259,
                          "tero": 500}.get(sampler, 250)
    if sampler == "ddim_continuous":
        return   # the JAX CLI raised before writing
    jax_pngs = sorted(p.name for p in (tmp_path / "jax" / "samples").glob("*.png"))
    port_pngs = sorted((tmp_path / "port" / "samples").glob("*.png"))
    assert [p.name for p in port_pngs] == jax_pngs and len(jax_pngs) == 1
    assert read_png(port_pngs[0]).shape == (PX, PX, 3)


def test_explicit_flags_still_win(runs, tmp_path, monkeypatch, capsys):
    (tmp_path / "cwd").mkdir()
    calls = _port_cli_calls(runs["linear"], tmp_path / "cwd", monkeypatch, "ddim", "--steps", "4",
                            "--out", str(tmp_path / "out"), "--image-size", "16")
    assert calls == 4 and "sampled (1, 16, 16, 3)" in capsys.readouterr().out
    assert read_png(next((tmp_path / "out").glob("*.png"))).shape == (16, 16, 3)
    assert not (tmp_path / "cwd" / "samples").exists()


def test_without_run_each_sampler_keeps_its_default(tmp_path, monkeypatch):
    """No --run: ``generate(steps=None)``, each sampler's own default (DDIM 50)."""
    (tmp_path / "cwd").mkdir()
    monkeypatch.chdir(tmp_path / "cwd")
    calls = []
    hook = torch.nn.modules.module.register_module_forward_hook(
        lambda mod, args, out: calls.append(1) if isinstance(mod, UNetModel) else None)
    try:
        generate_main(["--device", "cpu", "--image-size", "8", "--model-channels", "32",
                       "--cond-dim", "4", "--n", "1"])
    finally:
        hook.remove()
    assert len(calls) == 50
    assert not (tmp_path / "cwd" / "samples").exists()   # no PNGs without --out

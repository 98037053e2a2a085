"""The samplers of the registry through the port's entry points, on the CPU:
`generate(sampler=…)` for every name (each one's model calls counted),
``python -m sgdm_tpu_torch.generate --sampler``, a tiny training run whose
``sampling_imagelogger`` / ``sampling_test`` / ``sampling_val`` name
``plms``, ``native`` and ``pndm`` (its image logger samples under PLMS
while it trains), `generate_from_run` on it, and the eval harness's batch
sampler under the run's ``sampling_val``."""

import json

import numpy as np
import pytest
import torch

from sgdm_tpu_torch import main as port_main
from sgdm_tpu_torch.data.synthetic import SyntheticImages
from sgdm_tpu_torch.diffusion.core import SAMPLER_REGISTRY, GaussianDiffusion
from sgdm_tpu_torch.diffusion.samplers.pndm import pndm_time_steps
from sgdm_tpu_torch.eval.harness import _make_batch_sample_fn
from sgdm_tpu_torch.generate import generate, generate_from_run, load_run
from sgdm_tpu_torch.generate import main as generate_main
from sgdm_tpu_torch.generate import read_png

from torch_port_common import SMALL_UNET, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

PX = 16
CFG = dict(SMALL_UNET, image_size=PX, in_channels=3, out_channels=3, dropout=0.0,
           use_scale_shift_norm=True, resblock_updown=True, condition_method="label")
# (GaussianDiffusion kwargs, steps, model calls a sampler call)
CASES = {
    "native": ({"num_timesteps": 6}, None, 6),
    "ddim": ({}, 4, 4),
    "plms": ({}, 4, 5),
    "pndm": ({}, 4, 13),
    "tero": ({}, 4, 8),
    "vdm": ({"beta_schedule": "cosine"}, 4, 4),
    "ddim_continuous": ({"beta_schedule": "cosine"}, 4, 4),
}


@pytest.mark.parametrize("name", SAMPLER_REGISTRY)
def test_generate_takes_every_sampler(name):
    diff_kw, steps, calls = CASES[name]
    from sgdm_tpu_torch.models.factory import create_denoiser, init_random_params

    model = create_denoiser(**CFG)
    init_random_params(model, 0)
    seen = []
    model.register_forward_hook(lambda m, args, out: seen.append(args[1].dtype))
    kw = dict(model=model, diffusion=GaussianDiffusion(**diff_kw), sampler=name, n=2,
              steps=steps, labels=[1, 4], seed=3, device="cpu")
    imgs = generate(CFG, **kw)
    assert imgs.dtype == torch.uint8 and tuple(imgs.shape) == (2, PX, PX, 3)
    assert len(seen) == calls
    # the model's time input: int timesteps; float log-SNR (vdm) and step index (tero)
    assert set(seen) == {torch.float32 if name in ("vdm", "tero") else torch.int32}
    torch.testing.assert_close(generate(CFG, **kw), imgs, rtol=0, atol=0)


@pytest.mark.parametrize("name", ["native", "plms", "tero"])
def test_scoremix_sampler_takes_the_name(name):
    """`make_scoremix_sample_fn` hands its sampler the name: two guided
    forwards a denoiser call (one a condition)."""
    from sgdm_tpu_torch.models.factory import create_denoiser, init_random_params
    from sgdm_tpu_torch.training.state import make_scoremix_sample_fn

    diff_kw, steps, calls = CASES[name]
    model = create_denoiser(**CFG)
    init_random_params(model, 1)
    seen = []
    model.register_forward_hook(lambda *a: seen.append(1))
    ca, cb = torch.eye(10)[[1, 1]], torch.eye(10)[[6, 6]]
    imgs, _ = make_scoremix_sample_fn(model, GaussianDiffusion(**diff_kw), sampling_method=name,
                                      num_steps=steps, device="cpu")(
        model, torch.Generator().manual_seed(0), 2, PX, 3, ca, cb, torch.tensor([0.0, 1.0]))
    assert imgs.dtype == torch.uint8 and tuple(imgs.shape) == (2, PX, PX, 3)
    assert len(seen) == 2 * calls


def test_cli_sampler_choice(tmp_path, capsys):
    argv = ["--device", "cpu", "--image-size", "16", "--model-channels", "32", "--cond-dim",
            "10", "--n", "2", "--steps", "4", "--labels", "2,5"]
    generate_main(argv + ["--sampler", "plms", "--out", str(tmp_path / "out")])
    assert "sampled (2, 16, 16, 3)" in capsys.readouterr().out
    pngs = sorted((tmp_path / "out").glob("*.png"))
    assert [p.name for p in pngs] == ["000000_c2.png", "000001_c5.png"]
    assert all(read_png(p).shape == (16, 16, 3) for p in pngs)
    with pytest.raises(SystemExit):
        generate_main(argv + ["--sampler", "euler"])
    with pytest.raises(ValueError, match="log-SNR"):   # the default diffusion is LDM-linear
        generate_main(argv + ["--sampler", "vdm"])


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory, one_torch_thread):
    """One epoch of 2 steps of the port CLI with an image log under PLMS."""
    log_dir = tmp_path_factory.mktemp("run")
    port_main.main([
        "--device", "cpu", "data=synthetic32", "sg.params.condition_method=label",
        "sg.params.cond_dim=10", "sg.params.cond_drop_prob=0.1", "sg.params.cond_scale=2",
        "+data.params.train.params.cond_key=label", "data.image_size=8",
        "data.params.batch_size=4", "data.params.num_workers=1",
        "dynamic.params.model_channels=16", "dynamic.params.channel_mult=[1,2]",
        "dynamic.params.num_res_blocks=1", "dynamic.params.attention_resolutions=[2]",
        "dynamic.params.num_heads=2", "pl.trainer.limit_train_batches=2",
        "pl.trainer.limit_val_batches=1", "data.vis_every_iter=2",
        "model.params.num_timesteps=10", "model.params.num_timesteps_imagelogger=2",
        "model.params.sampling_imagelogger=plms", "model.params.sampling_test=native",
        "model.params.sampling_val=pndm", "data.trainer.max_epochs=0",
        "log_dir=" + str(log_dir)])
    return log_dir


def test_the_run_samples_its_sampling_keys(run_dir):
    cfg = json.loads((run_dir / "config.json").read_text())
    params = cfg["diffusion_model"]["params"]
    assert (params["sampling_imagelogger"], params["sampling_test"], params["sampling_val"]) \
        == ("plms", "native", "pndm")
    assert sorted((run_dir / "media").glob("*.png"))   # the image log sampled under PLMS
    for sampler, steps in (("native", None), ("plms", 2)):
        imgs = generate_from_run(run_dir, sampler=sampler, device="cpu", n=2, steps=steps,
                                 labels=[0, 9], seed=1)
        assert imgs.dtype == torch.uint8 and tuple(imgs.shape) == (2, 8, 8, 3)
    trainer = load_run(run_dir, device="cpu")
    from sgdm_tpu_torch.training.checkpoints import CheckpointManager
    from sgdm_tpu_torch.training.state import create_train_state

    trainer.state = create_train_state(trainer.model, trainer.tx, device="cpu")
    CheckpointManager(run_dir / "ckpts").restore(trainer.state)
    # sampling_progressive's default is the run's sampling_test (native: 10 calls)
    calls = []
    hook = trainer.model.register_forward_hook(lambda *a: calls.append(1))
    imgs, _ = trainer.sampling_progressive(2, 8, 3, torch.Generator().manual_seed(0),
                                           cond=torch.eye(10)[[1, 2]], num_steps=3)
    assert len(calls) == 10 and tuple(imgs.shape) == (2, 8, 8, 3)
    calls.clear()
    batch = SyntheticImages(size=8, num_classes=10, length=4, seed=0).get_batch(np.arange(2))
    fn = _make_batch_sample_fn(trainer, 2.0, trainer.diff_params["sampling_val"], 4)
    out = fn(batch, 5)
    hook.remove()
    assert out.dtype == np.uint8 and out.shape == (2, 8, 8, 3)
    warmup, main = pndm_time_steps(10, 4)
    assert len(calls) == len(warmup) + len(main) == 14   # 12 warm-up calls, 2 main steps
    np.testing.assert_array_equal(fn(batch, 5), out)

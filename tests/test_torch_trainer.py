"""The port's trainer (`sgdm_tpu_torch/training/trainer.py`) and training
CLI (`sgdm_tpu_torch/main.py`) against the JAX package's, on tiny UNets
and synthetic data, on the CPU.

  * An epoch of the port's trainer equals a loop of the port's
    `make_train_step` over the JAX loader's batches with seed + 1: bit for
    bit (the step itself is held against JAX by test_torch_train_step.py).
  * The port CLI and the JAX CLI (`main.py`) on the same composed config
    (a float `limit_train_batches`, validation every 2nd epoch, the
    ``max_epochs + 1`` quirk), then each resumed from its ``ckpts/last``:
    everything that does not depend on random draws matches exactly — the
    logged steps and keys, ``train/img_million``, the epochs, validation
    count and cadence (forced on resume), the checkpoint meta, the resumed
    run's start epoch and global step.
  * The val losses of the params and the EMA through the trainer equal
    `make_eval_step` on the same draws; after validation and the image
    logger (which bind the model to the EMA) the next step trains
    ``state.params``, bit for bit as a step that never sampled.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from sgdm_tpu.config.engine import compose as jax_compose
from sgdm_tpu_torch import main as port_main
from sgdm_tpu_torch.conditioning.condition import prepare_condition_kwargs
from sgdm_tpu_torch.config.engine import compose, instantiate_from_config
from sgdm_tpu_torch.generate import read_png
from sgdm_tpu_torch.models.factory import create_denoiser, init_train_params
from sgdm_tpu_torch.training.optim import create_optimizer
from sgdm_tpu_torch.training.state import create_train_state, make_eval_step, make_train_step
from sgdm_tpu_torch.training.trainer import SelfGuidedDiffusionTrainer

from torch_port_common import (one_torch_thread, tiny_datamodule_cfg,  # noqa: F401
                               tiny_trainer_hparams)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ROOT = Path(__file__).resolve().parents[1]
CLI = ["data=synthetic32", "sg.params.condition_method=label", "sg.params.cond_dim=4",
       "sg.params.cond_drop_prob=0.1", "sg.params.cond_scale=2", "data.num_classes=4",
       "data.image_size=8", "data.params.batch_size=8", "data.params.num_workers=2",
       "data.params.train.params.length=32", "data.params.validation.params.length=16",
       "dynamic.params.model_channels=16", "dynamic.params.channel_mult=[1]",
       "dynamic.params.num_res_blocks=1", "dynamic.params.attention_resolutions=[]",
       "dynamic.params.num_heads=2", "model.params.num_timesteps=20",
       "pl.trainer.strategy=null", "pl.trainer.limit_train_batches=0.5",
       "pl.trainer.limit_val_batches=1", "pl.trainer.log_every_n_steps=1",
       "data.trainer.check_val_every_n_epoch=2", "data.vis_every_iter=1000000000",
       "sg.params.compute_dtype=float32"]
DEVICE_KEYS = {"peak_hbm_mib", "hbm_in_use_mib"}


def _records(run_dir):
    return [json.loads(line) for line in (Path(run_dir) / "metrics.jsonl").read_text().splitlines()]


def _shape(records):
    """What of a run's records does not depend on random draws."""
    out = []
    for r in records:
        keys = sorted(k for k in r if k != "_time" and k not in DEVICE_KEYS
                      and not k.startswith("loss_vs_t/"))
        out.append((r["_step"], keys, r.get("epoch"), r.get("train/img_million"),
                    any(k.startswith("loss_vs_t/") for k in r)))
    return out


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory, one_torch_thread):
    """The JAX CLI and the port CLI, 2 epochs (max_epochs=1 + 1), then each
    resumed from its ckpts/last to 3 epochs."""
    import main as jax_main
    import sgdm_tpu.eval.harness as harness

    mp = pytest.MonkeyPatch()
    mp.setenv("SGDM_FORCE_CPU", "1")
    mp.setattr(harness, "run_test_and_all_exploration", lambda *a, **k: None)  # FID's slice
    root = tmp_path_factory.mktemp("cli")
    out = {}
    try:
        for name in ("jax", "port"):
            log_dir = root / name
            trainers = []
            for epochs, extra in ((1, []), (2, [f"resume_from={log_dir / 'ckpts' / 'last'}"])):
                ovs = CLI + [f"data.trainer.max_epochs={epochs}", f"log_dir={log_dir}"] + extra
                if name == "jax":
                    trainers.append(jax_main.run_without_decorator(jax_compose(
                        ROOT / "configs", overrides=ovs)))
                else:
                    trainers.append(port_main.run_without_decorator(
                        compose(ROOT / "configs", overrides=ovs), device="cpu"))
                if epochs == 1:
                    out[f"{name}_first"] = _records(log_dir)
                    out[f"{name}_meta_first"] = json.loads(
                        (log_dir / "ckpts" / "meta.json").read_text())
            out[name] = _records(log_dir)
            out[f"{name}_meta"] = json.loads((log_dir / "ckpts" / "meta.json").read_text())
            out[f"{name}_steps"] = [int(t.global_step) for t in trainers]
    finally:
        mp.undo()
    return out


def test_cli_logs_and_cadence_match_jax(cli_runs):
    jax_first, port_first = _shape(cli_runs["jax_first"]), _shape(cli_runs["port_first"])
    assert port_first == jax_first
    # max_epochs=1 trains 2 epochs of int(4 * 0.5) = 2 steps; validation at epoch 1 only
    epochs = [r["epoch"] for r in cli_runs["port_first"] if "epoch_time_sec" in r]
    assert epochs == [0, 1]
    assert [r["_step"] for r in cli_runs["port_first"] if "val/loss" in r] == [4]
    assert _shape(cli_runs["port"]) == _shape(cli_runs["jax"])


def test_cli_resume_arithmetic_matches_jax(cli_runs):
    assert cli_runs["port_steps"] == cli_runs["jax_steps"] == [4, 6]
    resumed = cli_runs["port"][len(cli_runs["port_first"]):]
    assert sorted({r["epoch"] for r in resumed if "epoch" in r}) == [2]
    assert any("val/loss" in r for r in resumed)  # forced on resume, off the 2-epoch cadence
    assert [r["train/img_million"] for r in resumed if "train/img_million" in r] == \
        [5 * 8 / 1e6, 6 * 8 / 1e6]


def test_cli_checkpoint_meta_matches_jax(cli_runs):
    for key in ("meta_first", "meta"):
        p, j = cli_runs[f"port_{key}"], cli_runs[f"jax_{key}"]
        assert (p["last_epoch"], p["best_score"], p["best_path"]) == \
            (j["last_epoch"], j["best_score"], j["best_path"])
        assert Path(p["last_path"]).name == Path(j["last_path"]).name
    assert cli_runs["port_meta"]["last_epoch"] == 2


def test_debug_overrides_match_jax():
    import main as jax_main

    for debug in ("debug=true", "debug=false"):
        ovs = ["data=synthetic32", debug]
        a = port_main.apply_debug_overrides(compose(ROOT / "configs", overrides=ovs))
        b = jax_main.apply_debug_overrides(jax_compose(ROOT / "configs", overrides=ovs))
        assert json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)
        ua = port_main.apply_debug_overrides(compose(ROOT / "configs", overrides=ovs), True)
        ub = jax_main.apply_debug_overrides(jax_compose(ROOT / "configs", overrides=ovs), True)
        assert json.dumps(ua, sort_keys=True) == json.dumps(ub, sort_keys=True)


def _port_trainer(tmp_path, **over):
    return SelfGuidedDiffusionTrainer(device="cpu", **tiny_trainer_hparams(tmp_path / "run", **over))


def test_epoch_equals_train_step_loop_over_the_jax_loader(tmp_path):
    from sgdm_tpu.config.engine import instantiate_from_config as jax_instantiate

    trainer = _port_trainer(tmp_path)
    jdm = jax_instantiate(tiny_datamodule_cfg())
    trainer.fit(jdm, max_epochs=1)
    assert trainer.state.step == 4

    hp = tiny_trainer_hparams(tmp_path)
    model = create_denoiser(**hp["dynamic"]["params"])
    init_train_params(model, hp["seed"])
    tx = create_optimizer("adamw", lr=1e-3, wd=0.01, scheduler=None)
    state = create_train_state(model, tx, device="cpu")
    step = make_train_step(model, trainer.diffusion, tx, cond_drop_prob=0.1, device="cpu")
    dl = jdm.train_dataloader()
    dl.set_epoch(0)
    for raw in dl:
        kw = prepare_condition_kwargs("label", raw, cond_drop_prob=0.1, training=True)
        state, _ = step(state, {"image": raw["image"], "cond": kw["cond"]}, seed=hp["seed"] + 1)
    for a, b in ((trainer.state.params, state.params), (trainer.state.ema_params, state.ema_params),
                 (trainer.state.opt_state.mu, state.opt_state.mu),
                 (trainer.state.opt_state.nu, state.opt_state.nu)):
        assert torch.equal(a, b)


def test_val_losses_equal_the_eval_step_on_the_same_draws(tmp_path):
    trainer = _port_trainer(tmp_path, pl={"trainer": {"strategy": None, "limit_val_batches": 2}})
    dm = instantiate_from_config(tiny_datamodule_cfg())
    trainer.fit(dm, max_epochs=1, limit_train_batches=2)
    rec = [r for r in _records(tmp_path / "run") if "val/loss" in r]
    assert len(rec) == 1 and rec[0]["epoch"] == 0
    ev = make_eval_step(trainer.model, trainer.diffusion, device="cpu")
    st = trainer.state
    losses = {"params": [], "ema": []}
    for raw, _ in zip(dm.val_dataloader(), range(2)):
        kw = prepare_condition_kwargs("label", raw, cond_drop_prob=0.1, training=False)
        batch = {"image": raw["image"], "cond": kw["cond"]}
        # training=False: the condition is always dropped; seed + 2 + epoch
        losses["params"].append(float(ev(st.params, st, batch, seed=trainer.seed + 2)["loss"]))
        losses["ema"].append(float(ev(st.ema_params, st, batch, seed=trainer.seed + 2)["loss"]))
    assert rec[0]["val/loss"] == float(np.mean(losses["params"]))
    assert rec[0]["val/loss_ema"] == float(np.mean(losses["ema"]))
    assert rec[0]["val/loss"] != rec[0]["val/loss_ema"]


def test_next_step_after_sampling_trains_the_params(tmp_path):
    trainer = _port_trainer(tmp_path)
    dm = instantiate_from_config(tiny_datamodule_cfg())
    trainer.fit(dm, max_epochs=1, limit_train_batches=2, vis_every_iter=2)
    images = [r for r in _records(tmp_path / "run") if any(k.startswith("images/") for k in r)]
    # cond_scale 2 and 0, and the same-condition batch (vis.samecondition unset: on)
    assert [k for r in images for k in r if k.startswith("images/")] == \
        ["images/sample_scale2.0", "images/sample_scale0.0", "images/samecondition"]
    for r in images:
        for k, v in r.items():
            if k.startswith("images/"):
                assert read_png(Path(v["path"])).ndim == 3

    raw = next(iter(dm.train_dataloader()))
    trainer._log_images(raw, 0)  # binds the model to the EMA
    ema = trainer.state.ema_params
    p0 = next(trainer.model.parameters())
    assert ema.data_ptr() <= p0.data_ptr() < ema.data_ptr() + ema.numel() * 4
    ref = trainer.state.clone()
    batch = trainer._device_batch(raw)
    state, _ = trainer._train_step(trainer.state, batch, seed=99)
    params = state.params
    assert params.data_ptr() <= next(trainer.model.parameters()).data_ptr() \
        < params.data_ptr() + params.numel() * 4
    model = create_denoiser(**tiny_trainer_hparams(tmp_path)["dynamic"]["params"])
    step = make_train_step(model, trainer.diffusion, trainer.tx, cond_drop_prob=0.1,
                           device="cpu")
    from sgdm_tpu_torch.training.state import bind_params

    bind_params(model, ref.params, ref)
    ref, _ = step(ref, batch, seed=99)
    assert torch.equal(state.params, ref.params) and torch.equal(state.ema_params, ref.ema_params)


def test_cli_restore_only_and_fid_refusal(cli_runs, tmp_path):
    """``train=0 resume_from=…`` restores without training; a configured FID
    directory raises instead of training without best-checkpoint selection."""
    log_dir = Path(cli_runs["port_meta"]["last_path"]).parents[1]
    ovs = CLI + [f"log_dir={log_dir}", "train=false",
                 f"resume_from={log_dir / 'ckpts' / 'last'}"]
    trainer = port_main.run_without_decorator(compose(ROOT / "configs", overrides=ovs),
                                              device="cpu")
    assert trainer.state.step == 6 and trainer.global_step == 0
    with pytest.raises(NotImplementedError, match="item 5"):
        port_main.run_without_decorator(compose(ROOT / "configs", overrides=CLI + [
            f"log_dir={tmp_path}", "data.fid_train_image_dir=/nowhere"]), device="cpu")


def test_injected_fid_keeps_the_best_checkpoint(tmp_path):
    """`set_fid_fn`: FID at epoch 0 (a tenth of the samples), on the
    cadence and never otherwise; the lowest score's state is kept."""
    trainer = _port_trainer(tmp_path)
    scores = iter([5.0, 3.0, 4.0])
    calls = []

    def fid(tr, epoch, fid_num_fraction):
        calls.append((epoch, fid_num_fraction))
        return next(scores)

    trainer.set_fid_fn(fid)
    dm = instantiate_from_config(tiny_datamodule_cfg())
    trainer.fit(dm, max_epochs=4, limit_train_batches=1, fid_every_n_epoch=2)
    assert calls == [(0, 0.1), (1, 1.0), (3, 1.0)]
    meta = trainer.ckpt.meta
    assert meta["best_score"] == 3.0 and meta["best_epoch"] == 1
    assert Path(meta["best_path"]).name == "epoch_000001-fid_3.000"
    fids = [r["val/fid_for_ckpt"] for r in _records(tmp_path / "run") if "val/fid_for_ckpt" in r]
    assert fids == [5.0, 3.0, 4.0]


def test_image_logger_panels_profile_and_sampling_progressive(tmp_path):
    trainer = _port_trainer(tmp_path, vis={"samecondition": False, "interp": True,
                                           "chainvis": True}, profile=True)
    dm = instantiate_from_config(tiny_datamodule_cfg())
    trainer.fit(dm, max_epochs=2, limit_train_batches=4, vis_every_iter=8)
    keys = [k for r in _records(tmp_path / "run") for k in r if k.startswith("images/")]
    assert keys == ["images/sample_scale2.0", "images/sample_scale2.0_chain",
                    "images/sample_scale0.0", "images/sample_scale0.0_chain",
                    "images/cond_interp"]
    assert (tmp_path / "run" / "profile" / "trace.json").exists()  # steps 2-3 of epoch 1
    gen = torch.Generator().manual_seed(0)
    imgs, inter = trainer.sampling_progressive(2, 8, 3, gen, cond=torch.eye(4)[:2],
                                               num_steps=2, use_ema=False)
    assert imgs.shape == (2, 8, 8, 3) and imgs.dtype == torch.uint8
    assert inter["pred_x0"].shape[1:] == (2, 8, 8, 3)

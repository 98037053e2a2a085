"""`python -m sgdm_tpu_torch.main --device cpu … pl.trainer.devices=N`: the
CLI starts N gloo ranks itself and trains one epoch of a tiny model.

Checked from the run dir: one checkpoint (rank 0 writes, ``meta.json``
names it), which restores into a one-rank state bit for bit; the
``_rank0`` / ``_rank1`` sample dirs of the epoch-0 validation FID, 8
images each (16 samples split over the data axis); the logged
``val/clean_fid_raw`` equals the Fréchet distance of one process's
statistics of both dirs' images against the reference dir's, features
taken on one thread as the ranks took them (the ranks' reduced statistics
sum the same float64 terms in another order: within 1e-9 relative; the
reference counted once); one metrics file, written by rank 0.  The 2048-wide `sqrtm` of a Fréchet distance
takes 10-20 s on this kind of host, so the run skips the test phase's FID
(``exp.cond_scale=false``) and the check computes one more.  Then four
ranks under ``fsdp`` and ``tensor_parallel=2`` without FID."""

import json
import os
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
CLI = ["--device", "cpu", "data=synthetic32", "data.num_classes=4", "data.image_size=8",
       "data.params.batch_size=8", "data.params.num_workers=2",
       "data.params.train.params.length=32", "data.params.validation.params.length=16",
       "dynamic.params.model_channels=16", "dynamic.params.channel_mult=[1]",
       "dynamic.params.num_res_blocks=1", "dynamic.params.attention_resolutions=[]",
       "dynamic.params.num_heads=2", "model.params.num_timesteps=20",
       "model.params.num_timesteps_val=2", "pl.trainer.devices=2",
       "pl.trainer.limit_train_batches=2", "pl.trainer.limit_val_batches=1",
       "data.vis_every_iter=1000000000", "sg.params.compute_dtype=float32",
       "data.trainer.max_epochs=0", "data.val_fid_num=16", "exp.cond_scale=false",
       "sg.params.debug=true"]


def _run(args, cwd, timeout):
    """The CLI in a fresh interpreter (its own process group, so a run past
    ``timeout`` is stopped with the ranks it started)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1", OPENBLAS_NUM_THREADS="1")
    proc = subprocess.Popen([sys.executable, "-m", "sgdm_tpu_torch.main", *args], cwd=cwd,
                            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise
    return proc.returncode, err


def test_cli_starts_two_ranks(tmp_path):
    from sgdm_tpu_torch.data.synthetic import SyntheticImages
    from sgdm_tpu_torch.eval import harness
    from sgdm_tpu_torch.eval.fid_engine import InceptionExtractor
    from sgdm_tpu_torch.eval.metrics import FeatureStats, frechet_distance
    from sgdm_tpu_torch.models.factory import create_denoiser
    from sgdm_tpu_torch.training.checkpoints import CheckpointManager, read_state
    from sgdm_tpu_torch.training.optim import create_optimizer
    from sgdm_tpu_torch.training.state import create_train_state

    ref = harness.generate_fid_reference_dir(
        SyntheticImages(size=8, num_classes=4, length=16, seed=5), tmp_path / "ref")
    run = tmp_path / "run"
    rc, err = _run([*CLI, f"data.fid_train_image_dir={ref}", f"log_dir={run}"], tmp_path, 600)
    assert rc == 0, err[-4000:]

    meta = json.loads((run / "ckpts" / "meta.json").read_text())
    assert Path(meta["last_path"]).name == "last-0" and meta["last_epoch"] == 0
    assert Path(meta["best_path"]).is_dir()
    model = create_denoiser(model_channels=16, channel_mult=(1,), num_res_blocks=1,
                            attention_resolutions=(), num_heads=2, cond_dim=0)
    state = CheckpointManager(run / "ckpts").restore(
        create_train_state(model, create_optimizer("adamw"), device="cpu"))
    host = read_state(run / "ckpts" / "last")
    for key, flat in (("params", state.params), ("ema_params", state.ema_params),
                      ("mu", state.opt_state.mu), ("nu", state.opt_state.nu)):
        assert flat.dtype == host[key].dtype and flat.equal(host[key]), key
    assert state.step == 2  # limit_train_batches global steps of one epoch

    dirs = [run / f"val_samples_ep0_rank{r}" for r in (0, 1)]
    assert [sorted(p.name for p in d.glob("*.png")) for d in dirs] == \
        [sorted(f"img{i}.png" for i in range(8))] * 2
    recs = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
    logged = [r["val/clean_fid_raw"] for r in recs if "val/clean_fid_raw" in r]
    assert len(logged) == 1 and any("val/oracle_fid" in r for r in recs)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the ranks' float32 features, bit for bit
    try:
        ex = InceptionExtractor(device="cpu")
        one, real = FeatureStats(), FeatureStats()
        for d in dirs:
            one.append(ex.features_from_dir(d)["pool3"])
        real.append(ex.features_from_dir(ref)["pool3"])
    finally:
        torch.set_num_threads(threads)
    fid = frechet_distance(*one.mean_cov(), *real.mean_cov())
    np.testing.assert_allclose(logged[0], fid, rtol=1e-9)
    assert not (run / "ckpts" / "last-1").exists()


def test_cli_trains_fsdp_and_tp_ranks(tmp_path):
    """Four ranks at fsdp=true and tensor_parallel=2 (a ('data', 'model') =
    (2, 2) mesh; no reference dir, so no FID): the run ends, rank 0 writes
    one checkpoint in the one-device layout, and it restores into a
    one-rank state bit for bit; the logged losses are finite."""
    from sgdm_tpu_torch.models.factory import create_denoiser
    from sgdm_tpu_torch.training.checkpoints import CheckpointManager, read_state
    from sgdm_tpu_torch.training.optim import create_optimizer
    from sgdm_tpu_torch.training.state import create_train_state

    run = tmp_path / "run"
    args = [a for a in CLI if a != "pl.trainer.devices=2"]
    rc, err = _run([*args, "pl.trainer.devices=4", "pl.trainer.fsdp=true",
                    "pl.trainer.tensor_parallel=2", "pl.trainer.log_every_n_steps=1",
                    f"log_dir={run}"], tmp_path, 600)
    assert rc == 0, err[-4000:]
    model = create_denoiser(model_channels=16, channel_mult=(1,), num_res_blocks=1,
                            attention_resolutions=(), num_heads=2, cond_dim=0)
    state = CheckpointManager(run / "ckpts").restore(
        create_train_state(model, create_optimizer("adamw"), device="cpu"))
    host = read_state(run / "ckpts" / "last")
    for key, flat in (("params", state.params), ("ema_params", state.ema_params),
                      ("mu", state.opt_state.mu), ("nu", state.opt_state.nu)):
        assert flat.equal(host[key]), key
    assert state.step == 2 and state.opt_state.mu.abs().max() > 0
    recs = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
    losses = [r["train/loss"] for r in recs if "train/loss" in r]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert all(np.isfinite(r["val/loss"]) for r in recs if "val/loss" in r)

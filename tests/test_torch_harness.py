"""The port's evaluation harness (`sgdm_tpu_torch/eval/harness.py`), its
weights loader and replica, and score mixing, against the JAX package, on
the CPU.

  * `sample_to_dir` with the oracle (``directimage``) writes the pixels the
    JAX engine writes (RGB and grey batches, a short last batch);
  * `load_torch_weights` folds a random ``pt_inception``-named state dict
    as the JAX loader does (bit for bit: both fold in float32 numpy);
  * the port's unfolded replica equals the JAX package's replica, and the
    folded network agrees with it (pool3, logits and the permuted spatial
    within 1e-4); `verify_inception_load` passes, writes its sidecar and
    fails on a tampered one;
  * `make_scoremix_denoiser` and `make_scoremix_sample_fn` against the JAX
    ones on the tiny UNet, from a shared x_T (float32 within 1e-3);
  * the exploration modes of the test phase (oracle, random conditions,
    ablate_scale, condmix, scoremix) name their results as the JAX harness
    does (FID stubbed: the metric math is held by
    test_torch_inception.py), and a vis toggle raises;
  * a CPU run of `python -m sgdm_tpu_torch.main --device cpu` with a
    reference dir logs ``val/oracle_fid`` and ``val/fid_for_ckpt``, keeps a
    ``best`` checkpoint and writes ``test_results.json``.

The 2048-wide `sqrtm` of a Fréchet distance takes 10-20 s on this kind of
host; with BLAS threads on every worker of the suite it takes minutes, so
the tests that run it use one BLAS thread.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as tnn
from PIL import Image

from sgdm_tpu_torch.eval import harness
from sgdm_tpu_torch.eval.fid_engine import sample_to_dir
from sgdm_tpu_torch.eval.inception import build_inception, load_torch_weights
from sgdm_tpu_torch.eval.inception_ref import TFIDInception
from sgdm_tpu_torch.models.convert import from_flax, inception_from_flax

from torch_port_common import SMALL_UNET, perturbed_flat, tiny_datamodule_cfg, unflatten

ROOT = Path(__file__).resolve().parents[1]


def _read_dir(d):
    return {p.name: np.asarray(Image.open(p)) for p in sorted(Path(d).glob("*.png"))}


@pytest.mark.parametrize("channels", [3, 1])
def test_oracle_sample_to_dir_writes_the_jax_pixels(tmp_path, channels):
    from sgdm_tpu.eval import harness as jax_harness
    from sgdm_tpu.eval.fid_engine import sample_to_dir as jax_sample_to_dir

    rng = np.random.default_rng(channels)
    loader = [{"image": rng.uniform(-1.1, 1.1, (4, 8, 8, channels)).astype(np.float32)}
              for _ in range(3)]
    jax_sample_to_dir(jax_harness._make_batch_sample_fn(None, 0.0, "directimage"), loader, 10,
                      tmp_path / "jax", save_gt_dir=tmp_path / "jax_gt")
    sample_to_dir(harness._make_batch_sample_fn(None, 0.0, "directimage"), loader, 10,
                  tmp_path / "port", save_gt_dir=tmp_path / "port_gt")
    for a, b in (("jax", "port"), ("jax_gt", "port_gt")):
        want, got = _read_dir(tmp_path / a), _read_dir(tmp_path / b)
        assert sorted(got) == sorted(want) == sorted(f"img{i}.png" for i in range(10))
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])


def _random_pt_inception(path, seed):
    """A `pt_inception`-named state dict with random weights and BN statistics."""
    tm = TFIDInception().eval()
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in tm.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.05)
        for m in tm.modules():
            if isinstance(m, tnn.BatchNorm2d):
                m.running_mean.copy_(torch.randn(m.running_mean.shape, generator=g) * 0.1)
                m.running_var.copy_(torch.rand(m.running_var.shape, generator=g) + 0.5)
    sd = tm.state_dict()
    sd["AuxLogits.conv0.conv.weight"] = torch.zeros(128, 768, 1, 1)   # skipped by both loaders
    torch.save(sd, path)
    return tm


def test_load_torch_weights_folds_as_jax(tmp_path):
    from sgdm_tpu.eval.inception import load_torch_weights as jax_load

    pth = tmp_path / "pt_inception.pth"
    _random_pt_inception(pth, 7)
    got, want = load_torch_weights(pth), inception_from_flax(jax_load(pth))
    assert got.keys() == want.keys() and not any(k.startswith("AuxLogits") for k in got)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_replica_matches_jax_and_the_folded_network(tmp_path):
    from sgdm_tpu.eval.torch_inception_ref import TFIDInception as JaxReplica

    pth = tmp_path / "pt_inception.pth"
    tm = _random_pt_inception(pth, 9)
    jr = JaxReplica().eval()
    jr.load_state_dict(tm.state_dict())
    x = torch.from_numpy(np.random.default_rng(2).uniform(-1, 1, (2, 3, 139, 139))
                         .astype(np.float32))
    with torch.no_grad():
        ref = tm(x)
        for a, b in zip(ref, jr(x)):
            assert torch.equal(a, b)
        folded = build_inception(load_torch_weights(pth))(x)
    spatial = folded["spatial"].reshape(2, 7, 7, 7).permute(0, 3, 1, 2).reshape(2, -1)
    for got, want in ((folded["pool3"], ref[0]), (folded["logits"], ref[1]), (spatial, ref[2])):
        assert float((got - want).abs().max() / want.abs().max()) <= 1e-4


def test_verify_inception_load(tmp_path):
    from sgdm_tpu_torch.utils.weight_verify import _sidecar, verify_inception_load

    pth = tmp_path / "pt_inception.pth"
    _random_pt_inception(pth, 21)
    state = load_torch_weights(pth)
    assert verify_inception_load(pth, state) is True
    side = _sidecar(pth)
    assert side.exists()
    assert verify_inception_load(pth, state) is True            # against the sidecar
    bad = dict(np.load(side))
    bad["pool3"] = bad["pool3"] + 1.0
    np.savez(side, **bad)
    with pytest.raises(RuntimeError, match="verification FAILED"):
        verify_inception_load(pth, state)


def test_scoremix_denoiser_matches_jax():
    from sgdm_tpu.diffusion.guidance import make_scoremix_denoiser as jax_mix
    from sgdm_tpu_torch.diffusion.guidance import make_scoremix_denoiser

    rng = np.random.default_rng(4)
    w = rng.standard_normal((3, 5)).astype(np.float32)
    x = rng.standard_normal((4, 3)).astype(np.float32)
    conds = [rng.standard_normal((4, 5)).astype(np.float32) for _ in range(2)]
    t = np.arange(4)

    def jax_apply(x, t, cond_drop_mask=None, cond=None):
        keep = 1.0 - cond_drop_mask.astype(jnp.float32)[:, None]
        return x * 0.5 + (cond * keep) @ jnp.asarray(w).T

    def port_apply(x, t, cond_drop_mask=None, cond=None):
        keep = 1.0 - cond_drop_mask.float()[:, None]
        return x * 0.5 + (cond * keep) @ torch.from_numpy(w).T

    for scale in (0.0, 1.0, 2.5):
        want = jax_mix(jax_apply, weights=(0.3, 0.7))(
            jnp.asarray(x), jnp.asarray(t), cond_scale=scale, conds=[jnp.asarray(c) for c in conds])
        got = make_scoremix_denoiser(port_apply, weights=(0.3, 0.7))(
            torch.from_numpy(x), torch.from_numpy(t), cond_scale=scale,
            conds=[torch.from_numpy(c) for c in conds])
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_scoremix_sampler_matches_jax():
    from sgdm_tpu.diffusion.core import GaussianDiffusion as JDiffusion
    from sgdm_tpu.models.unet import UNetModel as JUNetModel
    from sgdm_tpu.training.state import make_scoremix_sample_fn as jax_scoremix
    from sgdm_tpu_torch.diffusion.core import GaussianDiffusion
    from sgdm_tpu_torch.models.factory import create_denoiser
    from sgdm_tpu_torch.training.state import make_scoremix_sample_fn

    b, px, steps = 3, 16, 4
    jm = JUNetModel(use_pallas=False, **SMALL_UNET)
    rng = np.random.default_rng(8)
    x_T = np.repeat(rng.standard_normal((1, px, px, 3)), b, axis=0).astype(np.float32)
    ca = np.eye(10, dtype=np.float32)[[1, 1, 1]]
    cb = np.eye(10, dtype=np.float32)[[6, 6, 6]]
    w = np.linspace(0, 1, b).astype(np.float32)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(x_T),
                            jnp.zeros((b,), jnp.int32), cond=jnp.asarray(ca))["params"]
    flat = perturbed_flat(shapes, seed=3)
    with jax.disable_jit():
        want, _ = jax_scoremix(jm, JDiffusion(), num_steps=steps, cond_scale=2.0,
                               return_uint8=False)(
            unflatten(flat), jax.random.PRNGKey(0), b, px, 3, jnp.asarray(ca), jnp.asarray(cb),
            jnp.asarray(w), x_T=jnp.asarray(x_T))
    tm = create_denoiser(**SMALL_UNET)
    tm.load_state_dict(from_flax(flat, tm))
    got, _ = make_scoremix_sample_fn(tm, GaussianDiffusion(), num_steps=steps, cond_scale=2.0,
                                     return_uint8=False, device="cpu")(
        tm, torch.Generator().manual_seed(0), b, px, 3, ca, cb, w, x_T=torch.from_numpy(x_T))
    want = np.asarray(want)
    assert np.abs(want[0] - want[-1]).max() > 0.05      # the weight moves the sample
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-3)


class _StubTrainer:
    """What the test phase reads of a trainer, around the tiny UNet."""

    def __init__(self, log_dir):
        from sgdm_tpu_torch.diffusion.core import GaussianDiffusion
        from sgdm_tpu_torch.models.factory import create_denoiser

        self.device = torch.device("cpu")
        self.log_dir = log_dir
        self.condition_method, self.condition_cfg = "label", {}
        self.cond_scale, self.cond_drop_prob = 2.0, 0.1
        self.scale_type, self.clip_denoised, self.dtp = "imagen", True, 1.0
        self.diff_params = {"sampling_test": "ddim", "num_timesteps_test": 2}
        self.model = create_denoiser(**dict(SMALL_UNET, cond_dim=4))
        self.diffusion = GaussianDiffusion(num_timesteps=20)
        self.tracker, self.global_step, self.calls = None, 0, []

    def _bound_model(self, use_ema):
        return self.model

    def sampling_progressive(self, b, size, c, generator, cond=None, layout=None,
                             cond_scale=None, sampling_method=None, num_steps=None,
                             image_batch_ids=None):
        self.calls.append((sampling_method, num_steps, cond_scale, tuple(cond.shape)))
        return torch.full((b, size, size, c), 7, dtype=torch.uint8), {}


def test_exploration_modes_name_their_results_as_jax(tmp_path, monkeypatch):
    dirs = []

    def fake_fid(sample_dir, gt_dir, extractor, debug=False):
        dirs.append((Path(sample_dir).name, len(list(Path(sample_dir).glob("img*.png")))))
        return {"clean_fid_raw": 1.0, "sfid": 2.0}, 1.0

    monkeypatch.setattr(harness, "get_fid_dict", fake_fid)
    monkeypatch.setattr(harness, "_extractor", lambda device: None)
    (tmp_path / "ref").mkdir()
    cfg = {"data": dict(tiny_datamodule_cfg(), fid_train_image_dir=str(tmp_path / "ref"),
                        test_fid_num=6),
           "exp": {"cond_scale": True, "test_oracle": True, "randomsample": False,
                   "ablate_scale": True, "ablate_scale_list": [3, 5], "condmix": True,
                   "scoremix": True, "scoremix_c": {"interp": 2, "same_noise": True}},
           "vis": {"grid": True}, "debug": True}
    tr = _StubTrainer(tmp_path)
    results = harness.run_test_and_all_exploration(tr, cfg)
    tags = ["ddim2_s2.0", "ddim2_s0", "oracle", "ablate_s3", "ablate_s5", "condmix", "scoremix"]
    assert [d for d, _ in dirs] == [f"test_{t}_rank0" for t in tags]
    assert [n for _, n in dirs] == [16, 16, 500, 16, 16, 16, 16]   # debug: 16, the oracle 500
    assert sorted(results) == sorted(f"test/{t}/{k}" for t in tags for k in ("clean_fid_raw",
                                                                               "sfid"))
    assert json.loads((tmp_path / "test_results.json").read_text()) == results
    assert (tmp_path / "papervis" / "scoremix.png").exists()
    # two 8-image batches a run: cond_scale 2.0, then 0; the test sampler and its steps
    assert [c[:3] for c in tr.calls[:4]] == [("ddim", 2, 2.0)] * 2 + [("ddim", 2, 0.0)] * 2
    cfg["vis"]["chainvis"] = True
    with pytest.raises(NotImplementedError, match="item 11"):
        harness.run_test_and_all_exploration(tr, cfg)
    del cfg["data"]["fid_train_image_dir"]
    cfg["vis"]["chainvis"] = False
    assert harness.run_test_and_all_exploration(tr, cfg) == {}    # no reference dir: skipped


CLI = ["--device", "cpu", "data=synthetic32", "data.num_classes=4", "data.image_size=8",
       "data.params.batch_size=8", "data.params.num_workers=2",
       "data.params.train.params.length=32", "data.params.validation.params.length=16",
       "dynamic.params.model_channels=16", "dynamic.params.channel_mult=[1]",
       "dynamic.params.num_res_blocks=1", "dynamic.params.attention_resolutions=[]",
       "dynamic.params.num_heads=2", "model.params.num_timesteps=20",
       "model.params.num_timesteps_val=2", "model.params.num_timesteps_test=2",
       "pl.trainer.strategy=null", "pl.trainer.limit_train_batches=2",
       "pl.trainer.limit_val_batches=1", "data.vis_every_iter=1000000000",
       "sg.params.compute_dtype=float32", "data.trainer.max_epochs=0", "data.val_fid_num=16",
       "data.test_fid_num=16", "sg.params.debug=true"]


def test_cli_with_a_reference_dir_scores_checkpoints_and_tests(tmp_path):
    """One epoch of an unconditional model: validation FID at epoch 0 (the
    oracle, then 16 samples; the trainer's debug flag skips fid_tf there),
    the best checkpoint, then the test phase (cond-scale list [0]) with
    every key.  Seven `sqrtm` of 2023- and 2048-wide products on one BLAS
    thread, the suite's workers sharing the cores
    (`test_exploration_modes_name_their_results_as_jax` takes the list
    [2.0, 0])."""
    from sgdm_tpu_torch.data.synthetic import SyntheticImages

    ref = harness.generate_fid_reference_dir(
        SyntheticImages(size=8, num_classes=4, length=16, seed=5), tmp_path / "ref")
    run = tmp_path / "run"
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1", OPENBLAS_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-m", "sgdm_tpu_torch.main", *CLI,
                          f"data.fid_train_image_dir={ref}", f"log_dir={run}"],
                         cwd=tmp_path, env=env, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    recs = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
    keys = {k for r in recs for k in r}
    assert {"val/oracle_fid", "val/fid_for_ckpt", "val/clean_fid_raw", "val/sfid"} <= keys
    assert "val/fid_tf" not in keys
    fid = [r["val/fid_for_ckpt"] for r in recs if "val/fid_for_ckpt" in r]
    meta = json.loads((run / "ckpts" / "meta.json").read_text())
    assert len(fid) == 1 and meta["best_score"] == fid[0] and Path(meta["best_path"]).is_dir()
    assert sorted(p.name for p in (run / "val_samples_ep0_rank0").glob("*.png")) == sorted(
        f"img{i}.png" for i in range(16))
    results = json.loads((run / "test_results.json").read_text())
    assert {k.split("/")[1] for k in results} == {"ddim2_s0"}
    assert {k.split("/")[-1] for k in results} == {
        "clean_fid_raw", "sfid", "fid_tf", "is_tf_s1", "is_std_tf_s1", "is_tf_s10",
        "is_std_tf_s10", "precision", "recall", "density", "coverage"}
    assert all(np.isfinite(v) for v in results.values())

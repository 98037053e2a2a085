"""A JAX training run carried over to the port (`tools/jax_run_to_torch.py`)
and sampled by it (`sgdm_tpu_torch.generate --run`), on the CPU.

A tiny JAX trainer fit (one epoch of 2 steps, f32) writes an orbax
checkpoint; the converter writes the port's run directory; then:

  * the counts (step, optimizer counts, ``ema_updates``) and ``meta.json``
    (``last_epoch``, the slot name) carry over, and every flat buffer equals
    the orbax tree's leaves (params, EMA, μ, ν) exactly;
  * the port model restored through `generate --run`'s loader, EMA bound,
    gives the JAX model's forward on the same EMA weights within 1e-4 of
    max|eps| (the tolerance of tests/test_torch_unet.py);
  * `generate --run --device cpu` writes the PNGs, under DDIM and PLMS.
"""

import importlib.util
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgdm_tpu_torch.generate import _resolve_ckpt, load_run, main as generate_main, read_png
from sgdm_tpu_torch.models.convert import to_flax
from sgdm_tpu_torch.training.checkpoints import CheckpointManager
from sgdm_tpu_torch.training.state import create_train_state

from torch_port_common import (one_torch_thread, tiny_datamodule_cfg,  # noqa: F401
                               tiny_trainer_hparams)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ROOT = Path(__file__).resolve().parents[1]


def _tool():
    spec = importlib.util.spec_from_file_location("jax_run_to_torch",
                                                  ROOT / "tools" / "jax_run_to_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def runs(tmp_path_factory, one_torch_thread):
    from sgdm_tpu.config.engine import instantiate_from_config as jax_instantiate
    from sgdm_tpu.training.trainer import SelfGuidedDiffusionTrainer as JTrainer

    mp = pytest.MonkeyPatch()
    mp.setenv("SGDM_FORCE_CPU", "1")
    root = tmp_path_factory.mktemp("convert")
    try:
        jt = JTrainer(**tiny_trainer_hparams(root / "jax"))
        dm = jax_instantiate(dict(tiny_datamodule_cfg(), params=dict(
            tiny_datamodule_cfg()["params"], validation=None)))
        jt.fit(dm, max_epochs=1, limit_train_batches=2)
    finally:
        mp.undo()
    counts = _tool().convert_run(root / "jax", root / "port")
    return jt, root, counts


def test_counts_and_meta_carry_over(runs):
    jt, root, counts = runs
    assert counts == {"last-0": dict(step=2, count=2, schedule_count=2, ema_updates=2)}
    meta = json.loads((root / "port" / "ckpts" / "meta.json").read_text())
    jmeta = json.loads((root / "jax" / "ckpts" / "meta.json").read_text())
    assert meta["last_epoch"] == jmeta["last_epoch"] == 0
    assert meta["last_path"] == str(root / "port" / "ckpts" / "last-0")
    assert (root / "port" / "ckpts" / "last").resolve() == Path(meta["last_path"])
    cfg = json.loads((root / "port" / "config.json").read_text())
    assert cfg["log_dir"] == str(root / "port") and cfg["cond_scale"] == 2.0

    trainer = load_run(root / "port", device="cpu")
    trainer.state = create_train_state(trainer.model, trainer.tx, device="cpu")
    state = CheckpointManager(root / "port" / "ckpts").restore(
        trainer.state, _resolve_ckpt(root / "port", "last"))
    assert (state.step, state.opt_state.count, state.ema_updates) == (2, 2, 2)
    js = jt.state
    flat = lambda tree: {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
                         for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}
    for buf, tree in ((state.params, js.params), (state.ema_params, js.ema_params),
                      (state.opt_state.mu, js.opt_state[0].mu),
                      (state.opt_state.nu, js.opt_state[0].nu)):
        got = to_flax(state.unflatten(buf), trainer.model)
        ref = flat(tree)
        assert got.keys() == ref.keys()
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_restored_ema_gives_the_jax_forward(runs):
    jt, root, _ = runs
    trainer = load_run(root / "port", device="cpu")
    trainer.state = create_train_state(trainer.model, trainer.tx, device="cpu")
    CheckpointManager(root / "port" / "ckpts").restore(trainer.state)
    model = trainer._bound_model(use_ema=True).eval()
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 8, 8, 3)).astype(np.float32)
    t = np.asarray([0, 5, 11, 19], np.int32)
    cond = np.eye(4, dtype=np.float32)[[0, 1, 2, 3]]
    ref = np.asarray(jt.model.apply({"params": jt.state.ema_params}, jnp.asarray(x),
                                    jnp.asarray(t), cond=jnp.asarray(cond)))
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(t).long(),
                    cond=torch.from_numpy(cond)).numpy()
    assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max()
    assert not np.array_equal(jt.state.ema_params["time_embed_1"]["kernel"],
                              jt.state.params["time_embed_1"]["kernel"])  # the EMA, not the params


def test_generate_run_on_the_converted_run(runs, tmp_path, capsys):
    _, root, _ = runs
    # the run's hparams carry no data section: --run's default size would be
    # 64, as the JAX CLI's is
    generate_main(["--run", str(root / "port"), "--device", "cpu", "--n", "3", "--steps", "4",
                   "--labels", "1,3", "--out", str(tmp_path / "out"), "--image-size", "8"])
    assert "sampled (3, 8, 8, 3)" in capsys.readouterr().out
    pngs = sorted((tmp_path / "out").glob("*.png"))
    assert [p.name for p in pngs] == ["000000_c1.png", "000001_c3.png", "000002_c1.png"]
    assert all(read_png(p).shape == (8, 8, 3) for p in pngs)
    generate_main(["--run", str(root / "port"), "--device", "cpu", "--sampler", "plms",
                   "--n", "2", "--steps", "4", "--out", str(tmp_path / "plms"),
                   "--image-size", "8"])
    assert "sampled (2, 8, 8, 3)" in capsys.readouterr().out
    with pytest.raises(SystemExit):   # not a sampler of the registry
        generate_main(["--run", str(root / "port"), "--device", "cpu", "--sampler", "euler"])

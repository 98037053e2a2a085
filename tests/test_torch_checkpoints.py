"""The port's checkpoint manager (`sgdm_tpu_torch/training/checkpoints.py`)
under the JAX package's policy cases (`tests/test_checkpoints_tracker.py`):
save/restore, best keeps the lowest, a crash mid-save keeps the previous
'last', the stable symlink and `epoch_of`, the save copying the state before
the next in-place step, meta persisting, the legacy real-dir 'last'; and a
trainer that trains 2 steps, saves, is restored into a fresh trainer and
trains 2 more, against 4 steps straight: bit for bit (CPU, f32)."""

import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from sgdm_tpu_torch.config.engine import instantiate_from_config
from sgdm_tpu_torch.training.checkpoints import CheckpointManager
from sgdm_tpu_torch.training.optim import OptState
from sgdm_tpu_torch.training.state import TrainState
from sgdm_tpu_torch.training.trainer import SelfGuidedDiffusionTrainer

from torch_port_common import (one_torch_thread, tiny_datamodule_cfg,  # noqa: F401
                               tiny_trainer_hparams)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def tiny_state(v: float) -> TrainState:
    w = torch.full((4,), v)
    return TrainState(step=int(v), params=w, ema_params=torch.full((4,), v + 0.5),
                      opt_state=OptState(int(v), torch.full((4,), -v), torch.full((4,), v * v),
                                         int(v)),
                      ema_updates=0, layout=(("w", (4,)),))


def w(state: TrainState) -> np.ndarray:
    return state.params.numpy()


class TestCheckpointManager:
    def test_save_last_and_restore(self, tmp_path):
        cm = CheckpointManager(tmp_path / "ck")
        cm.save_last(tiny_state(3.0), epoch=2)
        assert cm.has_checkpoint
        restored = cm.restore(tiny_state(0.0))
        np.testing.assert_array_equal(w(restored), 3.0)
        np.testing.assert_array_equal(restored.ema_params.numpy(), 3.5)
        np.testing.assert_array_equal(restored.opt_state.mu.numpy(), -3.0)
        np.testing.assert_array_equal(restored.opt_state.nu.numpy(), 9.0)
        assert (restored.step, restored.opt_state.count, restored.opt_state.schedule_count) \
            == (3, 3, 3)

    def test_best_policy_keeps_lowest(self, tmp_path):
        cm = CheckpointManager(tmp_path / "ck")
        assert cm.save_best_if_improved(tiny_state(1.0), 0, score=50.0)
        assert cm.save_best_if_improved(tiny_state(2.0), 1, score=30.0)
        assert cm.save_best_if_improved(tiny_state(3.0), 2, score=40.0) is None
        assert cm.meta["best_score"] == 30.0 and cm.meta["best_epoch"] == 1
        best = cm.restore(tiny_state(0.0), cm.meta["best_path"])
        np.testing.assert_array_equal(w(best), 2.0)
        assert Path(cm.meta["best_path"]).name == "epoch_000001-fid_30.000"
        assert not (tmp_path / "ck" / "epoch_000000-fid_50.000").exists()

    def test_crash_during_save_keeps_previous_last(self, tmp_path):
        cm = CheckpointManager(tmp_path / "ck")
        cm.save_last(tiny_state(1.0), epoch=1)
        cm.wait_until_finished()
        first_path = cm.meta["last_path"]
        # the second save is written, but the process dies before its meta
        # is repointed (the finalize at the next drain never runs)
        cm.save_last(tiny_state(2.0), epoch=2)
        cm._wait_writer()
        del cm
        cm2 = CheckpointManager(tmp_path / "ck")
        # a mid-write crash can also leave a tmp dir on the slot the next save reuses
        stale = tmp_path / "ck" / "last-1.tmp"
        stale.mkdir(exist_ok=True)
        (stale / "junk").write_text("x")
        assert cm2.meta["last_path"] == first_path and cm2.meta["last_epoch"] == 1
        assert cm2.has_checkpoint
        np.testing.assert_array_equal(w(cm2.restore(tiny_state(0.0))), 1.0)
        cm2.save_last(tiny_state(3.0), epoch=3)
        cm2.wait_until_finished()
        np.testing.assert_array_equal(w(cm2.restore(tiny_state(0.0))), 3.0)
        assert cm2.meta["last_epoch"] == 3 and not stale.exists()

    def test_stable_last_symlink_and_epoch_of(self, tmp_path):
        cm = CheckpointManager(tmp_path / "ck")
        cm.save_last(tiny_state(5.0), epoch=4)
        cm.wait_until_finished()
        link = tmp_path / "ck" / "last"
        assert link.is_symlink() and link.exists()
        np.testing.assert_array_equal(w(cm.restore(tiny_state(0.0), link)), 5.0)
        assert CheckpointManager.epoch_of(link) == 4
        assert CheckpointManager.epoch_of(cm.meta["last_path"]) == 4
        assert CheckpointManager.epoch_of(tmp_path / "ck" / "epoch_000007-fid_12.500") == 7

    def test_save_copies_before_the_next_in_place_step(self, tmp_path):
        cm = CheckpointManager(tmp_path / "ck")
        s = tiny_state(7.0)
        cm.save_last(s, epoch=1)
        s.params.fill_(-1.0)  # the next train step updates the buffers in place
        cm.wait_until_finished()
        np.testing.assert_array_equal(w(cm.restore(tiny_state(0.0))), 7.0)
        cm.save_last(tiny_state(8.0), epoch=2)
        cm.save_last(tiny_state(9.0), epoch=3)  # back to back: the first is drained
        np.testing.assert_array_equal(w(cm.restore(tiny_state(0.0))), 9.0)
        assert cm.meta["last_epoch"] == 3

    def test_meta_persists(self, tmp_path):
        cm = CheckpointManager(tmp_path / "ck")
        cm.save_best_if_improved(tiny_state(1.0), 0, score=10.0)
        assert CheckpointManager(tmp_path / "ck").meta["best_score"] == 10.0

    def test_legacy_real_dir_last_migrates(self, tmp_path):
        cm = CheckpointManager(tmp_path / "ck")
        cm.save_last(tiny_state(1.0), epoch=0)
        cm.wait_until_finished()
        real, legacy = Path(cm.meta["last_path"]), tmp_path / "ck" / "last"
        legacy.unlink()
        shutil.move(str(real), str(legacy))
        cm.meta["last_path"] = str(legacy)
        cm._flush()
        cm2 = CheckpointManager(tmp_path / "ck")
        cm2.save_last(tiny_state(2.0), epoch=1)
        cm2.wait_until_finished()
        np.testing.assert_array_equal(w(cm2.restore(tiny_state(0.0))), 2.0)
        assert legacy.is_symlink()

    def test_restore_refuses_another_layout(self, tmp_path):
        cm = CheckpointManager(tmp_path / "ck")
        cm.save_last(tiny_state(1.0), epoch=0)
        other = tiny_state(0.0)
        other.layout = (("v", (4,)),)
        with pytest.raises(ValueError, match="layout"):
            cm.restore(other)
        bf16 = tiny_state(0.0)
        bf16.opt_state = OptState(0, bf16.opt_state.mu.bfloat16(), bf16.opt_state.nu, 0)
        with pytest.raises(ValueError, match="mu"):
            cm.restore(bf16)


def _fit(log_dir, epochs, resume_from=None):
    trainer = SelfGuidedDiffusionTrainer(device="cpu", **tiny_trainer_hparams(log_dir))
    dm = instantiate_from_config(tiny_datamodule_cfg())
    trainer.fit(dm, max_epochs=epochs, limit_train_batches=2, resume_from=resume_from)
    return trainer


def test_two_steps_save_restore_two_more_equal_four_straight(tmp_path):
    straight = _fit(tmp_path / "straight", 2)
    first = _fit(tmp_path / "split", 1)
    assert first.state.step == 2
    resumed = _fit(tmp_path / "split", 2, resume_from=str(tmp_path / "split" / "ckpts" / "last"))
    a, b = straight.state, resumed.state
    assert (a.step, a.ema_updates, a.opt_state.count, a.opt_state.schedule_count) \
        == (b.step, b.ema_updates, b.opt_state.count, b.opt_state.schedule_count) == (4, 4, 4, 4)
    for x, y in ((a.params, b.params), (a.ema_params, b.ema_params),
                 (a.opt_state.mu, b.opt_state.mu), (a.opt_state.nu, b.opt_state.nu)):
        assert torch.equal(x, y)
    assert not torch.equal(a.params, first.state.params)  # the last 2 steps moved it
    meta = json.loads((tmp_path / "split" / "ckpts" / "meta.json").read_text())
    assert meta["last_epoch"] == 1 and Path(meta["last_path"]).name == "last-1"

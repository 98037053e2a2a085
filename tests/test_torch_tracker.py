"""The port's tracker (`sgdm_tpu_torch/utils/logging.py`) against the JAX
package's (`sgdm_tpu/utils/logging.py`): the same `log` calls give
``metrics.jsonl`` records that parse identically (``_time`` aside, image
paths compared by file name), the image grids the port writes without PIL
decode with PIL to the JAX tracker's pixels, `make_grid` agrees, and the
config lands in ``config.json``; plus the image-logger helpers
(`utils/batch_ops.py`) against the JAX package's."""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from sgdm_tpu.utils import batch_ops as jops
from sgdm_tpu.utils.logging import Tracker as JTracker
from sgdm_tpu.utils.logging import make_grid as jmake_grid
from sgdm_tpu_torch.utils import batch_ops
from sgdm_tpu_torch.utils.logging import Tracker, make_grid


def _calls():
    rng = np.random.default_rng(0)
    grid = rng.integers(0, 256, (10, 14, 3), dtype=np.uint8)
    batch = rng.uniform(-1, 1, (5, 6, 6, 3)).astype(np.float32)
    grey = rng.integers(0, 256, (7, 9, 1), dtype=np.uint8)
    return [
        ({"train/loss": 0.5, "epoch": 0, "n": np.int64(3)}, 7),
        ({"val/loss": np.float32(0.25), "images/grid": grid}, 8),
        ({"images/batch": batch, "images/grey": grey, "mean_of": np.ones(3)}, None),
    ]


def _records(path):
    out = []
    for line in (path / "metrics.jsonl").read_text().splitlines():
        rec = json.loads(line)
        rec.pop("_time")
        out.append({k: dict(v, path=Path(v["path"]).name) if isinstance(v, dict) else v
                    for k, v in rec.items()})
    return out


def test_records_and_images_match_the_jax_tracker(tmp_path, monkeypatch):
    jt = JTracker(tmp_path / "jax")
    for metrics, step in _calls():
        jt.log(metrics, step=step)
    jt.finish()
    monkeypatch.setitem(sys.modules, "PIL", None)  # the card's machine has no PIL
    tt = Tracker(tmp_path / "port", config={"a": 1, "b": [1, 2]})
    for metrics, step in _calls():
        tt.log({k: torch.tensor(v) if isinstance(v, (np.floating, np.integer)) else v
                for k, v in metrics.items()}, step=step)
    tt.finish()
    monkeypatch.undo()
    assert _records(tmp_path / "port") == _records(tmp_path / "jax")
    images = sorted(p.name for p in (tmp_path / "jax" / "media").glob("*.png"))
    assert images == sorted(p.name for p in (tmp_path / "port" / "media").glob("*.png"))
    assert len(images) == 3
    for name in images:
        ref = np.asarray(Image.open(tmp_path / "jax" / "media" / name))
        got = np.asarray(Image.open(tmp_path / "port" / "media" / name))
        np.testing.assert_array_equal(got, ref, err_msg=name)
    assert json.loads((tmp_path / "port" / "config.json").read_text()) == {"a": 1, "b": [1, 2]}


@pytest.mark.parametrize("b,ncol", [(6, 3), (5, None), (1, None)])
def test_make_grid_matches_jax(b, ncol):
    batch = np.random.default_rng(b).integers(0, 256, (b, 4, 5, 3), dtype=np.uint8)
    np.testing.assert_array_equal(make_grid(batch, ncol=ncol), jmake_grid(batch, ncol=ncol))


def test_batch_ops_match_jax():
    rng = np.random.default_rng(1)
    cond = rng.standard_normal((3, 6))
    for how in ("slerp", "linear"):
        np.testing.assert_array_equal(batch_ops.batch_interp_condition(cond, 4, how),
                                      jops.batch_interp_condition(cond, 4, how))
    batch = {"c": rng.standard_normal((8, 3)), "l": rng.integers(0, 5, (8, 4, 4))}
    got, ref = batch_ops.batch_to_samecondition(batch, 4), jops.batch_to_samecondition(batch, 4)
    for k in batch:
        np.testing.assert_array_equal(got[k], ref[k])
    v = rng.standard_normal(5)
    np.testing.assert_array_equal(batch_ops.slerp(0.3, v, -v), jops.slerp(0.3, v, -v))
    np.testing.assert_array_equal(batch_ops.slerp(0.7, v, 2 * v), jops.slerp(0.7, v, 2 * v))

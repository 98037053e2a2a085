"""`sgdm_tpu_torch/utils/parity_runbook.py` against
`sgdm_tpu/utils/parity_runbook.py` (tests/test_parity_runbook.py's six
checks on the port): every weight-gated stage SKIPs without artifacts; the
cluster stage PASSes and FAILs, its NMI the JAX runbook's on the same
features (JAX reading an h5py file, the port its own writer's); the fid
stage refuses the seeded Inception; the JSON summary; exit code 1; an
exception becomes a FAIL line."""

from __future__ import annotations

import argparse
import json

import h5py
import numpy as np
import pytest

from sgdm_tpu.utils import parity_runbook as jax_rb
from sgdm_tpu_torch.utils import h5
from sgdm_tpu_torch.utils import parity_runbook as rb
from sgdm_tpu_torch.utils.png import write_png

from torch_port_common import one_thread  # noqa: F401

ENVS = ("SGDM_DINO_VITB16", "SGDM_DINO_VITS16", "SGDM_CLIP_WEIGHTS", "SGDM_INCEPTION_WEIGHTS")


def _args(**kw):
    base = dict(stage="all", data_root="~/nonexistent", out_root="~/nonexistent", ds="in32p",
                feat="dino_vitb16", bs=8, image_size=32, k=5000, nmi_floor=0.50, feat_h5=None,
                dino_vitb16=None, dino_vits16=None, clip_weights=None, clip_bpe=None,
                inception_weights=None, fid_dir1=None, fid_dir2=None, device="cpu")
    base.update(kw)
    return argparse.Namespace(**base)


@pytest.fixture
def no_weights(monkeypatch):
    for env in ENVS:
        monkeypatch.delenv(env, raising=False)


def _features(n=300, d=16, k_classes=3):
    """Separable features and labels in the feat-h5 contract."""
    rng = np.random.RandomState(0)
    labels = np.arange(n) % k_classes
    feats = (np.eye(k_classes)[labels] * 8).astype(np.float32)
    feats = np.concatenate([feats, rng.randn(n, d - k_classes).astype(np.float32) * 0.1], 1)
    return feats, labels, d


def _write_feat_h5(path, file=h5.File):
    feats, labels, d = _features()
    with file(path, "w") as f:
        f.create_dataset("train", data=feats)
        f.create_dataset("val", data=feats[:32])
        f.create_dataset("train_labels", data=labels)
        f.create_dataset("val_labels", data=labels[:32])
        ds = f.create_dataset("all_attributes", (1,))
        ds.attrs["dataset_name"] = "synth"
        ds.attrs["feat_from"] = "dino_vitb16"
        ds.attrs["feat_dim"] = d
        ds.attrs["is_grey"] = 0


def test_all_stages_skip_without_artifacts(tmp_path, no_weights):
    a = _args(out_root=str(tmp_path), data_root=str(tmp_path / "none"))
    results = [r for s in rb.STAGES for r in rb.run_stage(s, a)]
    assert [r["stage"] for r in results] == ["weights/dino_vitb16", "weights/dino_vits16",
                                             "weights/clip", "feat", "cluster", "inception",
                                             "fid"]
    assert all(r["status"] == "SKIPPED" for r in results), results
    # each names what it needs
    need = ["$SGDM_DINO_VITB16", "$SGDM_DINO_VITS16", "$SGDM_CLIP_WEIGHTS",
            "dataset not mounted", "--feat-h5", "$SGDM_INCEPTION_WEIGHTS", "--fid-dir1"]
    assert all(n in r["detail"] for n, r in zip(need, results)), results


def test_cluster_stage_pass_and_fail_and_nmi_matches_jax(tmp_path, one_thread):
    _write_feat_h5(tmp_path / "feat.h5")
    _write_feat_h5(tmp_path / "feat_h5py.h5", h5py.File)
    a = _args(out_root=str(tmp_path / "port"), feat_h5=str(tmp_path / "feat.h5"), k=3)
    (res,) = rb.run_stage("cluster", a)
    assert res["status"] == "PASS", res
    assert res["value"] > 0.9
    (jax_res,) = jax_rb.run_stage("cluster", _args(out_root=str(tmp_path / "jax"), k=3,
                                                   feat_h5=str(tmp_path / "feat_h5py.h5")))
    assert jax_res["status"] == "PASS"
    assert abs(res["value"] - jax_res["value"]) <= 1e-6
    # an absurd floor flips the same measurement to FAIL
    (res2,) = rb.run_stage("cluster", _args(out_root=str(tmp_path / "port"), k=3,
                                            feat_h5=str(tmp_path / "feat.h5"), nmi_floor=1.01))
    assert res2["status"] == "FAIL" and res2["value"] == res["value"]


def test_fid_stage_requires_real_inception(tmp_path, no_weights, one_thread):
    """With both dirs present and only the seeded Inception, the fid stage
    refuses to bless anything (SKIPPED, not PASS)."""
    for d in ("a", "b"):
        (tmp_path / d).mkdir()
        for i in range(3):
            write_png(tmp_path / d / f"img{i}.png", np.full((16, 16, 3), 40 * i, np.uint8))
    a = _args(fid_dir1=str(tmp_path / "a"), fid_dir2=str(tmp_path / "b"))
    (res,) = rb.run_stage("fid", a)
    assert res["status"] == "SKIPPED"
    assert "random-fallback" in res["detail"]


def test_main_json_summary(capsys, no_weights):
    summary = rb.main(["--stage", "inception", "--device", "cpu"])
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec == summary
    assert rec["failed"] == 0
    assert rec["parity_runbook"][0]["stage"] == "inception"
    assert rec["parity_runbook"][0]["status"] == "SKIPPED"


def test_main_exit_code_on_fail(tmp_path, one_thread):
    _write_feat_h5(tmp_path / "feat.h5")
    with pytest.raises(SystemExit) as ei:
        rb.main(["--stage", "cluster", "--feat-h5", str(tmp_path / "feat.h5"), "--k", "3",
                 "--nmi-floor", "1.01", "--out-root", str(tmp_path), "--device", "cpu"])
    assert ei.value.code == 1


def test_stage_exception_becomes_fail_line(monkeypatch):
    """A golden mismatch raises (weight_verify's RuntimeError); the runbook
    records it as a FAIL line, and the summary and exit code hold."""
    monkeypatch.setitem(rb.STAGES, "inception",
                        lambda a: (_ for _ in ()).throw(RuntimeError("golden mismatch 0.5 > 1e-3")))
    (res,) = rb.run_stage("inception", _args())
    assert res["status"] == "FAIL"
    assert "golden mismatch" in res["detail"]
    with pytest.raises(SystemExit) as ei:
        rb.main(["--stage", "inception", "--device", "cpu"])
    assert ei.value.code == 1

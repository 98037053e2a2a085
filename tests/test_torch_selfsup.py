"""The port's self-labeling path (`sgdm_tpu_torch/selfsup`) end to end
against the JAX package's on the CPU.

Both packages' `get_ssl_backbone` are monkeypatched to one tiny ViT (patch
8, width 32, depth 2, 48-px input: the 32-px images upsampled and the
position embedding resampled) with the same seeded weights, carried across
by `vit_from_flax` (the JAX package's `.msgpack` loader is not ported).

  * `extract_feat` on `SyntheticImages` (plain CLS, tencrop, spatial +
    attention) by both packages: every dataset within atol 1e-5 (labels
    equal), the attributes and the sibling ``.json`` equal; the JAX
    package's CLIs read the port's feat h5 (h5py, strings and all).
  * `clustering` (with and without ``nns``) and `clustering_withpatches`
    by both packages on the same feat file: assignments, centroids and
    neighbours equal (radii² within 2e-5, centroids within 1e-5), the
    unnormalised ``train_feat``, attrs and ``.json`` equal; the port's
    `ConditionLookup` reads its cluster and patch-cluster files; the port
    clusters a feat file h5py wrote.
  * `lost()` fed the same key features gives the same box, mask and seed;
    `run_lost` + `write_lost_h5` on a written VOC tree give the JAX
    package's names, boxes and cluster ids, pooled features within 1e-5,
    and `LostLookup` reads the port's file back.
  * The three CLIs (`feat_extractor`, `cluster`, `lost`) with the JAX CLIs'
    flags write the JAX CLIs' files.
"""

import importlib
import json
import re
import sys
from pathlib import Path

import h5py
import numpy as np
import pytest

import jax
import jax.numpy as jnp

import chip_smoke
from sgdm_tpu.data.synthetic import SyntheticImages as JaxSynthetic
from sgdm_tpu.data.voc12 import VOCSegmentation as JaxVOC
from sgdm_tpu.models.vit import VisionTransformer as JaxViT
from sgdm_tpu.selfsup import cluster as jax_cluster
from sgdm_tpu.selfsup import cluster_patch as jax_cluster_patch
from sgdm_tpu.selfsup import feat_extractor as jax_fe
from sgdm_tpu.selfsup import ssl_backbone as jax_sb
from sgdm_tpu_torch.data.h5cond import ConditionLookup, LostLookup
from sgdm_tpu_torch.data.synthetic import SyntheticImages
from sgdm_tpu_torch.data.voc12 import VOCSegmentation
from sgdm_tpu_torch.models.convert import vit_from_flax
from sgdm_tpu_torch.models.vit import VisionTransformer
from sgdm_tpu_torch.selfsup import cluster, cluster_patch, feat_extractor
from sgdm_tpu_torch.selfsup import ssl_backbone as sb
from torch_port_common import perturbed_flat, unflatten

# the packages export a function `lost` that hides the module of that name
jax_lost = importlib.import_module("sgdm_tpu.selfsup.lost")
lost = importlib.import_module("sgdm_tpu_torch.selfsup.lost")

TINY = dict(patch_size=8, embed_dim=32, depth=2, num_heads=2, pretrain_img_size=32)
SIZE = 48
ATOL = 1e-5
VARIANTS = {"plain": {}, "tencrop": {"crops": 10},
            "spatial_attn": {"spatial": True, "resampled_size": 4, "attention_map": True}}


@pytest.fixture(scope="module")
def backbones():
    jm = JaxViT(**TINY)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))["params"]
    flat = perturbed_flat(shapes, seed=11)
    tm = VisionTransformer(**TINY)
    tm.load_state_dict(vit_from_flax(flat, tm), strict=True)
    return (jax_sb.SSLBackbone("tiny", jm, unflatten(flat), image_size=SIZE),
            sb.SSLBackbone("tiny", tm, image_size=SIZE, device="cpu"))


@pytest.fixture
def patched(backbones, monkeypatch):
    jb, tb = backbones
    monkeypatch.setattr(jax_fe, "get_ssl_backbone", lambda *a, **k: jb)
    monkeypatch.setattr(jax_sb, "get_ssl_backbone", lambda *a, **k: jb)
    monkeypatch.setattr(feat_extractor, "get_ssl_backbone", lambda *a, **k: tb)
    monkeypatch.setattr(sb, "get_ssl_backbone", lambda *a, **k: tb)
    return backbones


@pytest.fixture(scope="module")
def feat_files(backbones, tmp_path_factory):
    """variant → (JAX feat h5, port feat h5), both from 20 + 6 synthetic images."""
    jb, tb = backbones
    root = tmp_path_factory.mktemp("feat")
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_fe, "get_ssl_backbone", lambda *a, **k: jb)
    mp.setattr(feat_extractor, "get_ssl_backbone", lambda *a, **k: tb)
    out = {}
    try:
        for name, kw in VARIANTS.items():
            pj = jax_fe.extract_feat(JaxSynthetic(size=32, length=20, seed=0),
                                     JaxSynthetic(size=32, length=6, seed=1), "synthetic",
                                     feat_from="tiny", batch_size=8,
                                     out_root=str(root / name / "jax"), **kw)
            pt = feat_extractor.extract_feat(SyntheticImages(size=32, length=20, seed=0),
                                             SyntheticImages(size=32, length=6, seed=1),
                                             "synthetic", feat_from="tiny", batch_size=8,
                                             out_root=str(root / name / "port"), device="cpu",
                                             **kw)
            out[name] = (pj, pt)
    finally:
        mp.undo()
    return out


def _same_h5(a_path, b_path, atol=ATOL, skip=()):
    with h5py.File(a_path, "r") as a, h5py.File(b_path, "r") as b:
        assert sorted(a) == sorted(b)
        for k in a:
            if k in skip:
                continue
            x, y = a[k][()], b[k][()]
            assert x.shape == y.shape and x.dtype == y.dtype, k
            if x.dtype.kind in "iu":
                np.testing.assert_array_equal(y, x, err_msg=k)
            else:
                np.testing.assert_allclose(y, x, atol=atol, rtol=0, err_msg=k)
        assert dict(a["all_attributes"].attrs) == dict(b["all_attributes"].attrs)


def _name(path) -> str:
    """The file name without its hour stamp (two calls may straddle an hour)."""
    return re.sub(r"_\d{4}-\d\d-\d\dT\d\d", "_<hour>", Path(path).name)


def _json(path):
    return json.loads(Path(str(path).replace(".h5", ".json")).read_text())


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_extract_feat_matches_jax(feat_files, variant):
    pj, pt = feat_files[variant]
    assert _name(pt) == _name(pj) and pt.name.startswith("v4_synthetic_tiny")
    _same_h5(pj, pt)
    assert _json(pt) == _json(pj)
    with h5py.File(pt, "r") as f:
        assert f["all_attributes"].attrs["dataset_name"] == "synthetic"
        assert f["train"].shape[0] == 20 and f["val"].shape[0] == 6


@pytest.mark.parametrize("variant,nns", [("plain", 0), ("plain", 3), ("spatial_attn", 0)],
                         ids=["plain", "plain_nns", "attentions"])
def test_clustering_matches_jax(feat_files, tmp_path, variant, nns):
    """Both packages cluster the port's feat file (h5py reads it for JAX);
    a 3-D file is clustered on its mean over axis 1 and its attentions are
    copied through."""
    _, pt = feat_files[variant]
    cj = jax_cluster.clustering(str(pt), nns=nns, cluster_k=4, niter=10,
                                cluster_h5_root=str(tmp_path / "jax"))
    ct = cluster.clustering(str(pt), nns=nns, cluster_k=4, niter=10,
                            cluster_h5_root=str(tmp_path / "port"), device="cpu")
    assert _name(ct) == _name(cj)
    _same_h5(cj, ct, skip=("train_nns_radius", "val_nns_radius"))
    with h5py.File(cj, "r") as a, h5py.File(ct, "r") as b:
        for k in ("train_nns_radius", "val_nns_radius"):
            if k in a:
                np.testing.assert_allclose(b[k][()] ** 2, a[k][()] ** 2, atol=2e-5, rtol=0)
        if nns:
            with h5py.File(pt, "r") as f:    # unnormalised, as extracted
                np.testing.assert_array_equal(b["train_feat"][()], f["train"][()])
    assert _json(ct) == _json(cj)
    with h5py.File(ct, "r") as b:
        assert ("train_attentions" in b) == (variant == "spatial_attn")
    lookup = ConditionLookup("cluster", str(ct), "train", "synthetic",
                             id2name=lambda i: f"{i}.jpg")
    assert lookup.cluster_k == 4 and lookup.get(3)["cluster"].shape == (4,)


def test_port_clusters_a_feat_file_h5py_wrote(feat_files, tmp_path):
    pj, _ = feat_files["tencrop"]
    cj = jax_cluster.clustering(str(pj), cluster_k=3, niter=5, cluster_h5_root=str(tmp_path / "j"))
    ct = cluster.clustering(str(pj), cluster_k=3, niter=5, cluster_h5_root=str(tmp_path / "t"),
                            device="cpu")
    assert "tencrop" not in ct.name and _name(ct) == _name(cj)
    _same_h5(cj, ct)


def test_clustering_withpatches_matches_jax(feat_files, tmp_path):
    _, pt = feat_files["spatial_attn"]
    cj = jax_cluster_patch.clustering_withpatches(str(pt), cluster_k=4, niter=5, minp=1,
                                                  cluster_h5_root=str(tmp_path / "jax"))
    ct = cluster_patch.clustering_withpatches(str(pt), cluster_k=4, niter=5, minp=1,
                                              cluster_h5_root=str(tmp_path / "port"),
                                              device="cpu")
    assert _name(ct) == _name(cj) and "_withpatches_size4" in ct.name
    _same_h5(cj, ct)
    lookup = ConditionLookup("patchcluster", str(ct), "train", "synthetic",
                             id2name=lambda i: f"{i}.jpg")
    assert lookup.get(0)["patchcluster"].shape == (17, 4)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lost_is_the_jax_lost_on_the_same_features(seed):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((196, 24)).astype(np.float32) + 0.3 * (seed - 1)
    args = dict(dims=(14, 14), scales=[16, 16], init_image_size=(224, 224), k_patches=100)
    want = jax_lost.lost(feats, **args)
    got = lost.lost(feats, **args)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    assert got[3] == want[3]


@pytest.fixture(scope="module")
def voc_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("voc")
    chip_smoke.write_voc_tree(root, 10, 2)
    return root


def test_run_lost_on_a_voc_tree_matches_jax(backbones, voc_root, tmp_path, monkeypatch):
    monkeypatch.setattr(lost, "BATCH", 4)       # 10 images: batches of 4, 4 and 2
    jb, tb = backbones
    names_j, boxes_j, pooled_j = jax_lost.run_lost(
        jb, JaxVOC(str(voc_root), image_size=64), image_size=SIZE)
    names_t, boxes_t, pooled_t = lost.run_lost(
        tb, VOCSegmentation(str(voc_root), image_size=64), image_size=SIZE)
    assert names_t == names_j and len(names_t) == 10
    np.testing.assert_array_equal(boxes_t, boxes_j)
    np.testing.assert_allclose(pooled_t, pooled_j, atol=ATOL, rtol=0)
    assert (boxes_t[:, :2] >= 0).all() and (boxes_t[:, 2:] <= 300).all()
    pj = jax_lost.write_lost_h5(tmp_path / "jax.h5", names_j, boxes_j, pooled_j, cluster_k=4)
    pt = lost.write_lost_h5(tmp_path / "port.h5", names_t, boxes_t, pooled_t, cluster_k=4,
                            device="cpu")
    ref, got = LostLookup(str(pj)), LostLookup(str(pt))
    assert got.cluster_k == 4
    for n in names_t:
        np.testing.assert_array_equal(got.get_bbox(n), ref.get_bbox(n))
        assert got.get_clusterid(n) == ref.get_clusterid(n)


def _jax_main(module, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["prog", *argv])
    module.main()


def test_feat_and_cluster_clis_match_jax(patched, tmp_path, monkeypatch):
    flags = ["--ds", "synthetic", "--image_size", "32", "--bs", "64", "--tencrop"]
    _jax_main(jax_fe, flags + ["--out_root", str(tmp_path / "jf")], monkeypatch)
    pt = feat_extractor.main(flags + ["--out_root", str(tmp_path / "tf"), "--device", "cpu"])
    (pj,) = (tmp_path / "jf").glob("*.h5")
    assert _name(pt) == _name(pj)
    _same_h5(pj, pt)
    flags = ["--feat_h5", str(pt), "--k", "5", "--niter", "6", "--nns", "2"]
    _jax_main(jax_cluster, flags + ["--out_root", str(tmp_path / "jc")], monkeypatch)
    ct = cluster.main(flags + ["--out_root", str(tmp_path / "tc"), "--device", "cpu"])
    (cj,) = (tmp_path / "jc").glob("*.h5")
    assert _name(ct) == _name(cj)
    _same_h5(cj, ct, skip=("train_nns_radius", "val_nns_radius"))


def test_lost_cli_matches_jax(backbones, voc_root, tmp_path, monkeypatch):
    """The CLIs run LOST at its default 224-px grid: the tiny weights at 224."""
    jb, tb = backbones
    jb224 = jax_sb.SSLBackbone("tiny", jb.model, jb.params, image_size=224)
    tb224 = sb.SSLBackbone("tiny", tb.model, image_size=224, device="cpu")
    monkeypatch.setattr(jax_sb, "get_ssl_backbone", lambda *a, **k: jb224)
    monkeypatch.setattr(sb, "get_ssl_backbone", lambda *a, **k: tb224)
    flags = ["--ds", "voc64", "--root", str(voc_root), "--cluster_k", "3"]
    _jax_main(jax_lost, flags + ["--out", str(tmp_path / "jax.h5")], monkeypatch)
    pt = lost.main(flags + ["--out", str(tmp_path / "port.h5"), "--device", "cpu"])
    with h5py.File(tmp_path / "jax.h5", "r") as a, h5py.File(pt, "r") as b:
        assert sorted(a) == sorted(b) and len(b) == 20 and b.attrs["cluster_k"] == 3
        for k in a:
            np.testing.assert_array_equal(b[k][()], a[k][()], err_msg=k)

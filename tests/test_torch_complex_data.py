"""The segmentation datasets and `RandomScaleCrop` of the port against the
JAX package's, sample for sample.

A VOC tree, a COCO-Stuff tree and an ImageNet class-folder tree are written
here with PIL: JPEGs of several sizes and samplings (4:2:0, 4:4:4,
progressive, grey, Adobe CMYK, and a PNG named ``.JPEG``), palette and grey
id-mask PNGs with 255 borders, STEGO mask PNGs, a cluster h5 with its
``name2id`` json and a LOST h5 (h5py).  The JAX datasets read them with
PIL; the port's with its own JPEG decoder, PNG reader and resamplers.
``__getitem__`` is called in sequence on both (their crops draw from one
`random.Random(seed)` each), and every key, dtype and value must be equal,
with and without ``onehot_on_device``.
"""

import json
import pickle
import random
from pathlib import Path

import h5py
import numpy as np
import pytest
import torch
from PIL import Image

from sgdm_tpu.data.cocostuff import CocoStuffDataset as JaxCoco
from sgdm_tpu.data.imagenet_folder import ImageNetFolder as JaxFolder
from sgdm_tpu.data.transforms import RandomScaleCrop as JaxCrop
from sgdm_tpu.data.voc12 import VOCSegmentation as JaxVOC
from sgdm_tpu_torch.data import CocoStuffDataset, ImageNetFolder, RandomScaleCrop, VOCSegmentation

K_CLUSTER = 7


def _same(got, want):
    assert list(got) == list(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert np.array_equal(g, w), k


def _image(rng, h, w, grey=False):
    y, x = np.mgrid[0:h, 0:w]
    planes = [127 + 70 * np.sin(x * rng.uniform(0.01, 0.1) + y * rng.uniform(0.01, 0.1) + c)
              + rng.normal(0, 10, (h, w)) for c in range(1 if grey else 3)]
    a = np.clip(np.stack(planes, -1), 0, 255).astype(np.uint8)
    return a[..., 0] if grey else a


def _mask(rng, h, w, classes, palette):
    m = rng.integers(0, classes, (h // 8 + 1, w // 8 + 1)).astype(np.uint8)
    m = np.repeat(np.repeat(m, 8, 0), 8, 1)[:h, :w].copy()
    m[:3], m[:, -2:] = 255, 255                           # ignore-label borders
    im = Image.fromarray(m)
    if palette:
        im = im.convert("P")
        im.putpalette(list(np.random.default_rng(0).integers(0, 256, 768)))
    return im


SIZES = [(375, 500, {}), (500, 375, {"subsampling": 0}), (333, 241, {"progressive": True}),
         (120, 90, {"grey": True}), (480, 640, {"quality": 95})]


def _save_jpeg(path, rng, h, w, opts):
    opts = dict(opts)
    grey = opts.pop("grey", False)
    Image.fromarray(_image(rng, h, w, grey)).save(path, "JPEG", quality=opts.pop("quality", 85),
                                                  **opts)


def _cluster_files(root, names, lost):
    rng = np.random.default_rng(3)
    with h5py.File(root / "cluster.h5", "w") as f:
        for split in ("train", "val"):
            f.create_dataset(split, data=rng.integers(0, K_CLUSTER, len(names)))
        f.create_dataset("all_attributes", (1,)).attrs["cluster_k"] = K_CLUSTER
    (root / "cluster.json").write_text(json.dumps(
        {"name2id": {n: int(j) for n, j in zip(names, rng.permutation(len(names)))}}))
    if lost:
        with h5py.File(root / "lost.h5", "w") as f:
            for n in names:
                x0, y0 = rng.integers(0, 60, 2)
                f.create_dataset(f"{n}_bbox", data=np.array([x0, y0, x0 + rng.integers(20, 200),
                                                             y0 + rng.integers(20, 200)]))
                f.create_dataset(f"{n}_clusterid", data=np.int64(rng.integers(0, K_CLUSTER)))


@pytest.fixture(scope="module")
def voc_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("voc")
    rng = np.random.default_rng(0)
    for d in ("JPEGImages", "SegmentationClassAug", "ImageSets/SegmentationAug",
              "ImageSets/Segmentation", "stego"):
        (root / d).mkdir(parents=True)
    names = [f"2008_{i:06d}" for i in range(len(SIZES))]
    for n, (h, w, opts) in zip(names, SIZES):
        _save_jpeg(root / "JPEGImages" / f"{n}.jpg", rng, h, w, opts)
        _mask(rng, h, w, 21, palette=n.endswith("0")).save(root / "SegmentationClassAug" / f"{n}.png")
        # STEGO masks are written at their own size; the transform resizes them
        Image.fromarray(rng.integers(0, 21, (h // 2, w // 2)).astype(np.uint8)).save(
            root / "stego" / f"{n}.png")
    (root / "ImageSets/SegmentationAug/train_aug.txt").write_text("\n".join(names) + "\n")
    (root / "ImageSets/Segmentation/val.txt").write_text("\n".join(
        f"/JPEGImages/{n}.jpg /SegmentationClassAug/{n}.png" for n in names[::-1]))
    _cluster_files(root, [f"{n}.jpg" for n in names], lost=True)
    return root


VOC_CASES = {
    "oracle": dict(condition_method="layout", condition={"layout": {"how": "oracle"}}),
    "stego": dict(condition_method="stegoclusterlayout", stego_k=21,
                  condition={"stegoclusterlayout": {"how": "stego"}}),
    "lost": dict(condition_method="clusterlayout", condition={"clusterlayout": {"how": "lost"}}),
}


@pytest.mark.parametrize("onehot_on_device", [False, True], ids=["onehot", "ids"])
@pytest.mark.parametrize("split", ["train_aug", "val"])
@pytest.mark.parametrize("case", sorted(VOC_CASES))
def test_voc_matches_jax(voc_root, case, split, onehot_on_device):
    kw = dict(VOC_CASES[case], root=str(voc_root), split=split, seed=5,
              onehot_on_device=onehot_on_device, stego_dir=str(voc_root / "stego"),
              lost_file=str(voc_root / "lost.h5"), h5_file=str(voc_root / "cluster.h5"))
    jax_ds, port_ds = JaxVOC(**kw), VOCSegmentation(**kw)
    assert len(port_ds) == len(jax_ds) == len(SIZES)
    assert port_ds.is_stego == jax_ds.is_stego and (port_ds.lost is None) == (jax_ds.lost is None)
    for i in [*range(len(jax_ds)), 0]:
        _same(port_ds[i], jax_ds[i])


@pytest.fixture(scope="module")
def coco_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("coco")
    rng = np.random.default_rng(1)
    fine_to_coarse = {i: i % 27 for i in range(182)}
    with open(root / "fine_to_coarse_dict.pickle", "wb") as f:
        pickle.dump({"fine_index_to_coarse_index": fine_to_coarse}, f)
    for split, sizes in (("train", SIZES[:3]), ("val", SIZES[3:])):
        for d in ("images", "annotations"):
            (root / d / f"{split}2017").mkdir(parents=True)
        for i, (h, w, opts) in enumerate(sizes):
            stem = f"{split}{i:012d}"
            _save_jpeg(root / "images" / f"{split}2017" / f"{stem}.jpg", rng, h, w, opts)
            _mask(rng, h, w, 182, palette=False).save(root / "annotations" / f"{split}2017" /
                                                      f"{stem}.png")
    (root / "stego").mkdir()
    for p in root.glob("images/*/*.jpg"):
        Image.fromarray(rng.integers(0, 27, (64, 80)).astype(np.uint8)).save(
            root / "stego" / f"{p.stem}.png")
    return root


@pytest.mark.parametrize("onehot_on_device", [False, True], ids=["onehot", "ids"])
@pytest.mark.parametrize("split", ["train", "val"])
def test_cocostuff_matches_jax(coco_root, split, onehot_on_device):
    kw = dict(root=str(coco_root), split=split, seed=9, size4cluster=320, stego_k=27,
              stego_dir=str(coco_root / "stego"), condition_method="stegoclusterlayout",
              condition={"stegoclusterlayout": {"how": "stego"}},
              onehot_on_device=onehot_on_device)
    jax_ds, port_ds = JaxCoco(**kw), CocoStuffDataset(**kw)
    assert [p.name for p in port_ds.images] == [p.name for p in jax_ds.images]
    assert port_ds.fine_to_coarse == jax_ds.fine_to_coarse
    for i in range(len(jax_ds)):
        _same(port_ds[i], jax_ds[i])


def test_cocostuff_raises_as_jax(tmp_path):
    with pytest.raises(FileNotFoundError, match="images not found"):
        CocoStuffDataset(str(tmp_path))
    (tmp_path / "images" / "train2017").mkdir(parents=True)
    with pytest.raises(FileNotFoundError, match="fine_to_coarse_dict.pickle"):
        CocoStuffDataset(str(tmp_path))
    with pytest.raises(FileNotFoundError, match="split list"):
        VOCSegmentation(str(tmp_path))


@pytest.fixture(scope="module")
def folder_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("imagenet")
    rng = np.random.default_rng(2)
    for split in ("train", "val"):
        for c in ("n01440764", "n01443537"):
            d = root / split / c
            d.mkdir(parents=True)
            _save_jpeg(d / "a.JPEG", rng, 300, 451, {})
            _save_jpeg(d / "b.jpg", rng, 257, 190, {"progressive": True})
            _save_jpeg(d / "c.JPEG", rng, 97, 64, {"grey": True})
        Image.fromarray(_image(rng, 120, 160)).save(root / split / "n01440764" / "d.JPEG", "PNG")
        cmyk = Image.fromarray(rng.integers(0, 256, (88, 133, 4)).astype(np.uint8), "CMYK")
        cmyk.save(root / split / "n01443537" / "e.JPEG", "JPEG", quality=90)
    return root


@pytest.mark.parametrize("train", [True, False], ids=["train", "val"])
def test_imagenet_folder_matches_jax(folder_root, train):
    kw = dict(root=str(folder_root), train=train, image_size=64, size4cluster=224,
              condition_method="label", num_classes=2)
    jax_ds, port_ds = JaxFolder(**kw), ImageNetFolder(**kw)
    assert [p.name for p in port_ds.files] == [p.name for p in jax_ds.files]
    assert len(port_ds) == 8
    for i in range(len(jax_ds)):
        _same(port_ds[i], jax_ds[i])


@pytest.mark.parametrize("plain", [False, True], ids=["native", "plain"])
def test_random_scale_crop_matches_jax(plain):
    """The same draws and the same pixels as the JAX transform on PIL
    images, over sizes landscape, portrait and square, with every mask."""
    rng = np.random.default_rng(4)
    jax_t = JaxCrop(224, 64, rng=random.Random(11))
    port_t = RandomScaleCrop(224, 64, rng=random.Random(11))
    for h, w in [(375, 500), (500, 375), (240, 240), (60, 90)]:
        img = _image(rng, h, w)
        masks = [rng.integers(0, 21, (h, w)).astype(np.uint8) for _ in range(3)]
        want = jax_t(Image.fromarray(img), *(Image.fromarray(m) for m in masks))
        got = port_t(img, *masks, plain=plain)
        for g, wnt in zip(got, want):
            assert g.dtype == wnt.dtype and np.array_equal(g, wnt)
        assert port_t.rng.getstate() == jax_t.rng.getstate()
    img = _image(rng, 300, 400)
    want = jax_t(Image.fromarray(img), None)
    got = port_t(img, None)
    assert np.array_equal(got[0], want[0]) and got[1:] == (None, None, None) == want[1:]


def _fit_cli(config, log_dir, *extra):
    """Two train steps of the port's CLI on the CPU at a tiny width."""
    from sgdm_tpu_torch import main as main_mod

    return main_mod.main([
        "--config", str(config), "--device", "cpu", "data.params.batch_size=2",
        "data.params.num_workers=2", "dynamic.params.model_channels=16",
        "dynamic.params.channel_mult=[1,2]", "dynamic.params.num_res_blocks=1",
        "dynamic.params.attention_resolutions=[2]", "dynamic.params.num_heads=2",
        "data.image_size=16", "pl.trainer.limit_train_batches=2", "pl.trainer.limit_val_batches=1",
        "data.vis_every_iter=2", "model.params.num_timesteps_imagelogger=2",
        "data.trainer.max_epochs=0", "data.fid_train_image_dir=null",
        "data.fid_val_image_dir=null", f"log_dir={log_dir}", *extra])


def _records(run_dir):
    recs = [json.loads(line) for line in (run_dir / "metrics.jsonl").read_text().splitlines()]
    losses = [r[k] for r in recs for k in ("train/loss", "val/loss") if k in r]
    assert losses and all(np.isfinite(losses))
    return recs


@pytest.mark.parametrize("run", ["voc64_lost", "coco64_stego"])
def test_fit_on_each_segmentation_config(tmp_path, run):
    """The committed configs through the CLI on a written tree (the chip
    run's writers, at a few names): two finite train steps, validation, an
    image log; the VOC run's batches carry the LOST box masks and the k-wide
    cluster one-hots, the COCO run's the STEGO masks and their n-hots."""
    import chip_smoke
    from sgdm_tpu_torch import generate

    root = tmp_path / "data"
    root.mkdir()
    config = Path(chip_smoke.__file__).resolve().parent / (
        chip_smoke.VOC_CONFIG if run == "voc64_lost" else chip_smoke.COCO_CONFIG)
    if run == "voc64_lost":
        chip_smoke.write_voc_tree(root, 4, 2)
        extra = [f"data.h5_file={root / 'cluster.h5'}", f"data.lost_file={root / 'lost.h5'}"]
    else:
        chip_smoke.write_coco_tree(root, 4, 2)
        extra = [f"data.stego_dir={root / 'stego'}"]
    tr = _fit_cli(config, tmp_path / "run", f"data.root={root}", *extra)
    assert tr.global_step == 2
    batch = next(iter(tr.datamodule.train_dataloader()))
    if run == "voc64_lost":
        assert batch["lostbboxmask"].shape == (2, 16, 16, 1)
        assert batch["cluster"].shape == (2, chip_smoke.VOC_K)
        assert set(np.unique(batch["lostbboxmask"])) <= {0.0, 1.0}
    else:
        assert batch["stegomask"].shape == (2, 16, 16, chip_smoke.COCO_K)
        assert batch["segmask"].shape == (2, 16, 16, 27)
    recs = _records(tmp_path / "run")
    assert any(k.startswith("images/") for r in recs for k in r)
    if run == "voc64_lost":
        generate.main(["--run", str(tmp_path / "run"), "--device", "cpu", "--n", "2", "--steps",
                       "2", "--boxes", "1,1,8,8;4,2,15,12", "--labels", "3,7", "--out",
                       str(tmp_path / "samples")])
        assert len(list((tmp_path / "samples").glob("*.png"))) == 2


def test_coco_config_without_cond_dim_builds_the_jax_cond_width():
    """The README's COCO-Stuff64 command sets no ``cond_dim``: the JAX model
    takes its cond width from the first ``cond`` (flax's lazy Dense), the
    stego n-hot, 27 wide.  The port read ``None`` as 0 and its training
    forward raised on that cond; it now builds the width the config implies,
    with the JAX model's parameter shapes."""
    import jax
    import jax.numpy as jnp

    from sgdm_tpu.models.factory import create_denoiser as jax_create_denoiser
    from sgdm_tpu_torch.config.engine import load_config, to_container
    from sgdm_tpu_torch.models.convert import to_flax
    from sgdm_tpu_torch.models.factory import create_denoiser

    import chip_smoke

    cfg = to_container(load_config(Path(chip_smoke.__file__).resolve().parent
                                   / chip_smoke.COCO_CONFIG, ["data.stego_dir=/srv/stego"]))
    params = dict(cfg["dynamic"]["params"], model_channels=16, channel_mult=[1, 2],
                  num_res_blocks=1, attention_resolutions=[2], num_heads=2)
    assert params["cond_dim"] is None and params["condition_method"] == "stegoclusterlayout"
    port = create_denoiser(**params)
    assert port.cond_dim == chip_smoke.COCO_K
    x, t = np.zeros((2, 16, 16, 3), np.float32), np.array([1, 500], np.int32)
    cond = np.ones((2, chip_smoke.COCO_K), np.float32)
    layout = np.zeros((2, 16, 16, 27), np.float32)
    shapes = jax.eval_shape(jax_create_denoiser(use_pallas=False, **params).init,
                            jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(t),
                            cond=jnp.asarray(cond), layout=jnp.asarray(layout))["params"]
    flat_jax = {"/".join(str(getattr(p, "key", p)) for p in path): v.shape
                for path, v in jax.tree_util.tree_leaves_with_path(shapes)}
    flat_port = {k: tuple(v.shape) for k, v in to_flax(port.state_dict(), port).items()}
    assert flat_port == flat_jax
    out = port(torch.as_tensor(x), torch.as_tensor(t), cond=torch.as_tensor(cond),
               layout=torch.as_tensor(layout))
    assert out.shape == (2, 16, 16, 3) and torch.isfinite(out).all()
    with pytest.raises(ValueError, match="cond_dim"):
        create_denoiser(**dict(params, condition_method="attr"))

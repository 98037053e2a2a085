"""Item 7c of the port against the JAX package and PIL, on the CPU.

  * `data/cityscapes.py` and `data/coco14.py`: trees written here with PIL
    (Cityscapes: RGB PNGs of mixed row filters and labelIds PNGs holding all
    34 raw ids, in two cities; COCO 2014: JPEGs, one grey and one CMYK, with
    polygon, crowd and too-short annotations); ``__getitem__`` in sequence
    on both packages' datasets, every key, dtype and value equal.
  * `native.fill_polygons` against ``ImageDraw.polygon``: float vertices as
    COCO gives them, integer and half-integer vertices, collinear runs,
    horizontal edges, repeated consecutive vertices, polygons that come
    back to a vertex they left (several edges meeting at one point,
    edges run back and forth), polygons out of the image, tiny ones, and
    overlapping ones drawn in order: bit for bit.
  * `data/transforms.py resize` (PIL's box, hamming and lanczos filters,
    and bilinear, bicubic and nearest) against ``Image.resize``: RGB and L,
    down and up, natively and in numpy, bit for bit.
  * `data/imagenet_downsample.py`: the ``resize`` CLI's PNGs pixel for pixel
    and the ``pack`` / ``pack_val`` pickles byte for byte against the JAX
    package's, on a tree of JPEGs (grey and CMYK among them), a PNG and a
    file neither reads.
  * `data/prep.py`: ``cityscapes-resize`` against the JAX package's (pixel
    for pixel, the same file names), its tree pinned (flat
    ``{split}_images`` / ``{split}_labels``, which `CityscapesDataset` does
    not read); ``cocostuff-from-coco17`` and ``ffhq-onelevel`` byte for
    byte.
"""

import json
import pickle
import shutil
from pathlib import Path

import numpy as np
import pytest
from PIL import Image, ImageDraw

from sgdm_tpu.data import imagenet_downsample as jds
from sgdm_tpu.data import prep as jprep
from sgdm_tpu.data.cityscapes import CityscapesDataset as JaxCityscapes
from sgdm_tpu.data.coco14 import Coco14Dataset as JaxCoco14
from sgdm_tpu_torch.data import CityscapesDataset, Coco14Dataset
from sgdm_tpu_torch.data import imagenet_downsample as tds
from sgdm_tpu_torch.data import prep as tprep
from sgdm_tpu_torch.data.transforms import resize
from sgdm_tpu_torch.native import fill_polygons

FIXTURES = Path(__file__).parent / "fixtures" / "jpeg"
PIL_FILTERS = {"nearest": Image.NEAREST, "bilinear": Image.BILINEAR, "bicubic": Image.BICUBIC,
               "box": Image.BOX, "hamming": Image.HAMMING, "lanczos": Image.LANCZOS}


def _same(got, want):
    assert list(got) == list(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert np.array_equal(g, w), k


def _image(rng, h, w):
    y, x = np.mgrid[0:h, 0:w]
    planes = [127 + 70 * np.sin(x * rng.uniform(0.01, 0.1) + y * rng.uniform(0.01, 0.1) + c)
              + rng.normal(0, 10, (h, w)) for c in range(3)]
    return np.clip(np.stack(planes, -1), 0, 255).astype(np.uint8)


# ---------------------------------------------------------------- Cityscapes

@pytest.fixture(scope="module")
def cs_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("cityscapes")
    rng = np.random.default_rng(0)
    for split, n in (("train", 3), ("val", 2)):
        for i in range(n):
            city = ("aachen", "bremen")[i % 2]
            stem = f"{city}_{i:06d}_000019"
            img_dir = root / "leftImg8bit" / split / city
            ann_dir = root / "gtFine" / split / city
            img_dir.mkdir(parents=True, exist_ok=True)
            ann_dir.mkdir(parents=True, exist_ok=True)
            h, w = (128, 256) if i % 2 else (96, 200)
            # PIL's encoder picks the row filters itself (adaptive): a mix
            Image.fromarray(_image(rng, h, w)).save(img_dir / f"{stem}_leftImg8bit.png")
            ids = rng.integers(0, 34, (h // 8 + 1, w // 8 + 1)).astype(np.uint8)
            ids = np.repeat(np.repeat(ids, 8, 0), 8, 1)[:h, :w]
            Image.fromarray(ids).save(ann_dir / f"{stem}_gtFine_labelIds.png")
    return root


@pytest.mark.parametrize("onehot_on_device", [False, True], ids=["onehot", "ids"])
@pytest.mark.parametrize("split", ["train", "val"])
def test_cityscapes_samples_match_jax(cs_root, split, onehot_on_device):
    kw = dict(root=str(cs_root), split=split, image_size=64, condition_method="layout",
              condition={"layout": {"how": "oracle"}})
    jds_ = JaxCityscapes(**kw, onehot_on_device=onehot_on_device)
    tds_ = CityscapesDataset(**kw, onehot_on_device=onehot_on_device)
    assert [p.name for p in tds_.images] == [p.name for p in jds_.images]
    assert [str(p) for p in tds_.masks] == [str(p) for p in jds_.masks]
    for i in range(len(jds_)):
        _same(tds_[i], jds_[i])


# ---------------------------------------------------------------- COCO 2014

def _coco_annotations(rng, images):
    anns, aid = [], 0
    for im in images:
        w, h = im["width"], im["height"]
        for j in range(int(rng.integers(2, 6))):
            c = rng.uniform([0, 0], [w, h])
            k = int(rng.integers(3, 12))
            ang = np.sort(rng.uniform(0, 2 * np.pi, k))
            r = rng.uniform(5, min(w, h) / 2, k)
            poly = np.stack([c[0] + r * np.cos(ang), c[1] + r * np.sin(ang)], 1).reshape(-1)
            seg = [np.round(poly, 2).tolist()]
            if j == 1:
                seg.append([1.0, 2.0, 3.5, 4.0])  # under 6 numbers: skipped
            aid += 1
            anns.append(dict(id=aid, image_id=im["id"], category_id=int(rng.choice([1, 3, 18, 90])),
                             area=float(rng.uniform(10, 5000)), iscrowd=0, segmentation=seg))
        aid += 1
        anns.append(dict(id=aid, image_id=im["id"], category_id=1, area=1e6, iscrowd=1,
                         segmentation={"counts": [0, w * h], "size": [h, w]}))
    return anns


@pytest.fixture(scope="module")
def coco_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("coco14")
    rng = np.random.default_rng(1)
    (root / "annotations").mkdir()
    cats = [{"id": i, "name": f"c{i}"} for i in (90, 1, 3, 18, 44)]
    for split in ("train", "val"):
        (root / f"{split}2014").mkdir()
        images = []
        for i, fx in enumerate(("coco_640x480", "coco_480x640_grey", "cmyk_adobe", "s444_q95")):
            name = f"COCO_{split}2014_{i:012d}.jpg"
            shutil.copyfile(FIXTURES / f"{fx}.jpg", root / f"{split}2014" / name)
            w, h = Image.open(FIXTURES / f"{fx}.jpg").size
            images.append(dict(id=100 + i, file_name=name, width=w, height=h))
        images.append(dict(id=999, file_name="no_annotations.jpg", width=8, height=8))
        data = dict(images=images, categories=cats,
                    annotations=_coco_annotations(rng, images[:-1]))
        (root / "annotations" / f"instances_{split}2014.json").write_text(json.dumps(data))
    return root


@pytest.mark.parametrize("split", ["train", "val"])
def test_coco14_samples_match_jax(coco_root, split):
    kw = dict(root=str(coco_root), split=split, image_size=64, condition_method="layout",
              condition={"layout": {"how": "oracle"}})
    jd, td = JaxCoco14(**kw), Coco14Dataset(**kw)
    assert len(td) == len(jd) == 4 and td.cat_to_idx == jd.cat_to_idx
    for i in range(len(jd)):
        _, jmask = jd._read_img_segmask(i)
        _, tmask = td._read_img_segmask(i)
        assert np.array_equal(tmask, np.asarray(jmask))
        assert tmask.any()  # instances drawn
        _same(td[i], jd[i])


# ---------------------------------------------------------------- polygons

def _polygons(rng, n):
    out = []
    while len(out) < n:
        h, w = (int(v) for v in rng.integers(4, 48, 2))
        k, kind = int(rng.integers(3, 10)), len(out) % 8
        s = max(h, w)
        if kind == 0:    # COCO-like: floats with two decimals
            polys = [np.round(rng.uniform(-3, s + 3, 2 * k), 2)]
        elif kind == 1:  # integers
            polys = [rng.integers(-3, s + 3, 2 * k).astype(float)]
        elif kind == 2:  # half-integers: ties in the crossings
            polys = [rng.integers(-6, 2 * s + 6, 2 * k) / 2.0]
        elif kind == 3:  # axis-aligned runs, collinear points, repeated consecutive vertices
            pts = rng.integers(0, s, (k, 2)).astype(float)
            for i in range(1, k):
                if rng.random() < 0.5:
                    pts[i, rng.integers(2)] = pts[i - 1, rng.integers(2)]
                if rng.random() < 0.2:
                    pts[i] = pts[i - 1]
            polys = [pts.reshape(-1)]
        elif kind == 4:  # tiny
            c = rng.uniform(0, min(h, w), 2)
            polys = [(c + rng.uniform(-1.5, 1.5, (k, 2))).reshape(-1)]
        elif kind == 5:  # far outside on some sides
            polys = [rng.uniform(-2 * s, 3 * s, 2 * k)]
        elif kind == 6:  # back to earlier vertices: edges meeting at a point, run twice
            pts = rng.integers(0, s, (k + 1, 2)).astype(float)
            for i in range(2, k + 1):
                if rng.random() < 0.4:
                    pts[i] = pts[rng.integers(i - 1)]
            polys = [pts.reshape(-1)]
        else:            # overlapping, drawn in order
            polys = [rng.uniform(0, s, 2 * int(rng.integers(3, 8))) for _ in range(3)]
        out.append((h, w, polys))
    return out


def test_polygon_fill_matches_pil():
    rng = np.random.default_rng(0)
    for h, w, polys in _polygons(rng, 1600):
        img = Image.new("L", (w, h), 0)
        draw = ImageDraw.Draw(img)
        for v, p in enumerate(polys, start=1):
            draw.polygon(list(p), fill=v)
        got = fill_polygons(np.zeros((h, w), np.uint8), polys, range(1, len(polys) + 1))
        assert np.array_equal(got, np.asarray(img)), (h, w, [list(p) for p in polys])


def test_polygon_fill_rejects_odd_counts():
    with pytest.raises(ValueError, match="odd"):
        fill_polygons(np.zeros((4, 4), np.uint8), [[0, 0, 3, 0, 3]], [1])


# ---------------------------------------------------------------- filters

@pytest.mark.parametrize("filt", sorted(PIL_FILTERS))
def test_resize_filters_match_pil(filt):
    rng = np.random.default_rng(2)
    for trial in range(16):
        h, w = (int(v) for v in rng.integers(1, 70, 2))
        oh, ow = (int(v) for v in rng.integers(1, 90, 2))
        if trial % 4 == 0:    # downscale by several
            oh, ow = max(1, h // 5), max(1, w // 3)
        img = rng.integers(0, 256, (h, w, 3) if trial % 2 else (h, w), dtype=np.uint8)
        want = np.asarray(Image.fromarray(img).resize((ow, oh), PIL_FILTERS[filt]))
        for plain in ((False, True) if filt != "nearest" else (False,)):
            got = resize(img, oh, ow, filt, plain=plain)
            assert got.shape == want.shape and np.array_equal(got, want), \
                (filt, plain, img.shape, (oh, ow))


# ---------------------------------------------------------------- imagenet_downsample

@pytest.fixture(scope="module")
def in_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("in_tree")
    rng = np.random.default_rng(3)
    fixtures = ["s420_q75", "grey_q75", "cmyk_adobe", "odd_37x23_420", "progressive_420",
                "s422_q50", "restart_420"]
    for c, cls in enumerate(("n01440764", "n01443537", "n01484850")):
        d = root / "train" / cls
        d.mkdir(parents=True)
        for j in range(3):
            fx = fixtures[(3 * c + j) % len(fixtures)]
            shutil.copyfile(FIXTURES / f"{fx}.jpg", d / f"{cls}_{j}.JPEG")
        Image.fromarray(_image(rng, 40 + c, 50)).save(d / f"{cls}_png.JPEG", "PNG")
        (d / f"{cls}_notes.txt").write_text("not an image")
    val = root / "val"
    val.mkdir()
    for j, fx in enumerate(fixtures):
        shutil.copyfile(FIXTURES / f"{fx}.jpg", val / f"ILSVRC2012_val_{j:08d}.JPEG")
    Image.fromarray(_image(rng, 32, 32)).save(val / "ILSVRC2012_val_00000099.png")
    (root / "gt.txt").write_text("\n".join(str(v) for v in [3, 1, 2, 2, 1, 3, 1, 2]) + "\n")
    return root


@pytest.mark.parametrize("alg", ["box", "hamming", "lanczos"])
def test_resize_folder_matches_jax(in_tree, tmp_path, alg):
    src = in_tree / "train" / "n01440764"
    n_j = jds.resize_image_folder(src, tmp_path / "jax", 24, alg)
    tds.main(["resize", "--in_dir", str(src), "--out_dir", str(tmp_path / "port"),
              "--size", "24", "--alg", alg])
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "port").iterdir()) and len(names) == n_j
    for n in names:
        assert np.array_equal(np.asarray(Image.open(tmp_path / "port" / n)),
                              np.asarray(Image.open(tmp_path / "jax" / n))), n


def test_pack_pickles_match_jax(in_tree, tmp_path):
    jds.pack_train_folder(in_tree / "train", tmp_path / "jax", size=16, num_batches=3, seed=5)
    tds.main(["pack", "--in_dir", str(in_tree / "train"), "--out_dir", str(tmp_path / "port"),
              "--size", "16", "--num_batches", "3", "--seed", "5"])
    jds.pack_val_folder(in_tree / "val", tmp_path / "jax", size=16,
                        ground_truth=in_tree / "gt.txt")
    tds.main(["pack_val", "--in_dir", str(in_tree / "val"), "--out_dir", str(tmp_path / "port"),
              "--size", "16", "--ground_truth", str(in_tree / "gt.txt")])
    names = [f"train_data_batch_{i}" for i in (1, 2, 3)] + ["val_data"]
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == sorted(names)
    for n in names:
        assert (tmp_path / "port" / n).read_bytes() == (tmp_path / "jax" / n).read_bytes(), n
    rows = sum(len(pickle.loads((tmp_path / "port" / n).read_bytes())["labels"])
               for n in names[:3])
    assert rows == 12  # 3 classes x (3 JPEGs + 1 PNG); the text files skipped


# ---------------------------------------------------------------- prep

def test_cityscapes_resize_matches_jax_and_pins_its_tree(tmp_path):
    rng = np.random.default_rng(4)
    src = tmp_path / "src"
    for split in ("train_extra", "val"):
        for city, i in (("aachen", 0), ("bonn", 1)):
            stem = f"{city}_{i:06d}_000019"
            d_img, d_lbl = (src / "leftImg8bit" / split / city, src / "gtCoarse" / split / city)
            d_img.mkdir(parents=True)
            d_lbl.mkdir(parents=True)
            Image.fromarray(_image(rng, 60, 90)).save(d_img / f"{stem}_leftImg8bit.png")
            lbl = rng.integers(0, 34, (60, 90)).astype(np.uint8)
            for kind in ("labelIds", "instanceIds", "color"):
                Image.fromarray(lbl).save(d_lbl / f"{stem}_gtCoarse_{kind}.png")
    want = jprep.resize_cityscapes(src, tmp_path / "jax", size=32, workers=2)
    tprep.main(["cityscapes-resize", "--src", str(src), "--dest", str(tmp_path / "port"),
                "--size", "32", "--workers", "2"])
    assert want == {"train_extra": (2, 2), "val": (2, 2)}
    tree = sorted(str(p.relative_to(tmp_path / "port")) for p in (tmp_path / "port").rglob("*"))
    assert tree == sorted(str(p.relative_to(tmp_path / "jax"))
                          for p in (tmp_path / "jax").rglob("*"))
    # the layout the JAX package writes: flat folders, no leftImg8bit/gtFine
    assert tree == ["train_extra_images", "train_extra_images/aachen_000000_000019_leftImg8bit.png",
                    "train_extra_images/bonn_000001_000019_leftImg8bit.png", "train_extra_labels",
                    "train_extra_labels/aachen_000000_000019_gtCoarse_labelIds.png",
                    "train_extra_labels/bonn_000001_000019_gtCoarse_labelIds.png", "val_images",
                    "val_images/aachen_000000_000019_leftImg8bit.png",
                    "val_images/bonn_000001_000019_leftImg8bit.png", "val_labels",
                    "val_labels/aachen_000000_000019_gtCoarse_labelIds.png",
                    "val_labels/bonn_000001_000019_gtCoarse_labelIds.png"]
    for rel in tree:
        if rel.endswith(".png"):
            a, b = Image.open(tmp_path / "port" / rel), Image.open(tmp_path / "jax" / rel)
            assert a.mode == b.mode and np.array_equal(np.asarray(a), np.asarray(b)), rel
    with pytest.raises(FileNotFoundError):
        CityscapesDataset(root=str(tmp_path / "port"), split="val")


def test_cocostuff_and_ffhq_copies_match_jax(tmp_path):
    coco = tmp_path / "coco"
    for split, ids in (("train", ["000000000009", "000000000025"]), ("val", ["000000000139"])):
        (coco / "images" / f"{split}2017").mkdir(parents=True)
        (coco / "curated" / f"{split}2017").mkdir(parents=True)
        for i in ids:
            (coco / "images" / f"{split}2017" / f"{i}.jpg").write_bytes(i.encode() * 3)
        (coco / "curated" / f"{split}2017" / "Coco164kFull_Stuff_Coarse_7.txt").write_text(
            "\n".join(ids) + "\n")
    ffhq = tmp_path / "ffhq"
    for shard in ("00000", "01000"):
        (ffhq / shard).mkdir(parents=True)
        for j in range(2):
            (ffhq / shard / f"{shard[:2]}{j:03d}.png").write_bytes(bytes([j]) * 5)
    for pkg, out in ((jprep, tmp_path / "jax"), (tprep, tmp_path / "port")):
        pkg.main(["cocostuff-from-coco17", "--coco17-images", str(coco / "images"),
                  "--curated", str(coco / "curated"), "--dest", str(out / "cocostuff")])
        pkg.main(["ffhq-onelevel", "--src", str(ffhq), "--dest", str(out / "ffhq")])
    files = lambda d: {str(p.relative_to(d)): p.read_bytes() for p in d.rglob("*") if p.is_file()}
    assert files(tmp_path / "port") == files(tmp_path / "jax")
    assert len(files(tmp_path / "port")) == 7

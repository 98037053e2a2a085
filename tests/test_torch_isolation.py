"""Ground rules of the PyTorch port: `sgdm_tpu_torch` and `chip_smoke.py`
import nothing of JAX, of `sgdm_tpu`, of PIL, of h5py, of sklearn or of
matplotlib (the card's machine has none of the last four), by their source and, for the
trainer CLI, `generate --run` and the self-labeling CLIs, at run time;
entry points (generate, train, make_sample_fn, make_train_step,
create_train_state, the FID extractor, fid_cli, the eval harness, the
self-labeling backbone, k-means, kNN and CLIs, the SSL pre-trainers, the
probes and the ``.msgpack`` backbones) refuse to fall back to the CPU; CPU tensors take the plain paths without counting kernel launches;
the IN64 and VOC64 model literals equal the composed YAML configs."""

import ast
import importlib
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import sgdm_tpu_torch
from sgdm_tpu_torch import ops
from sgdm_tpu_torch.diffusion.core import GaussianDiffusion
from sgdm_tpu_torch.generate import generate
from sgdm_tpu_torch.models.factory import UNET_FAST_IN64, UNETCA_FAST_VOC64, create_denoiser
from sgdm_tpu_torch.training.optim import create_optimizer
from sgdm_tpu_torch.training.state import create_train_state, make_sample_fn, make_train_step

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "flax", "optax", "orbax", "sgdm_tpu", "PIL", "h5py", "sklearn", "msgpack",
             "matplotlib")


def _port_files():
    files = sorted((ROOT / "sgdm_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert all(f.exists() for f in files)
    return files


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_parallel_package_is_scanned():
    """`sgdm_tpu_torch/parallel/` (mesh, launch, FSDP, TP) is held to the rule
    below; its ranks' own `sys.modules` are checked by test_torch_parallel.py,
    test_torch_fsdp.py and test_torch_tp.py."""
    names = {str(p.relative_to(ROOT)) for p in _port_files()}
    assert {f"sgdm_tpu_torch/parallel/{m}.py" for m in ("mesh", "launch", "fsdp", "tp")} <= names


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in FORBIDDEN, f"{path.name} imports {mod}"


_RUNTIME_CHECK = """
import json, sys
from sgdm_tpu_torch import generate, main
log_dir = sys.argv[1]
main.main(["--device", "cpu", "data=synthetic32", "sg.params.condition_method=label",
           "sg.params.cond_dim=10", "sg.params.cond_drop_prob=0.1", "sg.params.cond_scale=2",
           "+data.params.train.params.cond_key=label", "data.image_size=8",
           "data.params.batch_size=8", "data.params.num_workers=2",
           "dynamic.params.model_channels=16", "dynamic.params.channel_mult=[1,2]",
           "dynamic.params.num_res_blocks=1", "dynamic.params.attention_resolutions=[2]",
           "dynamic.params.num_heads=2", "pl.trainer.limit_train_batches=2",
           "pl.trainer.limit_val_batches=1", "data.vis_every_iter=2",
           "model.params.num_timesteps_imagelogger=2", "data.trainer.max_epochs=0",
           "log_dir=" + log_dir])
generate.main(["--run", log_dir, "--device", "cpu", "--n", "2", "--steps", "2"])
bad = sorted(m for m in sys.modules if m.split(".")[0].startswith(("jax", "flax", "optax", "orbax"))
             or m == "sgdm_tpu" or m.startswith("sgdm_tpu."))
print(json.dumps(bad))
"""


def test_trainer_cli_imports_nothing_of_jax_at_run_time(tmp_path):
    """The AST check cannot see an `importlib` target (the config engine
    instantiates `sgdm_tpu.…` targets): one epoch of the CLI and a
    `generate --run` in a fresh interpreter, then its `sys.modules`."""
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")  # a tiny model
    out = subprocess.run([sys.executable, "-c", _RUNTIME_CHECK, str(tmp_path / "run")],
                         cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
    assert (tmp_path / "run" / "ckpts" / "meta.json").exists()


_SEG_READERS_CHECK = """
import json, sys
from pathlib import Path
import chip_smoke
from sgdm_tpu_torch.data import CocoStuffDataset, ImageNetFolder, VOCSegmentation
from sgdm_tpu_torch.utils.image import read_image
root = Path(sys.argv[1])
(root / "voc").mkdir()
(root / "coco").mkdir()
chip_smoke.write_voc_tree(root / "voc", 4, 2)
chip_smoke.write_coco_tree(root / "coco", 2, 2)
voc = VOCSegmentation(str(root / "voc"), condition_method="clusterlayout",
                      condition={"clusterlayout": {"how": "lost"}},
                      h5_file=str(root / "voc" / "cluster.h5"),
                      lost_file=str(root / "voc" / "lost.h5"))
coco = CocoStuffDataset(str(root / "coco"), condition_method="stegoclusterlayout", stego_k=27,
                        stego_dir=str(root / "coco" / "stego"))
keys = [sorted(voc[0]), sorted(coco[1])]
(root / "in" / "train" / "n0").mkdir(parents=True)
(root / "in" / "train" / "n0" / "a.JPEG").write_bytes(chip_smoke.fixture_bytes("cmyk_adobe"))
keys.append(sorted(ImageNetFolder(str(root / "in"), num_classes=1)[0]))
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("PIL", "h5py", "jax", "flax")
             or m == "sgdm_tpu" or m.startswith("sgdm_tpu."))
print(json.dumps([keys, bad]))
"""


def test_segmentation_readers_import_nothing_of_pil_or_h5py_at_run_time(tmp_path):
    """The VOC, COCO-Stuff and ImageNet-folder readers on trees of the
    committed JPEG fixtures (the chip run's writers), in a fresh
    interpreter: JPEGs, PNG masks and the h5 files are read without PIL,
    h5py or anything of JAX."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", _SEG_READERS_CHECK, str(tmp_path)],
                         cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    keys, bad = json.loads(out.stdout.strip().splitlines()[-1])
    assert bad == []
    assert "lostbboxmask" in keys[0] and "cluster" in keys[0] and "stegomask" in keys[1]
    assert {"id", "image", "img4unsup", "label"} <= set(keys[2])


_SLICE16_CHECK = """
import json, sys
from pathlib import Path
import chip_smoke
from sgdm_tpu_torch.data import CityscapesDataset, Coco14Dataset
from sgdm_tpu_torch.data import imagenet_downsample, prep
from sgdm_tpu_torch.models import CrossAttentionLR
from sgdm_tpu_torch.models.spatial_transformer import SpatialTransformer
from sgdm_tpu_torch.training import classifier
root = Path(sys.argv[1])
ckpt = classifier.main(["--device", "cpu", "--data-len", "32", "--batch-size", "8",
                        "--workers", "2", "--out", str(root / "c.msgpack")])
model = classifier.load_checkpoint(classifier.build_model(
    classifier.build_argparser().parse_args([])), ckpt)
chip_smoke.CS_SIZE, chip_smoke.CS_DISTINCT = (64, 128), 2
kw = dict(image_size=16, size4cluster=32, condition_method="layout",
          condition={"layout": {"how": "oracle"}})
(root / "cs").mkdir()
chip_smoke.write_cityscapes_tree(root / "cs", 3, 2)
(root / "coco").mkdir()
chip_smoke.write_coco14_tree(root / "coco", 4, 2)
keys = [sorted(CityscapesDataset(str(root / "cs"), split="val", **kw)[1]),
        sorted(Coco14Dataset(str(root / "coco"), split="train", **kw)[3])]
imagenet_downsample.main(["resize", "--in_dir", str(root / "coco" / "val2014"),
                          "--out_dir", str(root / "small"), "--size", "16", "--alg", "lanczos"])
imagenet_downsample.main(["pack", "--in_dir", str(root / "coco"), "--out_dir",
                          str(root / "pickles"), "--size", "8", "--num_batches", "2"])
imagenet_downsample.main(["pack_val", "--in_dir", str(root / "small"), "--out_dir",
                          str(root / "pickles"), "--size", "8"])
(root / "cs" / "gtCoarse").mkdir()
(root / "cs" / "gtFine" / "val").rename(root / "cs" / "gtCoarse" / "val")
prep.main(["cityscapes-resize", "--src", str(root / "cs"), "--dest", str(root / "cs16"),
           "--size", "16", "--splits", "val", "--workers", "2",
           "--label-pattern", "*_labelIds.png"])
files = sorted(p.name for p in (root / "pickles").iterdir()) + sorted(
    str(p.relative_to(root / "cs16")) for p in (root / "cs16").rglob("*.png"))
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("PIL", "h5py", "jax", "flax", "msgpack")
             or m == "sgdm_tpu" or m.startswith("sgdm_tpu."))
print(json.dumps([keys, files, bad]))
"""


def test_slice16_clis_import_nothing_of_jax_pil_or_msgpack_at_run_time(tmp_path):
    """The classifier CLI (its msgpack checkpoint written and read back),
    the Cityscapes and COCO 2014 readers on the chip run's trees, the
    imagenet_downsample CLIs (resize, pack, pack_val) and prep's
    cityscapes-resize, in a fresh interpreter: nothing of JAX, PIL, h5py or
    msgpack is imported."""
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="2")
    out = subprocess.run([sys.executable, "-c", _SLICE16_CHECK, str(tmp_path)],
                         cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    keys, files, bad = json.loads(out.stdout.strip().splitlines()[-1])
    assert bad == []
    assert all({"segmask", "attr", "image", "img4unsup"} <= set(k) for k in keys)
    assert files == ["train_data_batch_1", "train_data_batch_2", "val_data",
                     "val_images/aachen_000004_000019_leftImg8bit.png",
                     "val_images/cologne_000003_000019_leftImg8bit.png",
                     "val_labels/aachen_000004_000019_gtFine_labelIds.png",
                     "val_labels/cologne_000003_000019_gtFine_labelIds.png"]


_SELFSUP_CHECK = """
import json, sys
from pathlib import Path
import torch
import chip_smoke
from sgdm_tpu_torch.models.vit import VisionTransformer
from sgdm_tpu_torch.selfsup import cluster, feat_extractor, ssl_backbone
from sgdm_tpu_torch.data.h5cond import LostLookup
import importlib
lost = importlib.import_module("sgdm_tpu_torch.selfsup.lost")
root = Path(sys.argv[1])
tiny = VisionTransformer(patch_size=8, embed_dim=32, depth=1, num_heads=2, pretrain_img_size=32)
tiny.load_state_dict(ssl_backbone.random_vit_state(tiny, 1))
bb = lambda size: ssl_backbone.SSLBackbone("tiny", tiny, image_size=size, device="cpu")
feat_extractor.get_ssl_backbone = lambda *a, **k: bb(32)
feat = feat_extractor.main(["--ds", "synthetic", "--image_size", "32", "--bs", "128",
                            "--out_root", str(root / "feat"), "--device", "cpu"])
out = cluster.main(["--feat_h5", str(feat), "--k", "8", "--niter", "4", "--nns", "2",
                    "--out_root", str(root / "cluster"), "--device", "cpu"])
(root / "voc").mkdir()
chip_smoke.write_voc_tree(root / "voc", 4, 1)
ssl_backbone.get_ssl_backbone = lambda *a, **k: bb(224)
lost_h5 = lost.main(["--ds", "voc64", "--root", str(root / "voc"), "--cluster_k", "2",
                     "--out", str(root / "lost.h5"), "--device", "cpu"])
boxes = [LostLookup(str(lost_h5)).get_bbox(f"2012_{i:06d}.jpg").tolist() for i in range(4)]
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("PIL", "h5py", "jax", "flax", "sklearn")
             or m == "sgdm_tpu" or m.startswith("sgdm_tpu."))
print(json.dumps([out.name, boxes, bad]))
"""


def test_selfsup_clis_import_nothing_of_jax_h5py_or_sklearn_at_run_time(tmp_path):
    """The feature extractor, the cluster CLI (with nns and the cluster
    metrics) and the LOST CLI on a written VOC tree, with a tiny seeded ViT
    on the CPU, in a fresh interpreter: nothing of JAX, h5py, PIL or
    sklearn is imported."""
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="2")
    out = subprocess.run([sys.executable, "-c", _SELFSUP_CHECK, str(tmp_path)],
                         cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    name, boxes, bad = json.loads(out.stdout.strip().splitlines()[-1])
    assert bad == []
    assert name.startswith("v4_synthetic_cluster8_iter4minp200_nns2_")
    assert len(boxes) == 4 and all(len(b) == 4 for b in boxes)


_ANNOTATION_CHECK = """
import json, sys
from pathlib import Path
import numpy as np
import torch
import chip_smoke
from sgdm_tpu_torch.models.vit import VisionTransformer
from sgdm_tpu_torch.selfsup import cluster_pca, feat_extractor, ssl_backbone, stego, stego_train
from sgdm_tpu_torch.data.cocostuff import CocoStuffDataset
from sgdm_tpu_torch.utils.png import read_png
root = Path(sys.argv[1])
tiny = lambda p=8: VisionTransformer(patch_size=8, embed_dim=32, depth=1, num_heads=2,
                                     pretrain_img_size=32)
stego.vit_small = tiny
vit = tiny()
vit.load_state_dict(ssl_backbone.random_vit_state(vit, 1))
stego_train.get_ssl_backbone = lambda *a, **k: ssl_backbone.SSLBackbone(
    "tiny", vit, image_size=32, device="cpu")
(root / "coco").mkdir()
chip_smoke.write_coco_tree(root / "coco", 6, 2)
ds = CocoStuffDataset(str(root / "coco"), "train", size4cluster=40)
st = stego_train.train_stego(ds, dim=6, n_classes=4, steps=2, batch_size=2, image_size=32,
                             knn_k=2, log_every=1, device="cpu")
st.save_ckpt(root / "stego.ckpt")
stego.main(["--image_dir", str(root / "coco" / "images" / "val2017"), "--out_dir",
            str(root / "masks"), "--ckpt", str(root / "stego.ckpt"), "--n_classes", "4",
            "--dim", "6", "--device", "cpu"])
masks = sorted(p.name for p in (root / "masks").iterdir())
ids = int(max(read_png(root / "masks" / m, samples=True).max() for m in masks))
feat_extractor.get_ssl_backbone = lambda *a, **k: ssl_backbone.SSLBackbone(
    "tiny", vit, image_size=32, device="cpu")
feat = feat_extractor.main(["--ds", "synthetic", "--image_size", "32", "--bs", "128",
                            "--out_root", str(root / "feat"), "--device", "cpu"])
pca = cluster_pca.clustering_pca(str(feat), cluster_k=4, niter=2, minp=2,
                                 cluster_h5_root=str(root / "pca"), device="cpu")
bb = ssl_backbone.get_ssl_backbone("rn50", image_size=32, device="cpu")
f = bb.batch_encode_feat(bb.transform_batch(np.zeros((1, 32, 32, 3), np.uint8)))
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("PIL", "h5py", "jax", "flax", "sklearn")
             or m == "sgdm_tpu" or m.startswith("sgdm_tpu."))
print(json.dumps([masks, ids, pca.name, list(f.shape), bad]))
"""


def test_self_annotation_imports_nothing_of_jax_pil_h5py_or_sklearn_at_run_time(tmp_path):
    """STEGO training on a written COCO-Stuff tree, the mask CLI on its val
    JPEGs, the PCA clusterer (scipy's SVD in place of sklearn's PCA) and a
    ResNet backbone, on the CPU in a fresh interpreter: nothing of JAX,
    h5py, PIL or sklearn is imported."""
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="2")
    out = subprocess.run([sys.executable, "-c", _ANNOTATION_CHECK, str(tmp_path)],
                         cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    masks, ids, pca, feat_shape, bad = json.loads(out.stdout.strip().splitlines()[-1])
    assert bad == []
    assert masks == ["000000000006.png", "000000000007.png"] and 0 <= ids < 4
    assert pca.startswith("v4_synthetic_cluster4_iter2minp2_nns0_") and "pcagroup4separate" in pca
    assert feat_shape == [1, 2048]


def test_selfsup_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    from sgdm_tpu_torch.ops import kmeans, knn
    from sgdm_tpu_torch.selfsup import cluster, feat_extractor, ssl_backbone

    _no_cuda(monkeypatch)
    x = np.zeros((8, 4), np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        ssl_backbone.get_ssl_backbone("dino_vits16")
    with pytest.raises(RuntimeError, match="CUDA"):
        kmeans.run_kmeans(x.copy(), x, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        kmeans.kmeans_assign(x, x[:2])
    with pytest.raises(RuntimeError, match="CUDA"):
        knn.knn_search(x, x, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        feat_extractor.main(["--ds", "synthetic", "--out_root", str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA"):
        cluster.main(["--feat_h5", str(tmp_path / "missing.h5")])
    lost = importlib.import_module("sgdm_tpu_torch.selfsup.lost")
    with pytest.raises(RuntimeError, match="CUDA"):
        lost.main(["--ds", "synthetic"])


@pytest.mark.parametrize("entry", ["cli", "train_step", "eval_step", "state"])
def test_classifier_entry_points_raise_without_cuda(monkeypatch, tmp_path, entry):
    from sgdm_tpu_torch.diffusion.schedule import DiffusionSchedule
    from sgdm_tpu_torch.training import classifier
    from sgdm_tpu_torch.training.optim import create_optimizer

    _no_cuda(monkeypatch)
    args = classifier.build_argparser().parse_args(["--out", str(tmp_path / "c.msgpack")])
    model, sched = classifier.build_model(args), DiffusionSchedule.create(num_timesteps=10)
    tx = create_optimizer("adamw", scheduler=None)
    with pytest.raises(RuntimeError, match="CUDA"):
        if entry == "cli":
            classifier.main(["--out", str(tmp_path / "c.msgpack")])
        elif entry == "train_step":
            classifier.make_classifier_train_step(model, sched, tx)
        elif entry == "eval_step":
            classifier.make_classifier_eval_step(model, sched)
        else:
            classifier.create_classifier_state(model, tx)
    assert not (tmp_path / "c.msgpack").exists()


@pytest.mark.parametrize("entry", ["stego", "stego_cli", "train_stego", "clustering_pca",
                                   "clustering_ensemble", "rn50", "dino_xcit_m24_p8"])
def test_self_annotation_entry_points_raise_without_cuda(monkeypatch, tmp_path, entry):
    from sgdm_tpu_torch.selfsup import cluster_pca, ssl_backbone, stego, stego_train

    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="CUDA"):
        if entry == "stego":
            stego.StegoInference()
        elif entry == "stego_cli":
            stego.main(["--image_dir", str(tmp_path), "--out_dir", str(tmp_path / "m")])
        elif entry == "train_stego":
            stego_train.train_stego([{"img4unsup": np.zeros((8, 8, 3), np.uint8)}])
        elif entry.startswith("clustering"):
            getattr(cluster_pca, entry)(str(tmp_path / "missing.h5"))
        else:
            ssl_backbone.get_ssl_backbone(entry)


@pytest.mark.parametrize("entry", ["get_vdiff_model", "load_vdiff_torch_checkpoint",
                                   "vdiff_cli", "clip_build"])
def test_vdiff_entry_points_raise_without_cuda(monkeypatch, tmp_path, entry):
    from sgdm_tpu_torch.diffusion import vdiff_cli
    from sgdm_tpu_torch.models import clip, zoo_vdiff

    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="CUDA"):
        if entry == "get_vdiff_model":
            zoo_vdiff.get_vdiff_model("cc12m_1_cfg")
        elif entry == "load_vdiff_torch_checkpoint":
            zoo_vdiff.load_vdiff_torch_checkpoint("cc12m_1_cfg", str(tmp_path / "missing.pth"))
        elif entry == "vdiff_cli":
            vdiff_cli.main(["cfg-sample", "--checkpoint", "random:0", "--embed",
                            str(tmp_path / "missing.npy"), "-n", "1", "--steps", "1"])
        else:
            clip.build("ViT-B/16")
    assert next(zoo_vdiff.get_vdiff_model("cc12m_1_cfg", "meta")[0].parameters()).is_meta


_SSL_PRETRAIN_CHECK = """
import json, sys
from pathlib import Path
import numpy as np
from sgdm_tpu_torch.selfsup import eval_probes, mae_finetune, mae_train, msn_train, ssl_backbone
root = Path(sys.argv[1])
small = ["--device", "cpu", "--data-len", "8", "--batch-size", "8", "--workers", "2"]
mae = mae_train.main(small + ["--out", str(root / "mae.msgpack")])
msn = msn_train.main(small + ["--out", str(root / "msn.msgpack")])
ft = mae_finetune.main(["--device", "cpu", "--finetune", str(mae), "--n_train", "8", "--n_val", "8",
                        "--batch_size", "8", "--epochs", "1", "--embed_dim", "64", "--depth", "2",
                        "--num_heads", "2", "--mixup", "0.8", "--cutmix", "1.0", "--workers", "2",
                        "--output_dir", str(root / "ft")])
bb = ssl_backbone.get_ssl_backbone("mae_vitb16", image_size=32, ckpt_path=str(msn), device="cpu")
f = bb.batch_encode_feat(bb.transform_batch(np.zeros((16, 32, 32, 3), np.uint8)))
y = np.arange(16) % 2
scores = [eval_probes.logistic_eval(f, y, f, y, max_epochs=3, device="cpu"),
          eval_probes.linear_probe(f, y, f, y, epochs=1, batch_size=8, device="cpu")]
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("PIL", "jax", "flax", "optax", "msgpack")
             or m == "sgdm_tpu" or m.startswith("sgdm_tpu."))
print(json.dumps([ft.name, list(f.shape), sorted(scores[0]), bad]))
"""


def test_ssl_pretrain_clis_import_nothing_of_jax_pil_or_msgpack_at_run_time(tmp_path):
    """The MAE and MSN pre-training CLIs, the MAE fine-tuning CLI from the MAE
    export (RandAugment on: PIL's ops in numpy), a ``.msgpack`` backbone and
    both probes, on the CPU in a fresh interpreter: nothing of JAX, optax,
    PIL or msgpack is imported."""
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="2")
    out = subprocess.run([sys.executable, "-c", _SSL_PRETRAIN_CHECK, str(tmp_path)],
                         cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    name, shape, keys, bad = json.loads(out.stdout.strip().splitlines()[-1])
    assert bad == []
    assert name == "finetuned.msgpack" and shape == [16, 64]
    assert keys == ["test_score", "train_score"]


@pytest.mark.parametrize("entry", ["mae_train", "msn_train", "mae_finetune", "msgpack_backbone",
                                   "logistic_eval", "linear_probe"])
def test_ssl_pretrain_entry_points_raise_without_cuda(monkeypatch, tmp_path, entry):
    from sgdm_tpu_torch.selfsup import eval_probes, mae_finetune, mae_train, msn_train, ssl_backbone

    _no_cuda(monkeypatch)
    x, y = np.zeros((8, 4), np.float32), np.arange(8) % 2
    with pytest.raises(RuntimeError, match="CUDA"):
        if entry in ("mae_train", "msn_train"):
            {"mae_train": mae_train, "msn_train": msn_train}[entry].main(
                ["--out", str(tmp_path / "e.msgpack")])
        elif entry == "mae_finetune":
            mae_finetune.main(["--output_dir", str(tmp_path / "ft")])
        elif entry == "msgpack_backbone":
            ssl_backbone.get_ssl_backbone("mae_vitb16", ckpt_path=str(tmp_path / "e.msgpack"))
        else:
            getattr(eval_probes, entry)(x, y, x, y)
    assert not (tmp_path / "e.msgpack").exists() and not (tmp_path / "ft").exists()


SLICE20_MODULES = ("eval/seg_metrics", "eval/papervis", "eval/knn_eval", "eval/tsne",
                   "conditioning/validate", "conditioning/clustering_vis", "data/wrn_validate",
                   "models/vq", "models/codec", "models/zoo_imagen")


def test_slice20_modules_are_scanned():
    """The ten modules of the figures, the validator and the zoo are held to
    the import rule above (no JAX, `sgdm_tpu`, PIL, matplotlib, sklearn)."""
    names = {str(p.relative_to(ROOT)) for p in _port_files()}
    assert {f"sgdm_tpu_torch/{m}.py" for m in SLICE20_MODULES} <= names


_SLICE20_CHECK = """
import json, pickle, sys
from pathlib import Path
import numpy as np
import torch
from sgdm_tpu_torch.conditioning import clustering_vis, validate
from sgdm_tpu_torch.data import wrn_validate
from sgdm_tpu_torch.eval import papervis, seg_metrics, tsne
from sgdm_tpu_torch.models import codec, vq, zoo_imagen
root = Path(sys.argv[1])
rng = np.random.default_rng(0)
imgs = rng.integers(0, 256, (4, 8, 8, 3), dtype=np.uint8)
papervis.draw_grid_random_stego_with_mask(imgs, rng.integers(0, 5, (4, 8, 8)), imgs,
                                          root / "s.png", up_size=16)
papervis.cluster_hist_vis_fn(rng.integers(0, 50, 200), root / "h.png")
x = rng.normal(size=(40, 6)).astype(np.float32)
xy, _ = tsne.tsne_embed(x, 5.0, n_iter=20, device="cpu")
png = tsne.scatter_image(xy, np.arange(40) % 2)
seg = seg_metrics.unsupervised_seg_metrics(rng.integers(0, 3, 64), rng.integers(0, 3, 64), 3, 3)
validate.assert_check({"condition_method": None})
q = vq.VectorQuantize(8, 16)(torch.randn(2, 4, 8), train=True)
z = codec.Encoder(ch=8, ch_mult=(1, 2), num_res_blocks=1, resolution=8)(torch.randn(1, 8, 8, 3))
u = zoo_imagen.ImagenUNet(dim=8, dim_mults=(1, 2), text_embed_dim=4, max_text_len=2,
                          attn_dim_head=4, attn_heads=2, resnet_groups=4,
                          layer_attns=(False, True), layer_cross_attns=(False, True))
e = u(torch.randn(1, 8, 8, 3), torch.ones(1), cond=torch.randn(1, 2, 4))
d = root / "wrn"
d.mkdir()
for i in range(1, 3):
    data = {"data": rng.integers(0, 256, (4, 3 * 64), dtype=np.uint8), "labels": [1, 2, 1, 2],
            "mean": rng.uniform(0, 255, 3 * 64)}
    pickle.dump(data, open(d / f"train_data_batch_{i}", "wb"))
pickle.dump({"data": rng.integers(0, 256, (4, 3 * 64), dtype=np.uint8), "labels": [1, 2, 1, 2]},
            open(d / "val_data", "wb"))
out = wrn_validate.main(["-df", str(d), "-s", "8", "-n", "1", "-e", "1", "--batch-size", "4",
                         "--nout", "2", "--num-train-batches", "2", "--ckpt", str(root / "w.p"),
                         "--device", "cpu"])
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("PIL", "jax", "flax", "matplotlib",
                                                           "sklearn")
             or m == "sgdm_tpu" or m.startswith("sgdm_tpu."))
print(json.dumps([list(z.shape), list(e.shape), sorted(seg), (root / "w.p").exists(), bad]))
"""


def test_slice20_modules_import_nothing_of_jax_pil_matplotlib_or_sklearn_at_run_time(tmp_path):
    """The figures, t-SNE, the segmentation metrics, the config checks, the
    zoo and the WRN validator's CLI on the CPU in a fresh interpreter:
    nothing of JAX, PIL, matplotlib or sklearn is imported."""
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="2")
    out = subprocess.run([sys.executable, "-c", _SLICE20_CHECK, str(tmp_path)],
                         cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    z, e, seg, ckpt, bad = json.loads(out.stdout.strip().splitlines()[-1])
    assert bad == []
    assert z == [1, 4, 4, 8] and e == [1, 8, 8, 3] and ckpt
    assert seg == ["cluster_to_class", "miou", "pixel_acc"]


@pytest.mark.parametrize("entry", ["wrn_validate", "knn_eval", "tsne"])
def test_slice20_entry_points_raise_without_cuda(monkeypatch, tmp_path, entry):
    from sgdm_tpu_torch.data import wrn_validate
    from sgdm_tpu_torch.eval import knn_eval, tsne

    _no_cuda(monkeypatch)
    (tmp_path / "a").mkdir()
    with pytest.raises(RuntimeError, match="CUDA"):
        if entry == "wrn_validate":
            wrn_validate.main(["-df", str(tmp_path), "--ckpt", str(tmp_path / "w.p")])
        elif entry == "knn_eval":
            knn_eval.get_knn_eval_dict(tmp_path / "a", tmp_path / "a")
        else:
            tsne.kluster_tsne_vis(tmp_path / "a", tmp_path / "a", tmp_path / "t.png")
    assert not (tmp_path / "w.p").exists() and not (tmp_path / "t.png").exists()


SLICE21_MODULES = ("utils/profiling", "utils/trace_summary", "utils/roofline",
                   "utils/parity_runbook")


def test_slice21_modules_are_scanned():
    """The tooling (profiling, the trace summary, the roofline audit, the
    parity runbook) is held to the import rule above."""
    names = {str(p.relative_to(ROOT)) for p in _port_files()}
    assert {f"sgdm_tpu_torch/{m}.py" for m in SLICE21_MODULES} <= names


_SLICE21_CHECK = """
import json, sys
from pathlib import Path
import torch
from sgdm_tpu_torch.utils import parity_runbook, profiling, roofline, trace_summary
root = Path(sys.argv[1])
with profiling.trace(root / "profile", device="cpu") as prof:
    (torch.ones(4, 4) @ torch.ones(4, 4)).sum()
code = trace_summary.main([str(root / "profile")])
audit = roofline.main(["--device", "cpu", "--batch-size", "2", "--image-size", "16",
                       "--model-channels", "16", "--cond-dim", "10", "--iters", "1",
                       "--top", "3"])
summary = parity_runbook.main(["--device", "cpu", "--out-root", str(root / "rb"),
                               "--data-root", str(root / "none")])
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("PIL", "h5py", "jax", "flax",
                                                           "sklearn", "msgpack")
             or m == "sgdm_tpu" or m.startswith("sgdm_tpu."))
print(json.dumps([code, len(audit["rows"]) > 0, summary["failed"], bad]))
"""


def test_slice21_clis_import_nothing_of_jax_h5py_or_pil_at_run_time(tmp_path):
    """A trace and its summary, the roofline audit of a tiny train step and
    the runbook without artifacts, on the CPU in a fresh interpreter:
    nothing of JAX, h5py, PIL, sklearn or msgpack is imported."""
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    for k in ("SGDM_DINO_VITB16", "SGDM_DINO_VITS16", "SGDM_CLIP_WEIGHTS",
              "SGDM_INCEPTION_WEIGHTS"):
        env.pop(k, None)
    out = subprocess.run([sys.executable, "-c", _SLICE21_CHECK, str(tmp_path)],
                         cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == [0, True, 0, []]


@pytest.mark.parametrize("entry", ["roofline", "parity_runbook", "trace"])
def test_slice21_entry_points_raise_without_cuda(monkeypatch, tmp_path, entry):
    """The roofline CLI, the runbook and `trace` default to the card and
    raise without one."""
    from sgdm_tpu_torch.utils import parity_runbook, profiling, roofline

    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="CUDA"):
        if entry == "roofline":
            roofline.main(["--batch-size", "2", "--image-size", "16", "--model-channels", "16"])
        elif entry == "parity_runbook":
            parity_runbook.main(["--out-root", str(tmp_path)])
        else:
            with profiling.trace(tmp_path / "profile"):
                pass
    assert not (tmp_path / "profile").exists()


def _no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_generate_raises_without_cuda(monkeypatch):
    _no_cuda(monkeypatch)
    cfg = dict(UNET_FAST_IN64, image_size=8, model_channels=32, channel_mult=[1],
               num_res_blocks=1, attention_resolutions=[], cond_dim=4)
    with pytest.raises(RuntimeError, match="CUDA"):
        generate(cfg, n=1, steps=4)


def test_make_sample_fn_raises_without_cuda(monkeypatch):
    _no_cuda(monkeypatch)
    model = create_denoiser(model_channels=32, channel_mult=[1], num_res_blocks=1,
                            attention_resolutions=[])
    with pytest.raises(RuntimeError, match="CUDA"):
        make_sample_fn(model, GaussianDiffusion())
    make_sample_fn(model, GaussianDiffusion(), device="cpu")  # explicit host is fine


def test_train_entry_points_raise_without_cuda(monkeypatch):
    from sgdm_tpu_torch import train

    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--steps", "1", "--batch-size", "1", "--image-size", "8",
                    "--model-channels", "32", "--cond-dim", "4"])
    model = create_denoiser(model_channels=32, channel_mult=[1], num_res_blocks=1,
                            attention_resolutions=[])
    tx = create_optimizer("adamw")
    with pytest.raises(RuntimeError, match="CUDA"):
        make_train_step(model, GaussianDiffusion(), tx)
    with pytest.raises(RuntimeError, match="CUDA"):
        create_train_state(model, tx)
    make_train_step(model, GaussianDiffusion(), tx, device="cpu")  # explicit host is fine


def test_fid_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    from types import SimpleNamespace

    from sgdm_tpu_torch.eval import fid_cli, harness
    from sgdm_tpu_torch.eval.fid_engine import InceptionExtractor

    _no_cuda(monkeypatch)
    for d in ("a", "b"):
        (tmp_path / d).mkdir()
    with pytest.raises(RuntimeError, match="CUDA"):
        InceptionExtractor()
    with pytest.raises(RuntimeError, match="CUDA"):
        fid_cli.main([str(tmp_path / "a"), str(tmp_path / "b")])
    trainer = SimpleNamespace(device=torch.device("cuda"), log_dir=tmp_path, cond_scale=None,
                              diff_params={})
    from torch_port_common import tiny_datamodule_cfg

    cfg = {"data": dict(tiny_datamodule_cfg(), test_fid_num=4, val_fid_num=4,
                        fid_train_image_dir=str(tmp_path / "a")), "debug": False}
    harness._EXTRACTORS.clear()
    with pytest.raises(RuntimeError, match="CUDA"):
        harness.run_test_and_all_exploration(trainer, cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        harness.make_val_fid_fn(cfg["data"])(trainer, epoch=1)
    InceptionExtractor(device="cpu")  # explicit host is fine


def test_resolve_device():
    assert sgdm_tpu_torch.resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        sgdm_tpu_torch.resolve_device("meta")


def test_cpu_tensors_take_plain_paths_and_count_nothing():
    ops.reset_launch_counts()
    g = torch.Generator().manual_seed(0)
    r = lambda *s: torch.randn(*s, generator=g)
    x = r(2, 8, 8, 16)
    args = [r(16), r(16), r(3, 3, 16, 16), r(16), r(2, 16), r(2, 16), r(16), r(16),
            r(3, 3, 16, 16), r(16)]
    ops.fused_resblock(x, *args)
    ops.fused_resblock(x, *args, resample="up")
    ops.fused_resblock(x, *args, resample="down")
    ops.fused_self_attention(r(1, 2, 16, 8), r(1, 2, 16, 8), r(1, 2, 16, 8))
    xg = x.clone().requires_grad_()
    ops.fused_resblock_train(xg, *args, seed=3, dropout_rate=0.1).sum().backward()
    q = r(1, 2, 16, 64).requires_grad_()
    ops.flash_attention(q, q, q).sum().backward()
    flat = [r(8) for _ in range(5)]
    ops.fused_adamw_ema(*flat, dict(lr=1e-3, inv_bc1=10.0, inv_bc2=1000.0, one_minus=0.9,
                                    b1=0.9, omb1=0.1, b2=0.999, omb2=0.001, eps=1e-8, wd=0.01))
    qn = r(2, 16, 3, 8).requires_grad_()
    ops.fused_null_kv_attention(qn, r(2, 19, 8), r(2, 19, 8)).sum().backward()
    xn = r(2, 4, 4, 16).requires_grad_()
    ops.fused_groupnorm_silu(xn, r(16), r(16), r(2, 16), r(2, 16), 16).sum().backward()
    assert ops.launch_counts() == {
        "resblock": 0, "resblock_resample": 0, "self_attention": 0, "resblock_train": 0,
        "resblock_bwd": 0, "flash_attention_fwd": 0, "flash_attention_bwd": 0,
        "flash_attention_fwd_f32": 0, "flash_attention_bwd_f32": 0, "adamw_ema": 0,
        "groupnorm_silu": 0, "null_kv_attention": 0}


def test_cuda_wrappers_refuse_cpu_tensors():
    """A kernel wrapper never gives way to the plain version: on a CPU tensor it raises."""
    from sgdm_tpu_torch.ops.attention import (flash_attention_bwd_f32_cuda,
                                              flash_attention_fwd_f32_cuda,
                                              null_kv_attention_cuda)
    from sgdm_tpu_torch.ops.groupnorm import groupnorm_silu_cuda

    with pytest.raises(ValueError, match="CPU tensor"):
        null_kv_attention_cuda(torch.zeros(1, 4, 2, 8), torch.zeros(1, 5, 8), torch.zeros(1, 5, 8))
    q = torch.zeros(1, 2, 8, 64)
    with pytest.raises(ValueError, match="CPU tensor"):
        flash_attention_fwd_f32_cuda(q, q, q)
    with pytest.raises(ValueError, match="CPU tensor"):
        flash_attention_bwd_f32_cuda(q, q, q, q, torch.zeros(1, 2, 8), q)
    with pytest.raises(ValueError, match="CPU tensor"):
        groupnorm_silu_cuda(torch.zeros(1, 2, 2, 8), torch.ones(8), torch.zeros(8))


def test_no_kernel_is_built_at_import():
    from sgdm_tpu_torch.ops import build

    assert build._libs == {}


def test_unet_fast_in64_literal_matches_composed_config():
    from sgdm_tpu.config.engine import compose, to_container

    cfg = to_container(compose(ROOT / "configs", overrides=["data=in64_pickle"]))
    params = {k: v for k, v in cfg["dynamic"]["params"].items() if k != "condition"}
    assert params == UNET_FAST_IN64
    assert cfg["sg"]["params"]["compute_dtype"] == "bfloat16"


def test_unetca_fast_voc64_literal_matches_composed_config():
    """The literal is configs/dynamic/unetca_fast.yaml at data=voc64 under the
    VOC64 STEGO headline overrides (21 classes in cond and layout), with
    condition.stegoclusterlayout.layout_dim written out as layout_dim (a torch
    module is built knowing its channels)."""
    from sgdm_tpu.config.engine import compose, to_container

    cfg = to_container(compose(ROOT / "configs", overrides=[
        "data=voc64", "dynamic=unetca_fast", "sg.params.condition_method=stegoclusterlayout",
        "sg.params.cond_dim=21", "dynamic.params.cond_token_num=1",
        "dynamic.params.context_dim=32", "condition.stegoclusterlayout.layout_dim=21"]))
    params = dict(cfg["dynamic"]["params"])
    condition = params.pop("condition")
    literal = dict(UNETCA_FAST_VOC64)
    assert literal.pop("layout_dim") == condition["stegoclusterlayout"]["layout_dim"] == 21
    assert params == literal


def test_unetca_fast_voc64_builds_the_expected_blocks():
    from sgdm_tpu_torch.models.attention_lr import AttentionLR
    from sgdm_tpu_torch.models.layers import Downsample, ResBlock, Upsample

    model = create_denoiser(**UNETCA_FAST_VOC64, dtype=torch.bfloat16)
    blocks = [m for m in model.modules() if isinstance(m, ResBlock)]
    attn = [m for m in model.modules() if isinstance(m, AttentionLR)]
    assert len(blocks) == 17 and all(b.resample is None for b in blocks)
    assert sum(isinstance(m, (Downsample, Upsample)) for m in model.modules()) == 4
    assert len(attn) == 6 and all((a.heads, a.dim_head) == (8, 64) for a in attn)
    assert model.backbone.in_conv.weight.shape[1] == 3 + 21
    assert all(b.emb_proj.weight.shape[1] == 512 for b in blocks)

    import jax
    import jax.numpy as jnp
    from flax import traverse_util

    from sgdm_tpu.models.factory import create_denoiser as jax_create_denoiser
    from sgdm_tpu_torch.models.convert import flax_key_to_torch

    jm = jax_create_denoiser(dtype=jnp.bfloat16, **UNETCA_FAST_VOC64)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
                            jnp.zeros((1,), jnp.int32), cond=jnp.zeros((1, 21)),
                            layout=jnp.zeros((1, 64, 64, 21)))["params"]
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    got = {}
    for path, leaf in traverse_util.flatten_dict(shapes, sep="/").items():
        shape = tuple(leaf.shape)
        if path.endswith("kernel"):
            shape = shape[::-1] if len(shape) == 2 else (shape[3], shape[2], shape[0], shape[1])
        got[flax_key_to_torch(path)] = shape
    assert got == want


def test_unet_fast_in64_builds_the_expected_blocks():
    model = create_denoiser(**dict(UNET_FAST_IN64, cond_dim=1000), dtype=torch.bfloat16)
    from sgdm_tpu_torch.models.layers import ResBlock, SelfAttentionBlock

    blocks = [m for m in model.modules() if isinstance(m, ResBlock)]
    attn = [m for m in model.modules() if isinstance(m, SelfAttentionBlock)]
    assert sum(b.resample is None for b in blocks) == 17
    assert sum(b.resample is not None for b in blocks) == 4
    assert sum(b.skip_proj is not None for b in blocks) == 11
    assert len(attn) == 6 and all(a.heads == 8 for a in attn)

    # every flax leaf of the JAX model at full width maps to one parameter
    import jax
    import jax.numpy as jnp
    from flax import traverse_util

    from sgdm_tpu.models.factory import create_denoiser as jax_create_denoiser
    from sgdm_tpu_torch.models.convert import flax_key_to_torch

    jm = jax_create_denoiser(dtype=jnp.bfloat16, **dict(UNET_FAST_IN64, cond_dim=1000))
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
                            jnp.zeros((1,), jnp.int32), cond=jnp.zeros((1, 1000)))["params"]
    flat = traverse_util.flatten_dict(shapes, sep="/")
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    got = {}
    for path, leaf in flat.items():
        shape = tuple(leaf.shape)
        if path.endswith("kernel"):
            shape = shape[::-1] if len(shape) == 2 else (shape[3], shape[2], shape[0], shape[1])
        got[flax_key_to_torch(path)] = shape
    assert got == want
    assert sum(int(np.prod(s)) for s in want.values()) == 74_252_803

"""ImageNet downsampling: image folders → the Chrabaszcz et al. pickles.

The port's copy of `sgdm_tpu/data/imagenet_downsample.py`, the offline
preparation of the ``train_data_batch_1..10`` / ``val_data`` files that
`data/imagenet_pickle.py ImageNetPickle` reads, without PIL:

  * `resize_image_folder`: every readable image of a folder to size × size
    PNGs (grey and CMYK converted to RGB as PIL's ``convert("RGB")``), by
    one of PIL's filters (`data/transforms.py resize`, bit for bit; ``box``
    by default);
  * `pack_train_folder`: a class-subdir tree → ``num_batches`` shuffled
    pickles ``{'data': uint8 [N, 3·S²] planar RGB, 'labels': 1-based list,
    'mean': float64 [3·S²]}``, box-resized where an image is not S × S;
  * `pack_val_folder`: a flat folder (+ a 1-based ground-truth file, one
    label a line in file-name order) → ``val_data``.

Images are read by `utils/image.py read_image`: PNG and JPEG, by content.
A file neither decoder reads is skipped, where PIL would read some of them
(GIF, BMP, TIFF, WebP, arithmetic-coded or 12-bit JPEG) and skip the rest;
on PNG and JPEG trees the pickles are the JAX package's, byte for byte.

    python -m sgdm_tpu_torch.data.imagenet_downsample resize --in_dir D --out_dir O --size 32
    python -m sgdm_tpu_torch.data.imagenet_downsample pack --in_dir D --out_dir O
    python -m sgdm_tpu_torch.data.imagenet_downsample pack_val --in_dir D --out_dir O
"""

from __future__ import annotations

import argparse
import pickle
from pathlib import Path

import numpy as np

from ..utils.image import read_image
from ..utils.png import write_png
from .transforms import RESIZE_FILTERS, resize

__all__ = ["resize_image_folder", "pack_train_folder", "pack_val_folder", "planar_to_hwc",
           "main"]


def _read_rgb(path: Path) -> np.ndarray | None:
    """uint8 [H, W, 3] of a PNG or JPEG file; None for anything else."""
    try:
        return read_image(path)
    except (OSError, ValueError):
        return None


def resize_image_folder(in_dir: str | Path, out_dir: str | Path, size: int,
                        alg: str = "box") -> int:
    """Resize every readable image in ``in_dir`` to size × size PNGs named
    after its stem; returns how many were written."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    n = 0
    for p in sorted(Path(in_dir).iterdir()):
        img = _read_rgb(p)
        if img is None:
            continue
        write_png(out_dir / (p.stem + ".png"), resize(img, size, size, alg))
        n += 1
    return n


def _img_to_planar_row(path: Path, size: int) -> np.ndarray | None:
    """An image file → uint8 [3·S²] planar row (r..g..b), box-resized if needed."""
    img = _read_rgb(path)
    if img is None:
        return None
    if img.shape[:2] != (size, size):
        img = resize(img, size, size, "box")
    return img.transpose(2, 0, 1).reshape(-1)


def planar_to_hwc(row: np.ndarray, size: int) -> np.ndarray:
    """The inverse of the planar packing."""
    return np.asarray(row, np.uint8).reshape(3, size, size).transpose(1, 2, 0)


def pack_train_folder(in_dir: str | Path, out_dir: str | Path, size: int = 32,
                      num_batches: int = 10, seed: int = 0) -> Path:
    """A class-subdir tree → shuffled ``train_data_batch_1..N`` pickles;
    folder order defines the labels, 1-based like the original files."""
    in_dir, out_dir = Path(in_dir), Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    rows, labels = [], []
    folders = sorted(p for p in in_dir.iterdir() if p.is_dir())
    if not folders:
        raise FileNotFoundError(f"no class folders under {in_dir}")
    for label, folder in enumerate(folders, start=1):
        for p in sorted(folder.iterdir()):
            row = _img_to_planar_row(p, size)
            if row is not None:
                rows.append(row)
                labels.append(label)
    x = np.stack(rows)
    y = np.asarray(labels)
    x_mean = x.mean(axis=0)
    idx = np.random.RandomState(seed).permutation(len(x))
    per = len(x) // num_batches
    for i in range(1, num_batches + 1):
        sl = idx[(i - 1) * per:] if i == num_batches else idx[(i - 1) * per: i * per]
        with open(out_dir / f"train_data_batch_{i}", "wb") as f:
            pickle.dump({"data": x[sl], "labels": y[sl].tolist(), "mean": x_mean}, f)
    return out_dir


def pack_val_folder(in_dir: str | Path, out_dir: str | Path, size: int = 32,
                    ground_truth: str | Path | None = None) -> Path:
    """A flat val folder (+ an optional 1-based ground-truth file) → ``val_data``."""
    in_dir, out_dir = Path(in_dir), Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    files = sorted(p for p in in_dir.iterdir() if p.is_file())
    gt = ([int(v) for v in Path(ground_truth).read_text().split()] if ground_truth
          else [1] * len(files))
    rows, labels = [], []
    for p, label in zip(files, gt):
        row = _img_to_planar_row(p, size)
        if row is not None:
            rows.append(row)
            labels.append(label)
    with open(out_dir / "val_data", "wb") as f:
        pickle.dump({"data": np.stack(rows), "labels": labels}, f)
    return out_dir


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = p.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("resize")
    r.add_argument("--in_dir", required=True)
    r.add_argument("--out_dir", required=True)
    r.add_argument("--size", type=int, default=32)
    r.add_argument("--alg", default="box", choices=sorted(RESIZE_FILTERS))
    t = sub.add_parser("pack")
    t.add_argument("--in_dir", required=True, help="class-subdir train tree")
    t.add_argument("--out_dir", required=True)
    t.add_argument("--size", type=int, default=32)
    t.add_argument("--num_batches", type=int, default=10)
    t.add_argument("--seed", type=int, default=0)
    v = sub.add_parser("pack_val")
    v.add_argument("--in_dir", required=True)
    v.add_argument("--out_dir", required=True)
    v.add_argument("--size", type=int, default=32)
    v.add_argument("--ground_truth", default=None)
    a = p.parse_args(argv)
    if a.cmd == "resize":
        n = resize_image_folder(a.in_dir, a.out_dir, a.size, a.alg)
        print(f"resized {n} images → {a.out_dir}")
    elif a.cmd == "pack":
        pack_train_folder(a.in_dir, a.out_dir, a.size, a.num_batches, a.seed)
        print(f"packed train pickles → {a.out_dir}")
    else:
        pack_val_folder(a.in_dir, a.out_dir, a.size, a.ground_truth)
        print(f"packed val_data → {a.out_dir}")


if __name__ == "__main__":
    main()

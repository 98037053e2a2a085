"""One-off dataset preparation (host side, no device work).

The port's copy of `sgdm_tpu/data/prep.py`, without PIL:

  * ``cocostuff-from-coco17``: copy the STEGO-curated subset of COCO 2017
    images into the cocostuff27 ``train`` / ``val`` layout;
  * ``ffhq-onelevel``: flatten FFHQ's sharded thumbnail folders into one;
  * ``cityscapes-resize``: ``leftImg8bit/{split}`` to size × size RGB PNGs
    by PIL's bilinear filter, ``gtCoarse/{split}`` label maps (only those
    matching ``--label-pattern``) by NEAREST on their stored samples, under
    ``dest/{split}_images`` and ``dest/{split}_labels``, flat, each file
    under its own name.  That is the JAX package's layout, kept as it is:
    `data/cityscapes.py` reads ``leftImg8bit/{split}/<city>/`` and
    ``gtFine/``, so it cannot read this tree (ROADMAP §3).

Images are read by `utils/image.py read_image` (PNG or JPEG by content),
label maps by `utils/png.py read_png(samples=True)` (8-bit samples: grey
or palette indices, written back as grey), resized by `data/transforms.py
resize`, written by `utils/png.py write_png`: the pixels are PIL's, bit for
bit; the PNG files are not byte for byte (another zlib stream).

    python -m sgdm_tpu_torch.data.prep cocostuff-from-coco17 \\
        --coco17-images /data/coco/images --curated /data/curated --dest D
    python -m sgdm_tpu_torch.data.prep ffhq-onelevel --src S --dest D
    python -m sgdm_tpu_torch.data.prep cityscapes-resize --src S --dest D --size 320 \\
        --splits train_extra val
"""

from __future__ import annotations

import argparse
import shutil
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Iterable

from ..utils.image import read_image
from ..utils.png import read_png, write_png
from .transforms import resize

__all__ = ["make_clean_dir", "extract_cocostuff_from_coco17", "ffhq_onelevel",
           "resize_cityscapes", "main"]


def make_clean_dir(path: str | Path) -> Path:
    """Recreate ``path`` empty."""
    p = Path(path)
    if p.exists():
        shutil.rmtree(p)
    p.mkdir(parents=True)
    return p


def _read_id_list(txt: Path) -> list[str]:
    ids = [line.strip() for line in txt.read_text().splitlines() if line.strip()]
    if not ids:
        raise ValueError(f"empty curated id list: {txt}")
    return ids


def extract_cocostuff_from_coco17(coco17_images: str | Path, curated_dir: str | Path,
                                  dest: str | Path, *,
                                  curated_name: str = "Coco164kFull_Stuff_Coarse_7.txt",
                                  limit: int | None = None) -> dict[str, int]:
    """Copy the curated cocostuff subset out of a COCO 2017 tree
    (``coco17_images/{split}2017/<id>.jpg``, lists under
    ``curated_dir/{split}2017/<curated_name>``) to ``dest/{train,val}``;
    returns the copies per split."""
    coco17_images, curated_dir = Path(coco17_images), Path(curated_dir)
    counts = {}
    for split in ("train", "val"):
        ids = _read_id_list(curated_dir / f"{split}2017" / curated_name)
        if limit is not None:
            ids = ids[:limit]
        src_dir = coco17_images / f"{split}2017"
        out = make_clean_dir(Path(dest) / split)
        for img_id in ids:
            src = src_dir / f"{img_id}.jpg"
            if not src.exists():
                raise FileNotFoundError(f"curated id {img_id!r} has no image at {src}")
            shutil.copyfile(src, out / src.name)
        counts[split] = len(ids)
    return counts


def ffhq_onelevel(src: str | Path, dest: str | Path, *, suffix: str = ".png") -> int:
    """Flatten FFHQ's ``NN000/NNNNN.png`` shards into one directory; a
    basename seen twice raises."""
    src = Path(src)
    out = make_clean_dir(dest)
    seen: set[str] = set()
    n = 0
    for f in sorted(src.rglob(f"*{suffix}")):
        if not f.is_file():
            continue
        if f.name in seen:
            raise ValueError(f"duplicate basename across shards: {f.name}")
        seen.add(f.name)
        shutil.copyfile(f, out / f.name)
        n += 1
    if n == 0:
        raise FileNotFoundError(f"no {suffix} files under {src}")
    return n


def _resize_tree(src_dir: Path, out_dir: Path, size: int, labels: bool, workers: int,
                 pattern: str = "*.png") -> int:
    files = [f for f in sorted(src_dir.rglob(pattern)) if f.is_file()]
    if not files:
        raise FileNotFoundError(f"no {pattern} files under {src_dir}")
    make_clean_dir(out_dir)

    def one(f: Path) -> None:
        if labels:  # class ids: their own samples, never interpolated
            out = resize(read_png(f, samples=True), size, size, "nearest")
        else:
            out = resize(read_image(f), size, size, "bilinear")
        write_png(out_dir / f.name, out)

    with ThreadPoolExecutor(max_workers=workers) as pool:
        list(pool.map(one, files))
    return len(files)


def resize_cityscapes(src: str | Path, dest: str | Path, *, size: int = 320,
                      splits: Iterable[str] = ("train_extra", "val"), workers: int = 8,
                      label_pattern: str = "*_labelIds.png") -> dict[str, tuple[int, int]]:
    """Resize each split's images and label maps (see the module docstring);
    returns {split: (images, labels)}, which must match."""
    src, dest = Path(src), Path(dest)
    counts = {}
    for split in splits:
        n_img = _resize_tree(src / "leftImg8bit" / split, dest / f"{split}_images", size,
                             False, workers)
        n_lbl = _resize_tree(src / "gtCoarse" / split, dest / f"{split}_labels", size, True,
                             workers, pattern=label_pattern)
        if n_img != n_lbl:
            raise ValueError(f"{split}: {n_img} images but {n_lbl} labels matching "
                             f"{label_pattern!r}: images and labels would mis-pair")
        counts[split] = (n_img, n_lbl)
    return counts


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(prog="sgdm_tpu_torch.data.prep",
                                 description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("cocostuff-from-coco17")
    p.add_argument("--coco17-images", required=True)
    p.add_argument("--curated", required=True)
    p.add_argument("--dest", required=True)
    p.add_argument("--curated-name", default="Coco164kFull_Stuff_Coarse_7.txt")
    p.add_argument("--limit", type=int, default=None, help="debug: first N ids per split")
    p = sub.add_parser("ffhq-onelevel")
    p.add_argument("--src", required=True)
    p.add_argument("--dest", required=True)
    p = sub.add_parser("cityscapes-resize")
    p.add_argument("--src", required=True)
    p.add_argument("--dest", required=True)
    p.add_argument("--size", type=int, default=320)
    p.add_argument("--splits", nargs="+", default=["train_extra", "val"])
    p.add_argument("--workers", type=int, default=8)
    p.add_argument("--label-pattern", default="*_labelIds.png")
    args = ap.parse_args(argv)
    if args.cmd == "cocostuff-from-coco17":
        counts = extract_cocostuff_from_coco17(args.coco17_images, args.curated, args.dest,
                                               curated_name=args.curated_name, limit=args.limit)
    elif args.cmd == "ffhq-onelevel":
        counts = {"copied": ffhq_onelevel(args.src, args.dest)}
    else:
        counts = resize_cityscapes(args.src, args.dest, size=args.size, splits=args.splits,
                                   workers=args.workers, label_pattern=args.label_pattern)
    print(counts)


if __name__ == "__main__":
    main()

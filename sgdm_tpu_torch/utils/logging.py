"""Console logging and the local experiment tracker.

The port's copy of `sgdm_tpu/utils/logging.py`, local tracker only (there
is no wandb on either machine):

  * `logger` — a loguru-flavoured stdlib logger (coloured level + time);
  * `Tracker` — scalars append to ``metrics.jsonl`` one JSON record a call
    (``_step``, ``_time``, then the keys; an image is
    ``{"_type": "image", "path": …}``), byte-compatible with the JAX
    package's records so the same tools read both; images are written under
    ``media/`` as PNGs by the standard library (`utils.png.write_png`: the
    machine with the card has no PIL); the config is dumped to
    ``config.json`` (the JAX tracker writes ``config.yaml``; the card's
    machine has no PyYAML).
"""

from __future__ import annotations

import json
import logging
import os
import sys
import time
from pathlib import Path
from typing import Any, Mapping

import numpy as np

from .png import write_png

__all__ = ["logger", "Tracker", "get_tracker", "make_grid"]

_FMT = "\x1b[32m%(asctime)s\x1b[0m | \x1b[1m%(levelname)-8s\x1b[0m | %(message)s"


def _build_logger() -> logging.Logger:
    lg = logging.getLogger("sgdm_tpu_torch")
    if not lg.handlers:
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(logging.Formatter(_FMT, datefmt="%H:%M:%S"))
        lg.addHandler(h)
        lg.setLevel(os.environ.get("SGDM_LOG_LEVEL", "INFO"))
        lg.propagate = False
    return lg


logger = _build_logger()


class Tracker:
    """Local wandb-compatible experiment tracker."""

    def __init__(self, log_dir: str | Path, name: str = "run", config: Mapping | None = None):
        self.dir = Path(log_dir)
        self.name = name
        self.dir.mkdir(parents=True, exist_ok=True)
        (self.dir / "media").mkdir(exist_ok=True)
        self._metrics_file = open(self.dir / "metrics.jsonl", "a")
        self._step = 0
        if config is not None:
            (self.dir / "config.json").write_text(json.dumps(_to_plain(config), indent=2) + "\n")

    def log(self, metrics: Mapping[str, Any], step: int | None = None) -> None:
        step = self._step if step is None else step
        self._step = step + 1
        record: dict[str, Any] = {"_step": step, "_time": time.time()}
        for k, v in metrics.items():
            record[k] = self._encode(k, v, step)
        self._metrics_file.write(json.dumps(record) + "\n")
        self._metrics_file.flush()

    def _encode(self, key: str, value: Any, step: int) -> Any:
        v = value
        if hasattr(v, "shape") and getattr(v, "ndim", 0) >= 2:
            path = self._save_image(key, np.asarray(v), step)
            return {"_type": "image", "path": str(path)}
        if hasattr(v, "item"):
            try:
                return v.item()
            except (ValueError, RuntimeError):  # more than one element
                return float(np.asarray(v).mean())
        return v

    def _save_image(self, key: str, arr: np.ndarray, step: int) -> Path:
        if arr.dtype != np.uint8:
            arr = np.clip((arr + 1) * 127.5, 0, 255).astype(np.uint8)
        if arr.ndim == 4:  # batch → grid
            arr = make_grid(arr)
        safe = key.replace("/", "_")
        path = self.dir / "media" / f"{safe}_{step}.png"
        write_png(path, arr)
        return path

    def finish(self) -> None:
        self._metrics_file.close()


def make_grid(batch: np.ndarray, ncol: int | None = None, pad: int = 2) -> np.ndarray:
    """[B,H,W,C] uint8 → one grid image (wandb-grid / torchvision-style)."""
    b, h, w, c = batch.shape
    ncol = ncol or int(np.ceil(np.sqrt(b)))
    nrow = int(np.ceil(b / ncol))
    grid = np.zeros((nrow * (h + pad) - pad, ncol * (w + pad) - pad, c), dtype=batch.dtype)
    for i in range(b):
        r, cidx = divmod(i, ncol)
        grid[r * (h + pad):r * (h + pad) + h, cidx * (w + pad):cidx * (w + pad) + w] = batch[i]
    return grid


def _to_plain(node: Any) -> Any:
    if isinstance(node, Mapping):
        return {k: _to_plain(v) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_to_plain(v) for v in node]
    if isinstance(node, (str, int, float, bool)) or node is None:
        return node
    return str(node)


def get_tracker(log_dir: str | Path, name: str = "run",
                config: Mapping | None = None) -> Tracker:
    """The local `Tracker` (the JAX package's wandb branch has no counterpart)."""
    return Tracker(log_dir, name=name, config=config)

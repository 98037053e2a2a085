"""FID engine: images → Inception features → metric dict.

The port's counterpart of `sgdm_tpu/eval/fid_engine.py`:

  * `InceptionExtractor` runs the FID InceptionV3 (`eval.inception`) on the
    card in full float32 (no TF32) after one of two batched resizes to
    299×299, both on the card:
      - ``clean``: ``F.interpolate(mode="bicubic", antialias=True)`` of the
        0-255 values in float32, then ``/127.5 - 1`` (clean-fid's float32
        PIL bicubic, which the JAX package calls per image on the host:
        8.4e-4 apart on the 0-255 scale at 64 → 299),
      - ``bilinear``: ``F.interpolate(mode="bilinear", antialias=False)``,
        what ``jax.image.resize(..., "bilinear")`` does when it upsamples;
    directories (PNG or JPEG) are read by `utils.image.read_image` in
    ``sorted`` file order, and a reference directory's features can be
    cached by its content
    fingerprint (4 entries at most);
  * `get_fid_dict` gives the JAX package's keys: clean_fid_raw, sfid,
    fid_tf, is_tf_s1/s10 (+ stds), precision / recall / density / coverage
    on a subsample drawn by ``np.random.default_rng(seed)``;
  * `sample_to_dir` cycles a loader through a sampling function and writes
    ``img{i}.png`` (`utils.png.write_png`).

Without weights (a ``weights_path``, or ``SGDM_INCEPTION_WEIGHTS``), the
extractor takes the port's deterministic random network and says so loudly:
its FIDs are self-consistent but comparable neither to published numbers
nor to the JAX package's random network.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Callable, Iterable

import numpy as np
import torch
import torch.nn.functional as F

from ..device import no_tf32, resolve_device
from ..utils.logging import logger
from ..utils.image import read_image
from ..utils.png import write_png
from .inception import build_inception, load_torch_weights, random_params
from .metrics import FeatureStats, compute_prdc, frechet_distance, inception_score

__all__ = ["InceptionExtractor", "get_fid_dict", "sample_to_dir", "cycle", "resize_299"]

_WEIGHTS_ENV = "SGDM_INCEPTION_WEIGHTS"
_SIZE = 299


def _find_weights() -> str | None:
    """``$SGDM_INCEPTION_WEIGHTS`` when it names a file (the port searches no
    other path)."""
    cand = os.environ.get(_WEIGHTS_ENV)
    return cand if cand and Path(cand).exists() else None


def resize_299(imgs: torch.Tensor, mode: str) -> torch.Tensor:
    """uint8 (or 0-255 float) [B, H, W, 3] on any device → float32
    [B, 3, 299, 299] in [-1, 1] on the same device."""
    x = imgs.permute(0, 3, 1, 2).float()
    if mode == "clean":
        x = F.interpolate(x, size=(_SIZE, _SIZE), mode="bicubic", align_corners=False,
                          antialias=True)
    elif mode == "bilinear":
        x = F.interpolate(x, size=(_SIZE, _SIZE), mode="bilinear", align_corners=False,
                          antialias=False)
    else:
        raise ValueError(mode)
    return x / 127.5 - 1.0


class InceptionExtractor:
    """Batched Inception features with explicit resize modes, on ``device``."""

    def __init__(self, weights_path: str | None = None, seed: int = 0, batch_size: int = 64,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.batch_size = batch_size
        self._dir_cache: dict = {}
        weights_path = weights_path or _find_weights()
        if weights_path:
            logger.info(f"inception weights: {weights_path}")
            state = load_torch_weights(weights_path)
            self.pretrained = True
            # first use of real weights: the folded network against the
            # unfolded replica (utils.weight_verify)
            from ..utils.weight_verify import verify_inception_load

            verify_inception_load(weights_path, state)
        else:
            logger.warning(
                "No pt_inception weights found (set SGDM_INCEPTION_WEIGHTS). Using the port's "
                "DETERMINISTIC RANDOM inception network: FID values are self-consistent but "
                "comparable neither to published numbers nor to the JAX package's random "
                "network.")
            state = random_params(seed)
            self.pretrained = False
        self.model = build_inception(state, self.device)

    # ------------------------------------------------------------------
    def forward(self, imgs: np.ndarray | torch.Tensor, mode: str) -> dict[str, torch.Tensor]:
        """uint8 [B, H, W, 3] → pool3 / logits / spatial on the device, full float32."""
        x = torch.as_tensor(imgs).to(self.device, non_blocking=True)
        # cuDNN's default TF32 moves the features by ≈7e-4 relative on the H100
        with torch.inference_mode(), no_tf32():
            return self.model(resize_299(x, mode))

    def _features(self, batches: Iterable[np.ndarray], mode: str) -> dict[str, np.ndarray]:
        outs: dict[str, list[np.ndarray]] = {"pool3": [], "logits": [], "spatial": []}
        for batch in batches:
            res = self.forward(batch, mode)
            for k in outs:
                outs[k].append(res[k].cpu().numpy())
        return {k: np.concatenate(v) for k, v in outs.items()}

    def features_from_arrays(self, imgs: np.ndarray, mode: str = "clean") -> dict[str, np.ndarray]:
        """imgs: uint8 [N, H, W, 3].  Returns pool3 / logits / spatial as numpy."""
        bs = self.batch_size
        return self._features((imgs[i:i + bs] for i in range(0, len(imgs), bs)), mode)

    def features_from_dir(self, folder: str | Path, mode: str = "clean",
                          max_items: int | None = None, cache: bool = False
                          ) -> dict[str, np.ndarray]:
        """Features of the images of ``folder`` in ``sorted`` file order.

        ``cache=True`` memoizes the result keyed by the dir's content
        fingerprint (name, mtime and size of every image): the reference dir
        is read unchanged by every validation epoch and test mode.  Bounded
        to the 4 most recent entries; sample dirs should not pass it."""
        files = sorted(p for p in Path(folder).iterdir()
                       if p.suffix.lower() in (".png", ".jpg", ".jpeg"))
        if max_items:
            files = files[:max_items]
        if not files:
            raise FileNotFoundError(f"no images in {folder}")
        if cache:
            fp = hash(tuple((f.name, f.stat().st_mtime_ns, f.stat().st_size) for f in files))
            key = (str(Path(folder).resolve()), mode, max_items, fp)
            hit = self._dir_cache.get(key)
            if hit is not None:
                return hit
        bs = self.batch_size
        result = self._features(
            (np.stack([read_image(f) for f in files[i:i + bs]]) for i in range(0, len(files), bs)),
            mode)
        if cache:
            self._dir_cache[key] = result
            while len(self._dir_cache) > 4:  # FIFO bound
                self._dir_cache.pop(next(iter(self._dir_cache)))
        return result


# ----------------------------------------------------------------------

def _mu_cov(feats: np.ndarray, across: bool = False, group=None
            ) -> tuple[np.ndarray, np.ndarray]:
    """(μ, Σ) of a feature matrix; ``across``: of every rank's rows in
    ``group`` (`FeatureStats.reduce_across_processes`; a rank may hold none)."""
    st = FeatureStats()
    if len(feats):
        st.append(feats)
    if across:
        st.reduce_across_processes(dim=feats.shape[1], group=group)
    return st.mean_cov()


def _sample_features(extractor: InceptionExtractor, sample_dir, mode: str,
                     like: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    """The features of a sample dir; no rows (``like``'s widths) when it is empty."""
    if any(p.suffix.lower() == ".png" for p in Path(sample_dir).iterdir()):
        return extractor.features_from_dir(sample_dir, mode=mode)
    return {k: np.zeros((0, v.shape[1]), np.float32) for k, v in like.items()}


def get_fid_dict(sample_dir: str | Path, gt_dir: str | Path, extractor: InceptionExtractor, *,
                 debug: bool = False, nearest_k: int = 5, prdc_subsample: int = 5000,
                 seed: int = 0, group=None) -> tuple[dict[str, float], float]:
    """The metric dict between two image folders, and clean_fid_raw.

    As `sgdm_tpu/eval/fid_engine.py get_fid_dict`: the same keys; ``debug``
    skips fid_tf and IS (the bilinear pass); PRDC on a subsample of at most
    ``prdc_subsample`` drawn from ``np.random.default_rng(seed)``.

    ``group`` (a `torch.distributed` group; each rank its own sample dir,
    which may be empty): the Fréchet statistics of the samples are those of
    every rank's dir; each rank reads the whole reference dir, whose
    statistics stay its own (the JAX package sums them over processes too,
    counting the reference once per process).  The group's first rank
    computes the metrics (IS and PRDC on its own samples, as every JAX
    process does on its own) and sends every rank the result."""
    import torch.distributed as dist

    from ..parallel.mesh import broadcast_object

    multi = dist.is_available() and dist.is_initialized()
    lead = not multi or dist.get_rank(group) == 0
    f_real = extractor.features_from_dir(gt_dir, mode="clean", cache=True)
    f_sample = _sample_features(extractor, sample_dir, "clean", f_real)
    stats = [(_mu_cov(f_sample["pool3"], multi, group), _mu_cov(f_real["pool3"])),
             (_mu_cov(f_sample["spatial"], multi, group), _mu_cov(f_real["spatial"]))]
    if not debug:
        fb_real = extractor.features_from_dir(gt_dir, mode="bilinear", cache=True)
        fb_sample = _sample_features(extractor, sample_dir, "bilinear", fb_real)
        stats.append((_mu_cov(fb_sample["pool3"], multi, group), _mu_cov(fb_real["pool3"])))

    result = None
    if lead:
        out: dict[str, float] = {}
        keys = ["clean_fid_raw", "sfid"] + ([] if debug else ["fid_tf"])
        for key, ((mu1, s1), (mu2, s2)) in zip(keys, stats):  # sFID: 2023-d spatial features
            out[key] = frechet_distance(mu1, s1, mu2, s2)
        if not debug:
            for splits in (1, 10):
                m, s = inception_score(fb_sample["logits"], splits=splits)
                out[f"is_tf_s{splits}"] = m
                out[f"is_std_tf_s{splits}"] = s
        rng = np.random.default_rng(seed)
        n = min(len(f_real["pool3"]), len(f_sample["pool3"]), prdc_subsample)
        ir = rng.choice(len(f_real["pool3"]), n, replace=False)
        is_ = rng.choice(len(f_sample["pool3"]), n, replace=False)
        out.update(compute_prdc(f_real["pool3"][ir], f_sample["pool3"][is_],
                                nearest_k=nearest_k))
        logger.warning(f"fid_dict: {out}")
        result = (out, out["clean_fid_raw"])
    if multi:
        src = dist.get_global_rank(group, 0) if group is not None else 0
        result = broadcast_object(result, src=src, group=group)
    return result


# ----------------------------------------------------------------------

def cycle(dl: Iterable) -> Iterable:
    """Endless loader."""
    while True:
        for batch in dl:
            yield batch


def _write(path: Path, img: np.ndarray) -> None:
    write_png(path, img if img.shape[-1] > 1 else img[..., 0])


def sample_to_dir(
    sample_fn: Callable[[dict, int], np.ndarray],
    loader: Iterable,
    fid_num: int,
    sample_dir: str | Path,
    *,
    save_gt_dir: str | Path | None = None,
    batch_transform: Callable[[dict], dict] | None = None,
    vis_callback: Callable[[int, dict, np.ndarray], None] | None = None,
    vis_batches: int = 2,
    share: tuple[int, int] = (0, 1),
) -> Path:
    """Sample ceil(fid_num / bs) batches and write ``img{i}.png``.

    ``sample_fn(raw_batch, seed) -> uint8 [B, H, W, C]`` (numpy or a
    tensor).  Stale ``img*.png`` are removed first (the reader takes every
    file present).  ``batch_transform`` rewrites a batch before sampling,
    ``vis_callback(batch_index, raw_batch, samples)`` sees the first
    ``vis_batches`` batches; ``save_gt_dir`` writes each sample's real
    image beside it, paired by the index within the batch.

    ``share`` (r, n): rank r of n on the data axis writes its share of
    ``fid_num`` (every n-th sample from the r-th) from its slice of each
    batch; every rank samples as many batches as the largest share needs,
    so ranks whose sampling holds collectives stay in step.  The seed of
    batch ``bi`` is ``bi·n + r``."""
    sample_dir = Path(sample_dir)
    sample_dir.mkdir(parents=True, exist_ok=True)
    for old in sample_dir.glob("img*.png"):
        old.unlink()
    if save_gt_dir is not None:
        Path(save_gt_dir).mkdir(parents=True, exist_ok=True)
        for old in Path(save_gt_dir).glob("img*.png"):
            old.unlink()
    r, n = share
    want, most = len(range(r, fid_num, n)), -(-fid_num // n)
    i = made = 0
    for bi, batch in enumerate(cycle(loader)):
        if made >= most:
            break
        if batch_transform is not None:
            batch = batch_transform(dict(batch))
        imgs = sample_fn(batch, bi * n + r)
        imgs = imgs.cpu().numpy() if isinstance(imgs, torch.Tensor) else np.asarray(imgs)
        made += len(imgs)
        if vis_callback is not None and bi < vis_batches:
            vis_callback(bi, batch, imgs)
        for j, img in enumerate(imgs[:max(want - i, 0)]):
            _write(sample_dir / f"img{i}.png", img)
            if save_gt_dir is not None:
                real = np.asarray(batch["image"][j % len(batch["image"])])
                _write(Path(save_gt_dir) / f"img{i}.png",
                       np.clip((real + 1) * 127.5, 0, 255).astype(np.uint8))
            i += 1
    return sample_dir

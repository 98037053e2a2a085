"""First-use checks of real ``pt_inception`` and DINO checkpoints.

The port's copy of `sgdm_tpu/utils/weight_verify.py`.  The first time a
real ``pt_inception`` checkpoint is loaded, the folded network
(`eval.inception`) is held against the unfolded replica
(`eval.inception_ref`) on a fixed seeded input:

  1. if a sidecar golden ``<ckpt>.golden.npz`` exists, the folded network's
     ``pool3`` must match it;
  2. otherwise the replica loads the same file, its ``pool3`` is computed,
     written as the sidecar and asserted against;
  3. if the replica cannot load the file, a loud warning is logged and the
     check is skipped (never silently passed).

Both forwards run on the CPU in float32; the tolerance is the JAX
package's (``_ATOL``), and the sidecar format is the same, so either
package may write it.

`verify_dino_load` holds a loaded DINO ViT's CLS feature of the same fixed
input against the sidecar ``<ckpt>.golden.npz`` (``cls``) when there is
one; the port has no second DINO implementation to compute the ground
truth, so without a sidecar it warns and skips, as the JAX package does
when it has no torch ground truth.
"""

from __future__ import annotations

from pathlib import Path
from typing import Mapping

import numpy as np
import torch

from .logging import logger

__all__ = ["verify_inception_load", "verify_dino_load"]

_ATOL = 1e-3  # f32 forwards of the folded and unfolded 299-px network


def _fixed_input(shape, seed: int = 1234) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal(shape) * 0.4).astype(np.float32)


def _sidecar(ckpt_path) -> Path:
    return Path(str(ckpt_path) + ".golden.npz")


def _check(name: str, got: np.ndarray, want: np.ndarray, ckpt) -> None:
    err = float(np.abs(got - want).max())
    if err > _ATOL:
        raise RuntimeError(
            f"weight-port verification FAILED for {ckpt}: {name} differs from the torch "
            f"ground truth by {err:.2e} (tol {_ATOL}). The loader mapping is wrong for this "
            "checkpoint format: do not trust FID outputs until this is fixed.")
    logger.info(f"weight-port golden ok: {name} max|Δ|={err:.2e} ({ckpt})")


def verify_inception_load(ckpt_path, state_dict: Mapping[str, torch.Tensor]) -> bool:
    """Verify the folded state dict (`eval.inception.load_torch_weights`) of
    ``ckpt_path`` against the unfolded replica.  True when verified, False
    when skipped (no ground truth)."""
    from ..eval.inception import build_inception

    x = torch.from_numpy(_fixed_input((1, 3, 299, 299)))
    with torch.no_grad():
        pool3 = build_inception({k: v.cpu() for k, v in state_dict.items()})(x)["pool3"].numpy()

    side = _sidecar(ckpt_path)
    if side.exists():
        _check("inception.pool3", pool3, np.load(side)["pool3"], ckpt_path)
        return True
    try:
        from ..eval.inception_ref import TFIDInception

        tm = TFIDInception().eval()
        tm.load_state_dict(torch.load(ckpt_path, map_location="cpu", weights_only=True),
                           strict=False)
        with torch.no_grad():
            want = tm(x)[0].numpy()
    except Exception as e:  # an incompatible state dict
        logger.warning(
            f"weight-port verification SKIPPED for {ckpt_path}: no torch ground truth "
            f"available ({e!r}). Treat downstream FID numbers as unverified until a golden "
            "sidecar exists.")
        return False
    _check("inception.pool3", pool3, want, ckpt_path)
    try:
        np.savez(side, pool3=want)
        logger.info(f"wrote weight-port golden sidecar {side}")
    except OSError as e:  # read-only checkpoint dir: the check still ran
        logger.warning(f"could not write golden sidecar {side}: {e}")
    return True


def verify_dino_load(ckpt_path, model: torch.nn.Module) -> bool:
    """Verify a freshly loaded DINO ViT (`models.vit.VisionTransformer`)
    against the sidecar golden's CLS feature.  True when verified, False
    when skipped (no sidecar)."""
    import copy

    size = model.pretrain_img_size
    x = torch.from_numpy(_fixed_input((1, 3, size, size)))
    side = _sidecar(ckpt_path)
    if not side.exists():
        logger.warning(
            f"weight-port verification SKIPPED for {ckpt_path}: no golden sidecar {side} "
            "and no second DINO implementation in the port to compute one.")
        return False
    ref = copy.deepcopy(model).to("cpu", torch.float32)
    ref.dtype = torch.float32
    with torch.no_grad():
        cls = ref(x, out="cls").numpy()
    _check("dino.cls", cls, np.load(side)["cls"], ckpt_path)
    return True

"""Shared machinery of the SSL pre-trainers (MSN / MAE): schedules, the
optax-order update, the multi-crop pipeline and the encoder checkpoints.

The port's copy of `sgdm_tpu/selfsup/pretrain_common.py`:

  * `warmup_cosine_lr` (MSN's WarmupCosineSchedule: the step pre-incremented,
    linear start → ref warmup, cosine ref → final over 1.25·total − warmup),
    `linear_ramp` (the momentum / sharpen ramps over 1.25·total steps) and
    `scheduled_weight_decay` (CosineWDSchedule), each computed in float32 as
    the JAX package computes them;
  * the update as optax chains it, over lists of tensors: `chain` of
    `clip_by_global_norm`, `scale_by_adam`, `add_decayed_weights`,
    `scheduled_weight_decay`, `scale_by_schedule` and `scale_by_tree`, each
    with optax's ``init`` / ``update`` contract, and `apply_updates`;
    `wd_mask` excludes every parameter of one dimension from decay;
    `flax_init_` initialises a network as flax initialises the JAX
    package's, from a `torch.Generator` (not JAX's draws);
  * `random_resized_crop` / `multicrop_views` on the caller's
    ``np.random.Generator``, the same draws in the same order as the JAX
    package's, so a seeded sample is equal to its, pixel for pixel: the
    resize is PIL's bilinear on uint8 (`data/transforms.py resize`, PIL's
    filters bit for bit);
  * `save_encoder_ckpt` / `load_encoder_ckpt`: a `VisionTransformer`'s
    weights as flax's msgpack bytes in the JAX package's layout
    (`models/convert.py vit_to_flax`, `utils/msgpack.py pack_params`, equal
    to the JAX package's ``save_encoder_ckpt`` byte for byte) plus the
    ``.json`` meta that `selfsup.ssl_backbone` reads.
"""

from __future__ import annotations

import json
import math
from pathlib import Path
from typing import Callable, Sequence

import numpy as np
import torch

from ..data.transforms import resize
from ..models.convert import vit_from_flax, vit_to_flax
from ..utils.msgpack import pack_params, unpack_params

__all__ = [
    "warmup_cosine_lr", "scheduled_weight_decay", "linear_ramp", "wd_mask",
    "chain", "clip_by_global_norm", "scale_by_adam", "add_decayed_weights",
    "scale_by_schedule", "scale_by_tree", "grads_of", "apply_updates", "flax_init_",
    "random_resized_crop", "multicrop_views", "save_encoder_ckpt", "load_encoder_ckpt",
]

_f32 = np.float32
Tensors = Sequence[torch.Tensor]


# ----------------------------------------------------------------------
# schedules (float32, as the JAX package's jnp arithmetic)
# ----------------------------------------------------------------------

def warmup_cosine_lr(start_lr: float, ref_lr: float, final_lr: float,
                     warmup_steps: int, total_steps: int) -> Callable[[int], float]:
    """MSN WarmupCosineSchedule: linear warmup start → ref, then cosine
    ref → final over T_max = 1.25·total − warmup; ``step + 1`` (its
    ``.step()`` pre-increments)."""
    t_max = max(int(1.25 * total_steps) - warmup_steps, 1)

    def lr(step: int) -> float:
        s = _f32(step) + _f32(1.0)
        if s < warmup_steps:
            warm = s / _f32(max(warmup_steps, 1))
            return float(_f32(start_lr) + warm * _f32(ref_lr - start_lr))
        progress = (s - _f32(warmup_steps)) / _f32(t_max)
        cos = _f32(final_lr) + _f32((ref_lr - final_lr) * 0.5) * (
            _f32(1.0) + np.cos(_f32(math.pi) * progress))
        return float(max(cos, _f32(final_lr)))

    return lr


def linear_ramp(start: float, final: float, total_steps: int) -> Callable[[int], float]:
    """Linear from start to final over 1.25·total steps (MSN's momentum and
    sharpen ramps)."""
    inc = (final - start) / max(int(1.25 * total_steps), 1)

    def value(step: int) -> float:
        return start + inc * step

    return value


def wd_mask(params: Tensors) -> list[bool]:
    """True = decayed: every parameter of more than one dimension."""
    return [p.ndim > 1 for p in params]


# ----------------------------------------------------------------------
# the update, in optax's order over lists of tensors
# ----------------------------------------------------------------------

class _Transform:
    def init(self, params: Tensors):
        return None

    def update(self, updates: list, state, params: Tensors):
        raise NotImplementedError


class chain(_Transform):
    """``optax.chain``: each transform's update fed to the next."""

    def __init__(self, *transforms: _Transform):
        self.transforms = transforms

    def init(self, params):
        return [t.init(params) for t in self.transforms]

    def update(self, updates, state, params):
        out = []
        for t, s in zip(self.transforms, state):
            updates, s = t.update(updates, s, params)
            out.append(s)
        return updates, out


class clip_by_global_norm(_Transform):
    """Kept where the global norm ‖g‖ < ``max_norm``, else ``(g / ‖g‖)·max_norm``."""

    def __init__(self, max_norm: float):
        self.max_norm = max_norm

    def update(self, updates, state, params):
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(updates)))
        keep = norm < self.max_norm
        return [torch.where(keep, u, u / norm * self.max_norm) for u in updates], state


class scale_by_adam(_Transform):
    """``optax.scale_by_adam``: μ, ν moments, bias-corrected at the incremented count."""

    def __init__(self, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params):
        return {"count": 0, "mu": [torch.zeros_like(p) for p in params],
                "nu": [torch.zeros_like(p) for p in params]}

    def update(self, updates, state, params):
        b1, b2 = self.b1, self.b2
        mu = torch._foreach_add(torch._foreach_mul(updates, 1.0 - b1),
                                torch._foreach_mul(state["mu"], b1))
        sq = torch._foreach_mul(updates, updates)
        nu = torch._foreach_add(torch._foreach_mul(sq, 1.0 - b2),
                                torch._foreach_mul(state["nu"], b2))
        count = state["count"] + 1
        c1 = float(_f32(1.0) - _f32(b1) ** _f32(count))
        c2 = float(_f32(1.0) - _f32(b2) ** _f32(count))
        den = torch._foreach_add(torch._foreach_sqrt(torch._foreach_div(nu, c2)), self.eps)
        out = torch._foreach_div(torch._foreach_div(mu, c1), den)
        return out, {"count": count, "mu": mu, "nu": nu}


class add_decayed_weights(_Transform):
    """``u + wd·p`` where ``mask`` (a list of bools, or a function of the params) holds."""

    def __init__(self, weight_decay: float, mask=None):
        self.weight_decay, self.mask = weight_decay, mask

    def _mask(self, params):
        if self.mask is None:
            return [True] * len(params)
        return self.mask(params) if callable(self.mask) else self.mask

    def _coef(self, state) -> float:
        return self.weight_decay

    def update(self, updates, state, params):
        w = self._coef(state)
        out = [u + w * p if m else u
               for u, p, m in zip(updates, params, self._mask(params))]
        return out, state


class scheduled_weight_decay(add_decayed_weights):
    """Decoupled weight decay whose coefficient follows MSN's CosineWDSchedule
    at the step count + 1 (T_max = 1.25·total); chained before the lr."""

    def __init__(self, ref_wd: float, final_wd: float, total_steps: int, mask=None):
        super().__init__(ref_wd, mask)
        self.ref_wd, self.final_wd = ref_wd, final_wd
        self.t_max = max(int(1.25 * total_steps), 1)

    def wd(self, step: int) -> float:
        progress = (_f32(step) + _f32(1.0)) / _f32(self.t_max)
        v = _f32(self.final_wd) + _f32((self.ref_wd - self.final_wd) * 0.5) * (
            _f32(1.0) + np.cos(_f32(math.pi) * progress))
        final = _f32(self.final_wd)
        return float(max(v, final) if self.final_wd <= self.ref_wd else min(v, final))

    def init(self, params):
        return {"count": 0}

    def _coef(self, state) -> float:
        return self.wd(state["count"])

    def update(self, updates, state, params):
        out, _ = super().update(updates, state, params)
        return out, {"count": state["count"] + 1}


class scale_by_schedule(_Transform):
    """``u · fn(count)``, then the count advances (``fn`` = −lr for descent)."""

    def __init__(self, fn: Callable[[int], float]):
        self.fn = fn

    def init(self, params):
        return {"count": 0}

    def update(self, updates, state, params):
        s = float(_f32(self.fn(state["count"])))
        return torch._foreach_mul(updates, s), {"count": state["count"] + 1}


class scale_by_tree(_Transform):
    """The update scaled leaf by leaf (a per-group lr as one transform)."""

    def __init__(self, scales: Sequence[float]):
        self.scales = list(scales)

    def update(self, updates, state, params):
        return [u * s for u, s in zip(updates, self.scales)], state


_NORMAL_002 = ("pos_embed", "mask_token", "decoder_pos_embed")


def flax_init_(module: torch.nn.Module, generator: torch.Generator) -> torch.nn.Module:
    """Initialise ``module`` in place as flax initialises the JAX package's
    networks, from ``generator`` (not JAX's draws): kernels LeCun truncated
    normal (variance 1/fan_in), biases, CLS tokens and LayerNorm offsets
    zero, LayerNorm scales one, position embeddings and mask tokens
    N(0, 0.02²)."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf in _NORMAL_002:
                p.copy_(0.02 * torch.randn(p.shape, generator=generator))
            elif leaf in ("bias", "cls_token"):
                p.zero_()
            elif p.ndim == 1:
                p.fill_(1.0)
            else:
                fan_in = p[0].numel()
                std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
                p.copy_(torch.nn.init.trunc_normal_(torch.empty(p.shape), std=std, a=-2 * std,
                                                    b=2 * std, generator=generator))
    return module


def grads_of(loss: torch.Tensor, params: Tensors) -> list[torch.Tensor]:
    """d loss / d params, zeros for a parameter the loss does not reach (as
    ``jax.grad`` gives them: the encoder's final norm under a pooled head)."""
    grads = torch.autograd.grad(loss, list(params), allow_unused=True)
    return [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]


def apply_updates(params: Tensors, updates: Tensors) -> None:
    """``p += u`` in place, under ``no_grad``."""
    with torch.no_grad():
        torch._foreach_add_(list(params), list(updates))


# ----------------------------------------------------------------------
# numpy multi-crop augmentation (the JAX package's draws, in its order)
# ----------------------------------------------------------------------

def _resize_np(img: np.ndarray, size: int) -> np.ndarray:
    """HWC float in [0, 1] → size × size: quantised to uint8, PIL's bilinear,
    back to float32 / 255 (the JAX package's PIL round trip)."""
    if img.shape[0] == size and img.shape[1] == size:
        return img
    u8 = np.clip(img * 255.0, 0, 255).astype(np.uint8)
    return np.asarray(resize(u8, size, size, "bilinear"), dtype=np.float32) / 255.0


def random_resized_crop(rng: np.random.Generator, img: np.ndarray, size: int,
                        scale=(0.3, 1.0)) -> np.ndarray:
    """torchvision RandomResizedCrop semantics (area-scale crop → resize),
    plus a random horizontal flip."""
    h, w = img.shape[:2]
    area = h * w
    for _ in range(10):
        target = rng.uniform(*scale) * area
        ar = math.exp(rng.uniform(math.log(3 / 4), math.log(4 / 3)))
        ch = int(round(math.sqrt(target / ar)))
        cw = int(round(math.sqrt(target * ar)))
        if ch <= h and cw <= w and ch > 0 and cw > 0:
            top = rng.integers(0, h - ch + 1)
            left = rng.integers(0, w - cw + 1)
            crop = img[top:top + ch, left:left + cw]
            break
    else:
        crop = img
    out = _resize_np(crop, size)
    if rng.random() < 0.5:
        out = out[:, ::-1]
    return np.ascontiguousarray(out)


def multicrop_views(rng: np.random.Generator, img: np.ndarray, *,
                    rand_size: int, focal_size: int,
                    rand_views: int, focal_views: int) -> dict[str, np.ndarray]:
    """1 target view + ``rand_views`` anchor views at rand_size +
    ``focal_views`` crops of scale 0.05-0.3 at focal_size (the target is
    the first rand view)."""
    target = random_resized_crop(rng, img, rand_size)
    anchors = np.stack([random_resized_crop(rng, img, rand_size) for _ in range(rand_views)])
    focals = (
        np.stack([random_resized_crop(rng, img, focal_size, scale=(0.05, 0.3))
                  for _ in range(focal_views)])
        if focal_views else np.zeros((0, focal_size, focal_size, 3), np.float32)
    )
    return {"target": target, "anchors": anchors, "focals": focals}


# ----------------------------------------------------------------------
# native encoder checkpoints (what get_ssl_backbone's .msgpack path reads)
# ----------------------------------------------------------------------

def save_encoder_ckpt(path: str | Path, encoder_state: dict[str, torch.Tensor],
                      meta: dict) -> None:
    """A `VisionTransformer` state dict as flax's msgpack bytes (the JAX
    package's ``save_encoder_ckpt`` on the same weights, byte for byte) and
    ``<path>.json`` with ``meta``."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(pack_params(vit_to_flax(encoder_state)))
    Path(str(path) + ".json").write_text(json.dumps(meta))


def load_encoder_ckpt(path: str | Path, model: torch.nn.Module | None = None
                      ) -> dict[str, torch.Tensor]:
    """A ``.msgpack`` encoder (either package's) as the port's ViT state dict,
    checked against ``model`` when given."""
    return vit_from_flax(unpack_params(Path(path).read_bytes()), model)

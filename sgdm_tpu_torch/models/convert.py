"""Weight bridge from a flax param tree to a `state_dict`.

``from_flax(flat)`` takes the tree flattened with ``/``-joined paths (for
example ``backbone/down_0_0/in_conv/kernel``; a leading ``params/`` is
dropped) and returns the torch `state_dict` of the port's module with the
same names:

  * conv ``kernel`` HWIO → ``weight`` OIHW,
  * dense ``kernel`` [in, out] → ``weight`` [out, in],
  * GroupNorm ``scale`` → ``weight``, ``bias`` as it is,
  * embedding ``embedding`` → ``weight``.

Values stay float32; the modules cast them to the compute dtype at use, as
flax does.  Given ``model``, every leaf must map to one of its parameters
with the right shape and every parameter must be covered: a leaf left over
or a parameter missing raises.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

__all__ = ["from_flax", "flax_key_to_torch"]

_LEAF = {"kernel": "weight", "scale": "weight", "embedding": "weight", "bias": "bias"}


def flax_key_to_torch(path: str) -> str:
    parts = path.split("/")
    if parts[0] == "params":
        parts = parts[1:]
    if parts[-1] not in _LEAF:
        raise KeyError(f"unknown flax leaf {path!r}")
    return ".".join(parts[:-1] + [_LEAF[parts[-1]]])


def _to_torch_layout(leaf: str, value: np.ndarray) -> np.ndarray:
    if leaf == "kernel" and value.ndim == 4:
        return value.transpose(3, 2, 0, 1)
    if leaf == "kernel" and value.ndim == 2:
        return value.T
    return value


def from_flax(flat: Mapping[str, np.ndarray],
              model: torch.nn.Module | None = None) -> dict[str, torch.Tensor]:
    """Flattened flax params → `state_dict` (checked against ``model`` if given)."""
    state: dict[str, torch.Tensor] = {}
    for path, value in flat.items():
        key = flax_key_to_torch(path)
        if key in state:
            raise KeyError(f"two flax leaves map to {key!r}")
        arr = _to_torch_layout(path.rsplit("/", 1)[-1], np.asarray(value, dtype=np.float32))
        state[key] = torch.from_numpy(np.ascontiguousarray(arr))
    if model is not None:
        want = model.state_dict()
        extra = sorted(set(state) - set(want))
        missing = sorted(set(want) - set(state))
        if extra or missing:
            raise KeyError(f"flax leaves left over: {extra}; parameters missing: {missing}")
        for key, t in state.items():
            if tuple(t.shape) != tuple(want[key].shape):
                raise ValueError(f"{key}: flax shape {tuple(t.shape)} != "
                                 f"torch shape {tuple(want[key].shape)}")
    return state

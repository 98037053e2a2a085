"""Weight bridge from a flax param tree to a `state_dict`.

``from_flax(flat)`` takes the tree flattened with ``/``-joined paths (for
example ``backbone/down_0_0/in_conv/kernel``; a leading ``params/`` is
dropped) and returns the torch `state_dict` of the port's module with the
same names:

  * conv ``kernel`` HWIO → ``weight`` OIHW,
  * dense ``kernel`` [in, out] → ``weight`` [out, in],
  * GroupNorm and LayerNorm ``scale`` → ``weight``, ``bias`` as it is,
  * embedding ``embedding`` → ``weight``,
  * `AttentionLR`'s ``gamma`` (its gamma-only LayerNorms) and ``null_kv``
    keep their names.

Values stay float32; the modules cast them to the compute dtype at use, as
flax does.  Given ``model``, every leaf must map to one of its parameters
with the right shape and every parameter must be covered: a leaf left over
or a parameter missing raises.  `to_flax` is the inverse.

The JAX package's `EncoderUNetModel` (either pool: ``out_norm`` +
zero-init ``out``, or ``spatial_fc`` + ``out``) takes `from_flax` with the
port's encoder as ``model``; `to_flax` of its `state_dict` gives the tree
back, which `utils/msgpack.py pack_params` writes as flax's ``to_bytes``
does.

`inception_from_flax` carries the JAX package's `FIDInceptionV3` params
(`sgdm_tpu/eval/inception.py`) to the port's `eval.inception` module, and
`noise_schedule_from_flax` a `LearnedNoiseSchedule`'s (``l0`` / ``l1`` /
``l2`` kernel and bias, `sgdm_tpu/diffusion/samplers/continuous.py`) to
the port's module of that name.

`vit_from_flax` carries the JAX package's `VisionTransformer` params
(`sgdm_tpu/models/vit.py`: ``blocks_{i}/attn/qkv/kernel`` …) to the port's
`models.vit.VisionTransformer`, whose names are torch.hub DINO's
(``blocks.{i}.attn.qkv.weight`` …): the layout map of the JAX package's
``load_dino_torch_weights`` run backwards.  `load_dino_torch_weights`
reads a torch.hub DINO checkpoint (a ``state_dict``, possibly under
``"state_dict"`` and with ``module.`` prefixes) as the port's state dict.

`resnet_from_flax`, `xcit_from_flax` and `stego_from_flax` carry the JAX
package's `ResNet50` (``stem``, ``layer{s}_{i}/conv{j}`` with folded
``bn_scale`` / ``bn_bias``), `XCiT` (``patch_embed/conv{i}``, ``block{i}``,
``cls_block{i}``, ``lpi``, ``pos_proj``) and STEGO `DinoFeaturizer`
(``backbone``, ``cluster1``, ``cluster2_1``, ``cluster2_2``) params to the
port's modules under their torch names.  A folded BatchNorm becomes one
whose running mean is 0 and running variance 1 − 1e-5, so the port's
`FrozenBN` (eps 1e-5) applies the same scale and bias up to rounding.

`vdiff_from_flax`, `clip_from_flax` and `zoo_from_flax` carry the JAX
package's v-diffusion nets (`sgdm_tpu/models/zoo_vdiff.py`: ``net_{i}_main_0``
…, through the same key map as the published ``.pth`` files), its CLIP
(``visual/resblocks_{i}/attn/in_proj`` …, to OpenAI's names) and its zoo
UNets (`VDMUNet`, `DDPMUNet`: a level's attention, flax's
``_LinearAttention_{k}`` / ``_Attention_0``, under ``<level>_attn.fn``; a
transposed conv's kernel flipped, as flax's ``ConvTranspose`` does not) to
the port's modules.  `LatentFC` takes `from_flax` as it is.

`train_state_from_flax` carries a whole JAX ``TrainState`` across: the
step, params and ema_params, optax.adamw's ``mu`` / ``nu`` (the same leaf
mapping) and counts, and LitEma's ``ema_updates``, given as the mapping

    {"step", "count", "schedule_count", "ema_updates": ints,
     "params", "ema_params", "mu", "nu": '/'-flattened trees}

(``count``, ``mu``, ``nu`` from ``opt_state[0]``, ``schedule_count`` from
``opt_state[2].count``).  `train_state_to_flax` gives the same mapping back.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from ..device import resolve_device
from ..training.optim import OptState
from ..training.state import TrainState, bind_params

__all__ = ["from_flax", "to_flax", "flax_key_to_torch", "train_state_from_flax",
           "train_state_to_flax", "inception_from_flax", "noise_schedule_from_flax",
           "vit_from_flax", "load_dino_torch_weights", "dino_state", "resnet_from_flax",
           "xcit_from_flax", "stego_from_flax", "vdiff_from_flax", "clip_from_flax",
           "zoo_from_flax"]

_LEAF = {"kernel": "weight", "scale": "weight", "embedding": "weight", "bias": "bias",
         "gamma": "gamma", "null_kv": "null_kv"}


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
        arr = _to_torch_layout(path.rsplit("/", 1)[-1], np.array(value, dtype=np.float32))
        state[key] = torch.from_numpy(np.ascontiguousarray(arr))
    if model is not None:
        _check_covers(state, model)
    return state


def _check_covers(state: Mapping[str, torch.Tensor], model: torch.nn.Module) -> None:
    """Every parameter of ``model`` once, with its shape, and nothing else."""
    want = model.state_dict()
    extra = sorted(set(state) - set(want))
    missing = sorted(set(want) - set(state))
    if extra or missing:
        raise KeyError(f"flax leaves left over: {extra}; parameters missing: {missing}")
    for key, t in state.items():
        if tuple(t.shape) != tuple(want[key].shape):
            raise ValueError(f"{key}: flax shape {tuple(t.shape)} != "
                             f"torch shape {tuple(want[key].shape)}")


def vit_from_flax(flat: Mapping[str, np.ndarray],
                  model: torch.nn.Module | None = None) -> dict[str, torch.Tensor]:
    """Flattened flax `VisionTransformer` params → the port's ViT `state_dict`
    (checked against ``model`` if given): ``blocks_{i}`` → ``blocks.{i}``,
    ``patch_embed`` → ``patch_embed.proj``, ``cls_token`` and ``pos_embed``
    as they are, the leaves as `from_flax` maps them."""
    state: dict[str, torch.Tensor] = {}
    for path, value in flat.items():
        parts = path.split("/")
        if parts[0] == "params":
            parts = parts[1:]
        arr = np.array(value, dtype=np.float32)
        if parts in (["cls_token"], ["pos_embed"]):
            key = parts[0]
        else:
            if parts[0].startswith("blocks_"):
                parts = ["blocks", parts[0][len("blocks_"):]] + parts[1:]
            elif parts[0] == "patch_embed":
                parts = ["patch_embed", "proj"] + parts[1:]
            key = flax_key_to_torch("/".join(parts))
            arr = _to_torch_layout(parts[-1], arr)
        if key in state:
            raise KeyError(f"two flax leaves map to {key!r}")
        state[key] = torch.from_numpy(np.ascontiguousarray(arr))
    if model is not None:
        _check_covers(state, model)
    return state


def dino_state(sd: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """A DINO ViT state dict (possibly under ``"state_dict"``, with
    ``module.`` prefixes) as the port's ViT `state_dict`."""
    if "state_dict" in sd:
        sd = sd["state_dict"]
    return {k.replace("module.", ""): v for k, v in sd.items()}


def load_dino_torch_weights(path: str) -> dict[str, torch.Tensor]:
    """A torch.hub DINO ViT checkpoint as the port's ViT `state_dict`."""
    return dino_state(torch.load(path, map_location="cpu", weights_only=True))


def _tensor(arr: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.array(arr, dtype=np.float32)))


def _folded_bn(prefix: str, scale: np.ndarray, bias: np.ndarray) -> dict[str, torch.Tensor]:
    """A folded BN (y = x·scale + bias) as a BatchNorm's state."""
    n = len(scale)
    return {f"{prefix}.weight": _tensor(scale), f"{prefix}.bias": _tensor(bias),
            f"{prefix}.running_mean": torch.zeros(n),
            f"{prefix}.running_var": torch.full((n,), 1.0 - 1e-5),
            f"{prefix}.num_batches_tracked": torch.tensor(0)}


def _flat_parts(flat: Mapping[str, np.ndarray]):
    for path, value in flat.items():
        parts = path.split("/")
        yield (parts[1:] if parts[0] == "params" else parts), value


def _finish(state: dict, model: torch.nn.Module | None) -> dict[str, torch.Tensor]:
    if model is not None:
        _check_covers(state, model)
    return state


def resnet_from_flax(flat: Mapping[str, np.ndarray],
                     model: torch.nn.Module | None = None) -> dict[str, torch.Tensor]:
    """Flattened flax `ResNet50` params → the port's ResNet `state_dict`."""
    convbn: dict[str, dict] = {}
    for parts, value in _flat_parts(flat):
        owner, leaf = "/".join(parts[:-1]), parts[-1]
        if leaf == "kernel":
            owner = owner[:-len("/conv")]
        convbn.setdefault(owner, {})[leaf] = value
    state: dict[str, torch.Tensor] = {}
    for owner, leaves in convbn.items():
        if owner == "stem":
            conv, bn = "conv1", "bn1"
        else:
            block, *sub = owner.split("/")
            stage, i = block[len("layer"):].split("_")
            pre = f"layer{stage}.{i}"
            if sub == ["downsample"]:
                conv, bn = f"{pre}.downsample.0", f"{pre}.downsample.1"
            else:
                conv, bn = f"{pre}.{sub[0]}", f"{pre}.bn{sub[0][len('conv'):]}"
        state[f"{conv}.weight"] = _tensor(np.asarray(leaves["kernel"]).transpose(3, 2, 0, 1))
        state.update(_folded_bn(bn, leaves["bn_scale"], leaves["bn_bias"]))
    return _finish(state, model)


def xcit_from_flax(flat: Mapping[str, np.ndarray],
                   model: torch.nn.Module | None = None) -> dict[str, torch.Tensor]:
    """Flattened flax `XCiT` params → the port's XCiT `state_dict`."""
    state: dict[str, torch.Tensor] = {}
    bns: dict[str, dict] = {}
    for (*path, leaf), value in _flat_parts(flat):
        if path[:1] == ["patch_embed"]:                       # conv{i} / bn{i}
            path = ["patch_embed", "proj", str(2 * int(path[1][-1])),
                    "0" if path[1].startswith("conv") else "1"]
        elif path == ["pos_proj"]:
            path = ["pos_embeder", "token_projection"]
        elif path and path[0].startswith("cls_block"):
            path = ["cls_attn_blocks", path[0][len("cls_block"):], *path[1:]]
        elif path and path[0].startswith("block"):
            path = ["blocks", path[0][len("block"):], *path[1:]]
        path = ["local_mp" if p == "lpi" else p for p in path]
        owner = ".".join(path)
        if path and (path[-1] == "bn" or path[0] == "patch_embed" and path[-1] == "1"):
            bns.setdefault(owner, {})[leaf] = value
            continue
        arr = _to_torch_layout(leaf, np.asarray(value, dtype=np.float32))
        name = {"kernel": "weight", "scale": "weight"}.get(leaf, leaf)
        state[f"{owner}.{name}" if owner else name] = _tensor(arr)
    for owner, leaves in bns.items():
        state.update(_folded_bn(owner, leaves["scale"], leaves["bias"]))
    return _finish(state, model)


def stego_from_flax(flat: Mapping[str, np.ndarray],
                    model: torch.nn.Module | None = None) -> dict[str, torch.Tensor]:
    """Flattened flax STEGO `DinoFeaturizer` params → the port's
    `selfsup.stego.DinoFeaturizer` `state_dict` (the STEGO checkpoint's
    ``net.*`` names: ``model``, ``cluster1.0``, ``cluster2.0``, ``cluster2.2``)."""
    trunk, state = {}, {}
    heads = {"cluster1": "cluster1.0", "cluster2_1": "cluster2.0", "cluster2_2": "cluster2.2"}
    for parts, value in _flat_parts(flat):
        if parts[0] == "backbone":
            trunk["/".join(parts[1:])] = value
        else:
            arr = _to_torch_layout(parts[-1], np.asarray(value, dtype=np.float32))
            state[f"{heads[parts[0]]}.{_LEAF[parts[-1]]}"] = _tensor(arr)
    state.update({f"model.{k}": v for k, v in vit_from_flax(trunk).items()})
    return _finish(state, model)


def _flax_leaf(model: torch.nn.Module, key: str) -> str:
    owner, _, leaf = key.rpartition(".")
    if leaf in ("bias", "gamma", "null_kv"):
        return leaf
    mod = model.get_submodule(owner)
    if isinstance(mod, torch.nn.Embedding):
        return "embedding"
    return "kernel" if mod.weight.ndim > 1 else "scale"


def to_flax(state: Mapping[str, torch.Tensor], model: torch.nn.Module) -> dict[str, np.ndarray]:
    """A `state_dict` of ``model`` → the flattened flax tree (inverse of `from_flax`)."""
    flat = {}
    for key, t in state.items():
        leaf = _flax_leaf(model, key)
        arr = t.detach().cpu().float().numpy()
        if leaf == "kernel":
            arr = arr.transpose(2, 3, 1, 0) if arr.ndim == 4 else arr.T
        flat["/".join(key.split(".")[:-1] + [leaf])] = np.ascontiguousarray(arr)
    return flat


_TREES = ("params", "ema_params", "mu", "nu")
_COUNTS = ("step", "count", "schedule_count", "ema_updates")


def train_state_from_flax(tree: Mapping, model: torch.nn.Module,
                          device: str | torch.device = "cuda"):
    """The port's `TrainState` (bound to ``model``) from a JAX TrainState mapping."""
    dev = resolve_device(device)
    missing = [k for k in _TREES + _COUNTS if k not in tree]
    extra = [k for k in tree if k not in _TREES + _COUNTS]
    if missing or extra:
        raise KeyError(f"train state entries missing: {missing}; left over: {extra}")
    names = [name for name, _ in model.named_parameters()]
    flats = {}
    for key in _TREES:
        sd = from_flax(tree[key], model)
        flats[key] = torch.cat([sd[n].reshape(-1) for n in names]).to(dev)
    layout = tuple((n, tuple(p.shape)) for n, p in model.named_parameters())
    state = TrainState(int(tree["step"]), flats["params"], flats["ema_params"],
                       OptState(int(tree["count"]), flats["mu"], flats["nu"],
                                int(tree["schedule_count"])),
                       int(tree["ema_updates"]), layout)
    model.to(dev)
    bind_params(model, state.params, state)
    return state


def train_state_to_flax(state, model: torch.nn.Module) -> dict:
    """The JAX TrainState mapping of `train_state_from_flax` from a port `TrainState`."""
    o = state.opt_state
    out = {"step": state.step, "count": o.count, "schedule_count": o.schedule_count,
           "ema_updates": state.ema_updates}
    for key, flat in zip(_TREES, (state.params, state.ema_params, o.mu, o.nu)):
        out[key] = to_flax(state.unflatten(flat), model)
    return out


def _flatten(tree: Mapping, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        out.update(_flatten(v, path) if isinstance(v, Mapping) else {path: v})
    return out


def inception_from_flax(params: Mapping) -> dict[str, torch.Tensor]:
    """A flax `FIDInceptionV3` param tree (nested, or flattened with ``/``)
    → the `state_dict` of the port's `eval.inception.FIDInceptionV3`: conv
    ``kernel`` HWIO → ``weight`` OIHW, ``fc/kernel`` [in, out] → ``fc.weight``
    [out, in]; ``bn_scale``, ``bn_bias`` and ``fc/bias`` keep their names."""
    state: dict[str, torch.Tensor] = {}
    for path, value in _flatten(params).items():
        parts = path.split("/")
        if parts[0] == "params":
            parts = parts[1:]
        arr = np.array(value, dtype=np.float32)
        if parts[-1] == "kernel":
            arr = arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr.T
            parts[-1] = "weight"
        elif parts[-1] not in ("bias", "bn_scale", "bn_bias"):
            raise KeyError(f"unknown FID Inception leaf {path!r}")
        state[".".join(parts)] = torch.from_numpy(np.ascontiguousarray(arr))
    return state


def noise_schedule_from_flax(params: Mapping,
                             model: torch.nn.Module | None = None) -> dict[str, torch.Tensor]:
    """A flax `LearnedNoiseSchedule` param tree (nested, or flattened with
    ``/``) → the `state_dict` of the port's
    `diffusion.samplers.continuous.LearnedNoiseSchedule`: each dense
    ``kernel`` [in, out] → ``weight`` [out, in], ``bias`` as it is (checked
    against ``model`` if given)."""
    return from_flax(_flatten(params), model)


def vdiff_from_flax(flat: Mapping[str, np.ndarray], name: str,
                    model: torch.nn.Module | None = None) -> dict[str, torch.Tensor]:
    """Flattened flax `VDiffUNet` params of zoo entry ``name`` (or a
    `_NetCfg`) → the port's `VDiffUNet` `state_dict`, the published keys."""
    from .zoo_vdiff import _MODELS, _iter_params

    cfg = _MODELS[name] if isinstance(name, str) else name
    leaves = {"/".join(parts): v for parts, v in _flat_parts(flat)}
    state = {}
    for tk, fn, leaf, kind, shape in _iter_params(cfg):
        w = np.asarray(leaves.pop(fn if leaf is None else f"{fn}/{leaf}"), np.float32)
        if w.shape != shape:
            raise ValueError(f"{tk}: flax shape {w.shape} != {shape}")
        state[tk] = _tensor(w.transpose(3, 2, 0, 1) if kind == "conv"
                            else w.T if kind == "dense" else w)
    if leaves:
        raise KeyError(f"flax leaves left over: {sorted(leaves)[:4]}")
    return _finish(state, model)


def clip_from_flax(flat: Mapping[str, np.ndarray],
                   model: torch.nn.Module | None = None) -> dict[str, torch.Tensor]:
    """Flattened flax `CLIP` params → the port's `CLIP` `state_dict` (OpenAI's
    names): ``visual/…`` → ``visual.…``, ``text/…`` → the top level,
    ``resblocks_{i}`` → ``transformer.resblocks.{i}``, ``attn/in_proj`` →
    ``attn.in_proj_weight`` / ``_bias``, ``c_fc`` / ``c_proj`` under ``mlp``."""
    state = {}
    for parts, value in _flat_parts(flat):
        tower, *path, leaf = parts
        arr = np.asarray(value, np.float32)
        path = [p for q in path for p in (["transformer", "resblocks", q[len("resblocks_"):]]
                                          if q.startswith("resblocks_") else
                                          ["mlp", q] if q in ("c_fc", "c_proj") else [q])]
        if path[-1:] == ["in_proj"]:
            path, leaf = path[:-1], f"in_proj_{'weight' if leaf == 'kernel' else 'bias'}"
            arr = arr.T if arr.ndim == 2 else arr
        elif leaf in _LEAF and path:
            arr = _to_torch_layout(leaf, arr)
            leaf = _LEAF[leaf]
        elif leaf == "token_embedding":
            leaf = "token_embedding.weight"
        key = ".".join((["visual"] if tower == "visual" else []) + path + [leaf])
        state[key] = _tensor(arr)
    return _finish(state, model)


def zoo_from_flax(flat: Mapping[str, np.ndarray], model: torch.nn.Module
                  ) -> dict[str, torch.Tensor]:
    """Flattened flax `VDMUNet` / `DDPMUNet` params → the `state_dict` of the
    port's ``model`` (needed for the level count and the transposed convs)."""
    levels = len(model.in_out)
    state = {}
    for parts, value in _flat_parts(flat):
        *path, leaf = parts
        head = path[0] if path else ""
        if head.startswith("_LinearAttention_"):
            k = int(head.rsplit("_", 1)[1])
            path = [f"down_{k}_attn" if k < levels else f"up_{k - levels}_attn", "fn",
                    *path[1:]]
        elif head == "_Attention_0":
            path = ["mid_attn", "fn", *path[1:]]
        arr = np.asarray(value, np.float32)
        owner = ".".join(path)
        if leaf == "kernel" and isinstance(model.get_submodule(owner), torch.nn.ConvTranspose2d):
            arr = arr[::-1, ::-1].transpose(2, 3, 0, 1)      # HWIO, unflipped → IOHW, flipped
        elif leaf in ("kernel", "scale"):
            arr = _to_torch_layout(leaf, arr)
        key = ".".join(path + [_LEAF.get(leaf, leaf)])
        state[key] = _tensor(arr)
    return _finish(state, model)

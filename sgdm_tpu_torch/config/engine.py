"""Hydra-compatible configuration engine.

The port's copy of `sgdm_tpu/config/engine.py`: a ``defaults:`` list of
config groups, group overrides (``data=synthetic32``), dotted value
overrides (``sg.params.cond_scale=2``), additive (``+vis.chainvis=1``) and
deleting (``~exp.condmix``) overrides, ``${a.b.c}`` interpolation resolved
after every merge, and ``target:`` / ``params:`` instantiation.  Two
changes:

  * **PyYAML is optional.**  Only `compose`, which reads the ``configs/``
    YAML tree, needs it.  A config composed elsewhere and written as JSON
    (`compose_unresolved` → `save_config`) loads with `load_config`, which
    takes the same value overrides and resolves after them, exactly as
    `compose` would have.  Override values parse with PyYAML where it is
    importable (Hydra's rule); without it, as JSON, else as the bare string
    (`parse_value`).  The two rules agree on numbers with a decimal point,
    integers, ``true``/``false``/``null``, lists and plain words; they
    differ on YAML-only spellings (``1e-4`` is a string to PyYAML, a
    float to JSON; ``yes``/``on``/``~``), which the port's documented
    overrides do not use.
  * **Targets.**  The YAML tree names ``sgdm_tpu.…`` targets;
    `get_obj_from_str` reads the prefix ``sgdm_tpu.`` as
    ``sgdm_tpu_torch.`` and never imports the JAX package.  A target the
    port does not have yet raises `ImportError` naming the module and the
    ROADMAP item that ports it.
"""

from __future__ import annotations

import copy
import importlib
import json
import re
from pathlib import Path
from typing import Any, Iterable

__all__ = [
    "Config",
    "compose",
    "compose_unresolved",
    "load_config",
    "save_config",
    "apply_overrides",
    "parse_value",
    "resolve",
    "instantiate_from_config",
    "get_obj_from_str",
    "to_container",
]


class Config(dict):
    """A dict with attribute access and recursive wrapping (OmegaConf-lite)."""

    def __init__(self, data: dict | None = None):
        super().__init__()
        if data:
            for k, v in data.items():
                self[k] = v

    @staticmethod
    def _wrap(value: Any) -> Any:
        if isinstance(value, Config):
            return value
        if isinstance(value, dict):
            return Config(value)
        if isinstance(value, (list, tuple)):
            return [Config._wrap(v) for v in value]
        return value

    def __setitem__(self, key: str, value: Any) -> None:
        super().__setitem__(key, Config._wrap(value))

    def __setattr__(self, key: str, value: Any) -> None:
        self[key] = value

    def __getattr__(self, key: str) -> Any:
        try:
            return self[key]
        except KeyError as e:
            raise AttributeError(key) from e

    def __deepcopy__(self, memo: dict) -> "Config":
        return Config({k: copy.deepcopy(v, memo) for k, v in self.items()})

    def select(self, path: str, default: Any = None) -> Any:
        node: Any = self
        for part in path.split("."):
            if isinstance(node, Config) and part in node:
                node = node[part]
            else:
                return default
        return node

    def set_path(self, path: str, value: Any, *, create: bool = True) -> None:
        parts = path.split(".")
        node = self
        for part in parts[:-1]:
            if part not in node:
                if not create:
                    raise KeyError(f"config path '{path}' does not exist")
                node[part] = Config()
            node = node[part]
            if not isinstance(node, Config):
                raise TypeError(f"cannot descend into non-dict at '{part}' of '{path}'")
        if not create and parts[-1] not in node:
            raise KeyError(
                f"Could not override '{path}': key does not exist. "
                f"Prefix the override with '+' to add it."
            )
        node[parts[-1]] = value

    def delete_path(self, path: str) -> None:
        parts = path.split(".")
        node = self
        for part in parts[:-1]:
            node = node[part]
        del node[parts[-1]]

    def get(self, key, default=None):
        return super().get(key, default)


def to_container(node: Any) -> Any:
    """Recursively convert ``Config`` to plain dicts/lists."""
    if isinstance(node, Config):
        return {k: to_container(v) for k, v in node.items()}
    if isinstance(node, list):
        return [to_container(v) for v in node]
    return node


def merge_into(dst: Config, src: dict) -> Config:
    """Deep-merge ``src`` into ``dst`` (src wins; dicts merge recursively)."""
    for k, v in src.items():
        if k in dst and isinstance(dst[k], Config) and isinstance(v, dict):
            merge_into(dst[k], v)
        else:
            dst[k] = v
    return dst


# ----------------------------------------------------------------------
# interpolation
# ----------------------------------------------------------------------

_INTERP_RE = re.compile(r"\$\{([^${}]+)\}")


def _resolve_node(root: Config, value: Any, stack: tuple[str, ...]) -> Any:
    if isinstance(value, str):
        full = _INTERP_RE.fullmatch(value.strip())
        if full:  # whole-string interpolation keeps the referent's type
            return _lookup(root, full.group(1).strip(), stack)

        def sub(m: re.Match) -> str:
            return str(_lookup(root, m.group(1).strip(), stack))

        return _INTERP_RE.sub(sub, value) if "${" in value else value
    return value


def _lookup(root: Config, path: str, stack: tuple[str, ...]) -> Any:
    if path in stack:
        raise ValueError(f"interpolation cycle through '{path}'")
    node: Any = root
    for part in path.split("."):
        if isinstance(node, Config) and part in node:
            node = node[part]
        else:
            raise KeyError(f"interpolation key '{path}' not found")
    return _deep_resolve(root, node, stack + (path,))


def _deep_resolve(root: Config, node: Any, stack: tuple[str, ...] = ()) -> Any:
    if isinstance(node, Config):
        out = Config()
        for k, v in node.items():
            out[k] = _deep_resolve(root, v, stack)
        return out
    if isinstance(node, list):
        return [_deep_resolve(root, v, stack) for v in node]
    return _resolve_node(root, node, stack)


def resolve(cfg: Config) -> Config:
    """Resolve all ``${...}`` interpolations against the config root."""
    return _deep_resolve(cfg, cfg)


# ----------------------------------------------------------------------
# overrides
# ----------------------------------------------------------------------

def _load_yaml(path: Path) -> dict:
    import yaml

    with open(path) as f:
        data = yaml.safe_load(f)
    return data or {}


def parse_value(text: str) -> Any:
    """An override value: YAML semantics (Hydra's) where PyYAML is
    importable, else JSON, else the bare string."""
    if text == "":
        return ""
    try:
        import yaml
    except ImportError:
        try:
            return json.loads(text)
        except ValueError:
            return text
    try:
        return yaml.safe_load(text)
    except yaml.YAMLError:
        return text


def _split_override(ov: str) -> tuple[str, str]:
    if "=" not in ov:
        raise ValueError(f"override '{ov}' must look like key=value (or ~key)")
    key, value = ov.split("=", 1)
    return key.strip(), value


def _parse_overrides(overrides: Iterable[str], is_group):
    """(group choices, value overrides as (mode, key, value)) in order."""
    groups: list[tuple[str, str]] = []
    values: list[tuple[str, str, Any]] = []
    for ov in overrides:
        ov = ov.strip()
        if not ov:
            continue
        if ov.startswith("~"):
            values.append(("del", ov[1:].split("=", 1)[0], None))
            continue
        add = ov.startswith("+")
        key, raw = _split_override(ov[1:] if add else ov)
        if not add and is_group(key, raw):
            groups.append((key, str(parse_value(raw))))
        else:
            values.append(("add" if add else "set", key, parse_value(raw)))
    return groups, values


def _apply_values(cfg: Config, values: list[tuple[str, str, Any]]) -> Config:
    for mode, key, value in values:
        if mode == "del":
            cfg.delete_path(key)
        elif mode == "add":
            cfg.set_path(key, value, create=True)
        else:
            try:
                cfg.set_path(key, value, create=False)
            except KeyError:
                # Hydra allows overriding keys nested in freshly-selected
                # groups; keep strictness for obvious typos at the top level.
                if cfg.select(key.rsplit(".", 1)[0]) is not None:
                    cfg.set_path(key, value, create=True)
                else:
                    raise
    return cfg


def apply_overrides(cfg: Config, overrides: Iterable[str]) -> Config:
    """Apply value overrides (``a.b=1``, ``+a.c=2``, ``~a.d``) to an
    unresolved config in place; group overrides (``data=…``) need the YAML
    tree and `compose`, and raise here."""
    groups, values = _parse_overrides(
        overrides, lambda key, raw: "." not in key and isinstance(cfg.get(key), Config))
    if groups:
        raise ValueError(f"group override '{groups[0][0]}={groups[0][1]}' needs the configs/ "
                         f"YAML tree: compose the config with it (--save-config) or set the "
                         f"group's keys one by one")
    return _apply_values(cfg, values)


# ----------------------------------------------------------------------
# compose
# ----------------------------------------------------------------------

def compose_unresolved(
    config_dir: str | Path,
    config_name: str = "config_base",
    overrides: Iterable[str] = (),
) -> Config:
    """`compose` before its ``${}`` resolution: what `save_config` writes,
    so that `load_config` can take further value overrides the way
    `compose` takes them."""
    config_dir = Path(config_dir)
    base = _load_yaml(config_dir / f"{config_name}.yaml")
    defaults: list = base.pop("defaults", [])

    choices: dict[str, str | None] = {}
    order: list[str] = []
    self_pos = len(defaults)
    for i, entry in enumerate(defaults):
        if entry == "_self_":
            self_pos = i
            continue
        if isinstance(entry, dict):
            (group, choice), = entry.items()
        else:
            raise ValueError(f"unsupported defaults entry: {entry!r}")
        choices[group] = choice
        order.append(group)

    def is_group(key: str, raw: str) -> bool:
        return ("." not in key and key in choices
                and (config_dir / key / f"{parse_value(raw)}.yaml").exists())

    groups, values = _parse_overrides(overrides, is_group)
    choices.update(groups)

    cfg = Config()
    merged_self = False
    for i, group in enumerate(order):
        if i == self_pos:
            merge_into(cfg, base)
            merged_self = True
        choice = choices[group]
        if choice is None:
            continue
        group_file = config_dir / group / f"{choice}.yaml"
        if not group_file.exists():
            raise FileNotFoundError(f"config group file not found: {group_file}")
        merge_into(cfg, {group: _load_yaml(group_file)})
    if not merged_self:
        merge_into(cfg, base)
    return _apply_values(cfg, values)


def compose(
    config_dir: str | Path,
    config_name: str = "config_base",
    overrides: Iterable[str] = (),
) -> Config:
    """Compose a config exactly like ``hydra.compose`` for our subset (needs
    PyYAML).  Group selection overrides (``data=cifar10``) must name a YAML
    in ``config_dir/<group>/``; everything else is a value override."""
    return resolve(compose_unresolved(config_dir, config_name, overrides))


def save_config(cfg: Config, path: str | Path) -> None:
    """Write a (resolved or unresolved) config as JSON."""
    Path(path).write_text(json.dumps(to_container(cfg), indent=2, sort_keys=True) + "\n")


def load_config(path: str | Path, overrides: Iterable[str] = ()) -> Config:
    """A JSON config (`save_config`), value overrides applied, resolved."""
    cfg = Config(json.loads(Path(path).read_text()))
    return resolve(apply_overrides(cfg, overrides))


# ----------------------------------------------------------------------
# instantiate
# ----------------------------------------------------------------------

# modules of the JAX package the port does not have yet -> the ROADMAP §1 item
# (none: the port has a counterpart of every module)
_NOT_PORTED: dict[str, int] = {}


def _roadmap_item(module: str) -> str:
    rest = module.split(".", 1)[1] if "." in module else ""
    best = max((p for p in _NOT_PORTED if rest == p or rest.startswith(p + ".")),
               key=len, default=None)
    return f"ROADMAP §1 item {_NOT_PORTED[best]}" if best else "ROADMAP §1"


def get_obj_from_str(string: str) -> Any:
    """The object a ``target`` names; ``sgdm_tpu.x.y`` reads as
    ``sgdm_tpu_torch.x.y``."""
    module, cls = string.rsplit(".", 1)
    if module == "sgdm_tpu" or module.startswith("sgdm_tpu."):
        module = "sgdm_tpu_torch" + module[len("sgdm_tpu"):]
    try:
        mod = importlib.import_module(module)
    except ModuleNotFoundError as e:
        if module.startswith("sgdm_tpu_torch.") and e.name and module.startswith(e.name):
            raise ImportError(f"target {string!r}: {module} is not ported yet "
                              f"({_roadmap_item(module)})") from e
        raise
    try:
        return getattr(mod, cls)
    except AttributeError as e:
        raise ImportError(f"target {string!r}: {module} has no {cls!r} in the port "
                          f"({_roadmap_item(module)})") from e


def instantiate_from_config(config: dict, **extra_kwargs: Any) -> Any:
    if "target" not in config:
        raise KeyError("Expected key `target` to instantiate.")
    params = dict(config.get("params") or {})
    params.update(extra_kwargs)
    return get_obj_from_str(config["target"])(**params)

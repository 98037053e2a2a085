#!/usr/bin/env python3
"""Carry a JAX training run over to the PyTorch port.

    python tools/jax_run_to_torch.py --run outputs/jax_run --out outputs/port_run

Reads the JAX run's ``config.yaml`` (the trainer's hyperparameters, as its
tracker wrote them) and writes it as ``config.json`` with ``log_dir``
pointing at ``--out``.  For each checkpoint the run's ``ckpts/meta.json``
names (``last_path``, ``best_path``) it restores the orbax `TrainState` as
a raw tree, turns it into the port's train state
(`sgdm_tpu_torch.models.convert.train_state_from_flax`: the step, params,
EMA, optax.adamw's μ / ν and counts, and ``ema_updates``) and writes it as
the port's checkpoint (`sgdm_tpu_torch.training.checkpoints`), under the
same directory name.  ``meta.json`` is rewritten for the new paths and the
stable ``last`` symlink made.  Then ``python -m sgdm_tpu_torch.generate
--run OUT`` samples it, and ``python -m sgdm_tpu_torch.main … resume_from=
OUT/ckpts/last`` trains on from it.

Runs on the CPU, beside the JAX package (it imports JAX, orbax and PyYAML;
the port itself imports none of them).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def _flatten(tree, prefix: str = "") -> dict:
    import numpy as np

    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(_flatten(v, path))
        else:
            out[path] = np.asarray(v)
    return out


def _adam_and_schedule(opt_state) -> tuple[dict, int | None]:
    """optax.adamw's ScaleByAdamState (count, mu, nu) and the schedule count
    (None with a constant lr), wherever a chain (grad_clip) nests them."""
    leaves = []

    def walk(node):
        if isinstance(node, dict):
            if {"count", "mu", "nu"} <= set(node):
                leaves.append(("adam", node))
                return
            if set(node) == {"count"}:
                leaves.append(("schedule", node))
                return
            for v in node.values():
                walk(v)
        elif isinstance(node, (list, tuple)):
            for v in node:
                walk(v)

    walk(opt_state)
    adam = [n for kind, n in leaves if kind == "adam"]
    sched = [n for kind, n in leaves if kind == "schedule"]
    if len(adam) != 1 or len(sched) > 1:
        raise ValueError(f"expected one adam state and at most one schedule count, found "
                         f"{len(adam)} and {len(sched)}")
    return adam[0], int(sched[0]["count"]) if sched else None


def convert_checkpoint(jax_ckpt: Path, model, tx, out_ckpt: Path) -> dict:
    """One orbax checkpoint → the port's checkpoint dir ``out_ckpt``;
    returns the counts carried over."""
    import numpy as np
    import orbax.checkpoint as ocp
    import torch

    from sgdm_tpu_torch.models.convert import train_state_from_flax
    from sgdm_tpu_torch.training.checkpoints import state_to_host, write_state
    from sgdm_tpu_torch.training.optim import OptState

    raw = ocp.StandardCheckpointer().restore(Path(jax_ckpt).resolve())
    adam, sched = _adam_and_schedule(raw["opt_state"])
    tree = {"step": int(np.asarray(raw["step"])), "count": int(np.asarray(adam["count"])),
            "ema_updates": int(np.asarray(raw["ema_updates"])),
            "params": _flatten(raw["params"]), "ema_params": _flatten(raw["ema_params"]),
            "mu": _flatten(adam["mu"]), "nu": _flatten(adam["nu"])}
    tree["schedule_count"] = tree["count"] if sched is None else sched
    state = train_state_from_flax(tree, model, device="cpu")
    if tx.mu_dtype != torch.float32:  # mu_dtype: bfloat16 runs keep μ in bf16
        o = state.opt_state
        state.opt_state = OptState(o.count, o.mu.to(tx.mu_dtype), o.nu, o.schedule_count)
    write_state(out_ckpt, state_to_host(state))
    return {k: tree[k] for k in ("step", "count", "schedule_count", "ema_updates")}


def convert_run(run: str | Path, out: str | Path) -> dict:
    """The whole run directory; returns {checkpoint name: counts}."""
    import yaml

    from sgdm_tpu_torch.training.trainer import SelfGuidedDiffusionTrainer

    run, out = Path(run), Path(out).absolute()
    cfg = yaml.safe_load((run / "config.yaml").read_text())
    cfg["log_dir"] = str(out)
    (out / "ckpts").mkdir(parents=True, exist_ok=True)
    (out / "config.json").write_text(json.dumps(cfg, indent=2) + "\n")
    trainer = SelfGuidedDiffusionTrainer(device="cpu", **cfg)

    meta = json.loads((run / "ckpts" / "meta.json").read_text())
    new_meta = dict(meta)
    done = {}
    for key in ("last_path", "best_path"):
        if not meta.get(key):
            continue
        src = Path(meta[key])
        dst = out / "ckpts" / src.name
        done[src.name] = convert_checkpoint(src, trainer.model, trainer.tx, dst)
        new_meta[key] = str(dst)
    (out / "ckpts" / "meta.json").write_text(json.dumps(new_meta, indent=2))
    if new_meta.get("last_path"):
        link = out / "ckpts" / "last"
        if link.is_symlink():
            link.unlink()
        if not link.exists():
            link.symlink_to(Path(new_meta["last_path"]).name)
    return done


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--run", required=True, help="the JAX run dir (config.yaml + ckpts/)")
    ap.add_argument("--out", required=True, help="the port's run dir to write")
    a = ap.parse_args(argv)
    for name, counts in convert_run(a.run, a.out).items():
        print(json.dumps({"checkpoint": name, **counts}))


if __name__ == "__main__":
    main()

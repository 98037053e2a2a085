"""Training CLI of the port, with the JAX package's override grammar.

The port's counterpart of the repo's `main.py`:

    python -m sgdm_tpu_torch.main data=synthetic32 dynamic=unet_fast \\
        sg.params.condition_method=cluster sg.params.cond_dim=10 \\
        sg.params.cond_drop_prob=0.1 sg.params.cond_scale=2 name=run1
    python -m sgdm_tpu_torch.main data=synthetic32 --save-config run1.json
    python -m sgdm_tpu_torch.main --config run1.json pl.trainer.limit_train_batches=4
    python -m sgdm_tpu_torch.main --config run1.json resume_from=outputs/run1/ckpts/last

Without ``--config`` the config is composed from ``configs/`` (needs
PyYAML).  ``--config F.json`` loads a config composed elsewhere and saved
with ``--save-config`` (which writes it unresolved, then exits), and takes
dotted value overrides on top of it as composing would have: the machine
with the card has no PyYAML.  ``--device cpu`` runs on the host; the
default is the card, and there is no fallback.

As the JAX CLI: ``debug=1`` and the unit-test shrinkage, the
``max_epochs + 1`` quirk applied before those overwrite it, ``seed``,
``resume_from=`` and ``train=0`` (restore only).  Where
``data.fid_train_image_dir`` is set this CLI raises (FID is ROADMAP §1
item 5) instead of training without best-checkpoint selection, and it ends
after ``fit``: the test phase is FID's slice.
"""

from __future__ import annotations

import argparse
import os
from pathlib import Path

from .config.engine import (Config, compose_unresolved, instantiate_from_config, load_config,
                            resolve, save_config, to_container)
from .utils.logging import logger

__all__ = ["CONFIG_DIR", "apply_debug_overrides", "run_without_decorator", "main"]

CONFIG_DIR = Path(__file__).resolve().parents[1] / "configs"


def apply_debug_overrides(cfg: Config, run_unittest: bool = False) -> Config:
    """The reference's debug / unit-test shrinkage."""
    if run_unittest:
        cfg.set_path("data.val_fid_num", 5)
        cfg.set_path("data.test_fid_num", 5)
        cfg.set_path("pl.trainer.max_epochs", 5)
        cfg.set_path("data.trainer.max_epochs", 5)
        cfg.set_path("pl.trainer.limit_train_batches", 32)
        cfg.set_path("pl.trainer.limit_val_batches", 30)
        cfg.set_path("data.params.batch_size", 16)
        cfg.set_path("data.fid_every_n_epoch", 1)
    elif cfg.select("debug"):
        cfg.set_path("data.val_fid_num", 5)
        cfg.set_path("data.test_fid_num", 5)
        cfg.set_path("pl.trainer.max_epochs", 3)
        cfg.set_path("data.trainer.max_epochs", 3)
        cfg.set_path("pl.trainer.limit_train_batches", 32)
        cfg.set_path("pl.trainer.limit_val_batches", 30)
        cfg.set_path("data.params.batch_size", 4)
        cfg.set_path("data.fid_every_n_epoch", 1)
        cfg.set_path("data.vis_every_iter", 10 ** 9)
    return cfg


def run_without_decorator(cfg: Config, run_unittest: bool = False, device: str = "cuda"):
    """Build the trainer and the data from a resolved config, then fit (or
    restore only, with ``train=0 resume_from=…``); returns the trainer."""
    # the +1 epoch is added FIRST; debug/unittest then overwrite max_epochs
    shrunk = bool(run_unittest or cfg.select("debug"))
    cfg = apply_debug_overrides(cfg, run_unittest)
    if os.environ.get("SGDM_MULTIHOST") or int(os.environ.get("WORLD_SIZE", "1")) > 1:
        raise NotImplementedError("multi-process training is ROADMAP §1 item 9")
    seed = int(cfg.select("seed", 23))
    logger.info(f"seed={seed}; device={device}")
    max_epochs = int(cfg.select("pl.trainer.max_epochs", 1)) + (0 if shrunk else 1)

    if cfg.select("data.fid_train_image_dir"):
        raise NotImplementedError(
            "data.fid_train_image_dir is set, but FID (and with it best-checkpoint selection) "
            "is not ported yet: ROADMAP §1 item 5")

    sg_params = to_container(cfg.sg.params)
    sg_params["pl"] = to_container(cfg.pl)
    sg_params["data"] = to_container(cfg.data)
    sg_params["wandb"] = to_container(cfg.select("wandb", {}))
    sg_params["seed"] = seed
    trainer = instantiate_from_config({"target": cfg.sg.target, "params": sg_params},
                                      device=device)

    data = instantiate_from_config(to_container(cfg.data))
    data.setup()
    for split, ds in data.datasets.items():
        logger.info(f"dataset[{split}]: {len(ds)} samples")

    if cfg.select("train", True):
        trainer.fit(
            data,
            max_epochs=max_epochs,
            limit_train_batches=cfg.select("pl.trainer.limit_train_batches", 1.0),
            log_every_n_steps=int(cfg.select("pl.trainer.log_every_n_steps", 50)),
            resume_from=cfg.select("resume_from"),
        )
    elif cfg.select("resume_from"):
        from .training.checkpoints import CheckpointManager
        from .utils.logging import get_tracker

        trainer.ckpt = CheckpointManager(Path(str(cfg.select("log_dir"))) / "ckpts")
        trainer.tracker = get_tracker(str(cfg.select("log_dir")))
        trainer.datamodule = data
        trainer._init_state()
        trainer.state = trainer.ckpt.restore(trainer.state, cfg.select("resume_from"))
    logger.warning("the test phase (FID, exploration) is ROADMAP §1 item 5: the port CLI "
                   "ends after fit")
    return trainer


def main(argv: list[str] | None = None):
    ap = argparse.ArgumentParser(prog="sgdm_tpu_torch.main",
                                 description="Train with the port; Hydra-style overrides.")
    ap.add_argument("--config", default=None,
                    help="a JSON config written by --save-config (default: compose configs/)")
    ap.add_argument("--save-config", default=None,
                    help="write the composed config (unresolved JSON) here and exit")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("overrides", nargs="*")
    a = ap.parse_args(argv)
    if a.config:
        if a.save_config:
            ap.error("--save-config composes from configs/; it does not take --config")
        cfg = load_config(a.config, a.overrides)
    else:
        raw = compose_unresolved(CONFIG_DIR, "config_base", a.overrides)
        if a.save_config:
            save_config(raw, a.save_config)
            logger.info(f"config written to {a.save_config}")
            return None
        cfg = resolve(raw)
    log_dir = str(cfg.select("log_dir", f"./outputs/{cfg.select('name', 'default')}"))
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    return run_without_decorator(cfg, device=a.device)


if __name__ == "__main__":
    main()

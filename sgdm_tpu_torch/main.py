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

Ranks: under torchrun (``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK``; also
what ``SGDM_MULTIHOST`` asks for) each process joins the world, on
``cuda:{LOCAL_RANK}`` over NCCL, or on the CPU over gloo with ``--device
cpu``.  Without torchrun, ``pl.trainer.devices=N`` > 1 starts N ranks
itself (`parallel.launch.spawn`: one a card over NCCL, ranks sharing the
cards over gloo when there are fewer cards than ranks, gloo ranks on the
CPU with ``--device cpu``), and the default ``--device cuda`` with
``devices`` at 1 or null starts one rank a visible card, as the JAX CLI
takes every device.  An explicit ``--device cuda:K`` or ``--device cpu``
without ``devices`` > 1 is one rank; so is ``pl.trainer.strategy=null``.

As the JAX CLI: ``debug=1`` and the unit-test shrinkage, the
``max_epochs + 1`` quirk applied before those overwrite it, ``seed``,
``resume_from=`` and ``train=0`` (restore only).  With
``data.fid_train_image_dir`` set, validation FID picks the ``best``
checkpoint (`eval.harness.make_val_fid_fn`); after ``fit`` (or the restore)
the test phase runs (`eval.harness.run_test_and_all_exploration`) unless
``profile=1``.  Unlike the JAX CLI, a failing FID evaluator fails the run
instead of being logged and dropped.
"""

from __future__ import annotations

import argparse
import os
import shutil
import tempfile
from pathlib import Path

from .config.engine import (Config, compose_unresolved, instantiate_from_config, load_config,
                            resolve, save_config, to_container)
from .eval.harness import make_val_fid_fn, run_test_and_all_exploration
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
    seed = int(cfg.select("seed", 23))
    logger.info(f"seed={seed}; device={device}")
    max_epochs = int(cfg.select("pl.trainer.max_epochs", 1)) + (0 if shrunk else 1)

    profile = bool(cfg.select("profile"))

    sg_params = to_container(cfg.sg.params)
    sg_params["pl"] = to_container(cfg.pl)
    sg_params["data"] = to_container(cfg.data)
    sg_params["wandb"] = to_container(cfg.select("wandb", {}))
    sg_params["seed"] = seed
    trainer = instantiate_from_config({"target": cfg.sg.target, "params": sg_params},
                                      device=device)
    if cfg.select("data.fid_train_image_dir"):
        trainer.set_fid_fn(make_val_fid_fn(to_container(cfg.data)))

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
        from .utils.logging import NullTracker, get_tracker

        lead = trainer.rank == 0  # only rank 0 writes
        trainer.ckpt = CheckpointManager(Path(str(cfg.select("log_dir"))) / "ckpts", writer=lead)
        trainer.tracker = get_tracker(str(cfg.select("log_dir"))) if lead else NullTracker()
        trainer.datamodule = data
        trainer._init_state()
        trainer.state = trainer.ckpt.restore(trainer.state, cfg.select("resume_from"))
    if profile:
        logger.warning("profile=1: skipping the test phase")
        return trainer
    run_test_and_all_exploration(trainer, to_container(cfg))
    return trainer


def _parse(argv: list[str] | None):
    ap = argparse.ArgumentParser(prog="sgdm_tpu_torch.main",
                                 description="Train with the port; Hydra-style overrides.")
    ap.add_argument("--config", default=None,
                    help="a JSON config written by --save-config (default: compose configs/)")
    ap.add_argument("--save-config", default=None,
                    help="write the composed config (unresolved JSON) here and exit")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("overrides", nargs="*")
    a = ap.parse_args(argv)
    if a.config and a.save_config:
        ap.error("--save-config composes from configs/; it does not take --config")
    return a


def _load(a) -> Config:
    if a.config:
        return load_config(a.config, a.overrides)
    return resolve(compose_unresolved(CONFIG_DIR, "config_base", a.overrides))


def _ranks(cfg: Config, device: str) -> int:
    """How many ranks this command starts (see the module docstring)."""
    import torch

    if cfg.select("pl.trainer.strategy", "data_parallel") != "data_parallel":
        return 1
    n = cfg.select("pl.trainer.devices")
    if isinstance(n, int) and n > 1:
        return n
    return max(torch.cuda.device_count(), 1) if device == "cuda" else 1


def _rank_main(rank: int, argv: list[str] | None, devices: list, backend: str, store: str):
    """One rank started by `main`: join the world, then train."""
    from .parallel.mesh import destroy_process_group, init_process_group

    init_process_group(devices[rank], rank=rank, world_size=len(devices),
                       init_method=f"file://{store}", backend=backend)
    try:
        run_without_decorator(_load(_parse(argv)), device=str(devices[rank]))
    finally:
        destroy_process_group()


def main(argv: list[str] | None = None):
    """The CLI.  Returns the trainer when this process trains alone; None
    when it started the ranks."""
    import sys

    import torch.distributed as dist

    argv = sys.argv[1:] if argv is None else list(argv)
    a = _parse(argv)
    if a.save_config:
        save_config(compose_unresolved(CONFIG_DIR, "config_base", a.overrides), a.save_config)
        logger.info(f"config written to {a.save_config}")
        return None
    cfg = _load(a)
    log_dir = str(cfg.select("log_dir", f"./outputs/{cfg.select('name', 'default')}"))
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    torchrun = "RANK" in os.environ and "WORLD_SIZE" in os.environ
    if os.environ.get("SGDM_MULTIHOST") and not torchrun:
        raise RuntimeError("SGDM_MULTIHOST: start the ranks with torchrun (it sets RANK, "
                           "WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and MASTER_PORT)")
    if dist.is_available() and dist.is_initialized():  # a rank of a world started elsewhere
        return run_without_decorator(cfg, device=a.device)
    if torchrun:
        from .parallel.mesh import init_process_group

        device = a.device if a.device == "cpu" else f"cuda:{int(os.environ['LOCAL_RANK'])}"
        init_process_group(device)
        return run_without_decorator(cfg, device=device)
    world = _ranks(cfg, a.device)
    if world == 1:
        return run_without_decorator(cfg, device=a.device)
    from .parallel.launch import rank_devices, spawn

    devices, backend = rank_devices(a.device, world)
    store = Path(tempfile.mkdtemp(prefix=".ranks_", dir=log_dir))  # the ranks' file store
    logger.info(f"starting {world} ranks on {a.device} over {backend}")
    try:
        spawn(_rank_main, world, (argv, devices, backend, str(store / "store")))
    finally:
        shutil.rmtree(store, ignore_errors=True)
    return None


if __name__ == "__main__":
    main()

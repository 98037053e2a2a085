"""Checkpointing: best-metric + last, resume support.

The port's counterpart of `sgdm_tpu/training/checkpoints.py`, with its
policy unchanged: the rolling 'last' checkpoint alternates between
``last-0`` and ``last-1`` beside a ``meta.json`` (``best_score``,
``best_path``, ``last_path``, ``last_epoch``, ``best_epoch``); the stable
``last`` name is a symlink swapped atomically to the durable slot; the best
(lowest) monitored score is kept as ``epoch_{epoch:06d}-fid_{score:.3f}``;
``meta.last_path`` always names a committed checkpoint.

A checkpoint is a directory holding ``state.pt``: the whole `TrainState`
(step, the flat params, EMA, μ, ν, the two optimizer counts,
``ema_updates`` and the layout) written by `torch.save` into
``<name>.tmp/`` and moved into place with `os.replace`, so a checkpoint
directory either holds a whole state or does not exist.  It loads with
``weights_only=True``.

The train step updates the state IN PLACE, so `save_last` copies every
buffer to host memory before it returns (the next step may overwrite the
device buffers at once); only the file write runs on a background thread,
which `wait_until_finished` (and every later save, `restore`,
`has_checkpoint`) joins before the meta is repointed.

Across ranks: a sharded state (FSDP, tensor parallelism) is gathered into
the one-device layout on every save, which every rank takes part in; only
the ``writer`` (rank 0) writes files.  `restore` waits at a barrier for the
writer's last save, then each rank takes its part of the one-device
layout, so a checkpoint written at any world size restores at any other.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
from pathlib import Path
from typing import Any

import torch

from ..parallel.mesh import barrier
from ..utils.logging import logger
from .optim import OptState
from .state import TrainState

__all__ = ["CheckpointManager", "state_to_host", "write_state", "read_state"]

STATE_FILE = "state.pt"


def state_to_host(state: TrainState) -> dict[str, Any]:
    """A host copy of ``state`` as `torch.save` stores it (copies even when
    the state already lies on the CPU: the train step updates it in place);
    a sharded state gathered into the one-device layout (a collective)."""
    if state.sharding is not None:
        return state.sharding.host_state(state)
    o = state.opt_state
    host = lambda t: t.detach().to("cpu", copy=True)
    return {"step": int(state.step), "params": host(state.params),
            "ema_params": host(state.ema_params), "mu": host(o.mu), "nu": host(o.nu),
            "count": int(o.count), "schedule_count": int(o.schedule_count),
            "ema_updates": int(state.ema_updates),
            "layout": [[name, list(shape)] for name, shape in state.layout]}


def write_state(path: Path, host: dict[str, Any]) -> None:
    """Write a host state into checkpoint dir ``path``: ``path.tmp/`` first,
    flushed to disk, then renamed into place."""
    path = Path(path)
    tmp = path.with_name(path.name + ".tmp")
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    with open(tmp / STATE_FILE, "wb") as f:
        torch.save(host, f)
        f.flush()
        os.fsync(f.fileno())
    if path.exists():
        shutil.rmtree(path)
    os.replace(tmp, path)


def read_state(path: str | Path) -> dict[str, Any]:
    """The stored mapping of checkpoint dir ``path`` (tensors on the CPU)."""
    return torch.load(Path(path) / STATE_FILE, map_location="cpu", weights_only=True)


def _restore_into(template: TrainState, host: dict[str, Any]) -> TrainState:
    layout = tuple((name, tuple(shape)) for name, shape in host["layout"])
    sh = template.sharding
    want = tuple(template.layout) if sh is None else sh.full_layout(template)
    if layout != want:
        raise ValueError("checkpoint layout does not match the model's parameters")
    o = template.opt_state
    if sh is not None:
        sh.load_host(host, template)
    for dst, key in (() if sh is not None else
                     ((template.params, "params"), (template.ema_params, "ema_params"),
                      (o.mu, "mu"), (o.nu, "nu"))):
        src = host[key]
        if src.dtype != dst.dtype or src.shape != dst.shape:
            raise ValueError(f"checkpoint {key}: {src.dtype} {tuple(src.shape)} != "
                             f"{dst.dtype} {tuple(dst.shape)}")
        dst.copy_(src)
    template.step = int(host["step"])
    template.ema_updates = int(host["ema_updates"])
    template.opt_state = OptState(int(host["count"]), o.mu, o.nu, int(host["schedule_count"]))
    return template


class CheckpointManager:
    """best-metric + last checkpointing (lower metric = better, like FID)."""

    def __init__(self, ckpt_dir: str | Path, monitor: str = "val/fid_for_ckpt",
                 writer: bool = True):
        """``writer`` False (every rank but 0): take part in each save's
        gather, write nothing, read what the writer wrote."""
        self.dir = Path(ckpt_dir).absolute()
        self.writer = writer
        if writer:
            self.dir.mkdir(parents=True, exist_ok=True)
        self.monitor = monitor
        self._meta_path = self.dir / "meta.json"
        self.meta: dict[str, Any] = {"best_score": None, "best_path": None, "last_path": None}
        if self._meta_path.exists():
            self.meta = json.loads(self._meta_path.read_text())
        # (path, epoch) of a 'last' save whose write may still be running
        self._pending_last: tuple[Path, int] | None = None
        self._writer: threading.Thread | None = None
        self._writer_error: BaseException | None = None

    # ------------------------------------------------------------------
    def save_last(self, state: TrainState, epoch: int) -> Path:
        """Save the rolling 'last' checkpoint.  The state is copied to host
        memory before this returns; the file write runs on a background
        thread.  Each save goes to the slot meta does not name; meta is
        repointed and the older slot deleted once the write is confirmed (at
        the next save / restore / drain), so a crash at any moment leaves
        one durable 'last' on disk."""
        self._drain()
        current = self.meta.get("last_path")
        slot = "last-1" if current and current.endswith("last-0") else "last-0"
        path = self.dir / slot
        host = state_to_host(state)
        if not self.writer:
            self.meta.update(last_path=str(path), last_epoch=epoch)
            return path
        if path.exists():  # stale unconfirmed leftover from a crash
            shutil.rmtree(path)
        for tmp in self.dir.glob(f"{slot}.tmp*"):
            shutil.rmtree(tmp)  # mid-write crash leftovers
        self._pending_last = (path, epoch)
        self._writer_error = None

        def write() -> None:
            try:
                write_state(path, host)
            except BaseException as e:  # re-raised by _drain in the caller's thread
                self._writer_error = e

        self._writer = threading.Thread(target=write, name="ckpt-writer", daemon=True)
        self._writer.start()
        return path

    def _wait_writer(self) -> None:
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        if self._writer_error is not None:
            err, self._writer_error = self._writer_error, None
            self._pending_last = None
            raise err

    def _finalize_pending_last(self) -> None:
        """Point meta at the (now durable) pending 'last'; delete the older
        one.  Callers must have joined the writer first."""
        if self._pending_last is None:
            return
        path, epoch = self._pending_last
        self._pending_last = None
        old = self.meta.get("last_path")
        self.meta["last_path"] = str(path)
        self.meta["last_epoch"] = epoch
        self._flush()
        # the stable `.../ckpts/last` name: a symlink to the durable slot,
        # swapped atomically (tmp + rename)
        link = self.dir / "last"
        if link.exists() and not link.is_symlink():
            shutil.rmtree(link)  # legacy real-dir layout
        tmp = self.dir / ".last.tmp"
        if tmp.is_symlink() or tmp.exists():
            tmp.unlink()
        tmp.symlink_to(path.name)
        tmp.replace(link)
        # clean the previous slot, never the stable symlink itself (a legacy
        # meta records last_path == '.../last', which is now the symlink)
        if (old and old != str(path) and Path(old) != link
                and Path(old).exists() and not Path(old).is_symlink()):
            shutil.rmtree(old)

    def _drain(self) -> None:
        self._wait_writer()
        self._finalize_pending_last()

    def save_best_if_improved(self, state: TrainState, epoch: int,
                              score: float) -> Path | None:
        """Keep the best (lowest) `monitor` checkpoint, named
        ``epoch_{epoch:06d}-fid_{score:.3f}``.  Blocking (rare event): the
        old best is deleted only once the new one is durable."""
        best = self.meta.get("best_score")
        if best is not None and score >= best:
            return None
        self._drain()
        path = self.dir / f"epoch_{epoch:06d}-fid_{score:.3f}"
        host = state_to_host(state)
        if not self.writer:
            self.meta.update(best_score=score, best_path=str(path), best_epoch=epoch)
            return path
        write_state(path, host)
        old = self.meta.get("best_path")
        if old and Path(old).exists() and Path(old) != path:
            shutil.rmtree(old)
        self.meta.update(best_score=score, best_path=str(path), best_epoch=epoch)
        self._flush()
        logger.warning(f"best_model_path(score:{score}): {path}")
        return path

    # ------------------------------------------------------------------
    @staticmethod
    def resolve(path: str | Path) -> Path:
        """A user-facing checkpoint path: ``.../ckpts/last`` that does not
        exist (yet) resolves through the sibling meta.json to the durable
        slot."""
        p = Path(path)
        if not p.exists():
            side = p.parent / "meta.json"
            if side.exists():
                lp = json.loads(side.read_text()).get("last_path")
                if lp and Path(lp).exists():
                    return Path(lp)
        return p

    @staticmethod
    def epoch_of(path: str | Path) -> int | None:
        """The epoch a checkpoint path was saved at, if derivable: parsed
        from the best-checkpoint name (``epoch_{N:06d}-fid_*``) or the
        sibling meta.json for last-checkpoints; None otherwise."""
        p = Path(path)
        m = re.match(r"epoch_(\d+)-fid_", p.name)
        if m:
            return int(m.group(1))
        side = p.parent / "meta.json"
        if p.name in ("last", "last-0", "last-1") and side.exists():
            le = json.loads(side.read_text()).get("last_epoch")
            return int(le) if le is not None else None
        return None

    def restore(self, state_template: TrainState, path: str | Path | None = None) -> TrainState:
        """Restore into ``state_template``'s buffers (on its device; the
        model's parameters stay views of them) and return it.  The layout,
        dtypes and shapes must match."""
        self._drain()
        barrier()  # the writer's last save is on disk
        if not self.writer and self._meta_path.exists():
            self.meta = json.loads(self._meta_path.read_text())
        path = self.resolve(path) if path else Path(self.meta["last_path"])
        return _restore_into(state_template, read_state(path.absolute()))

    def _flush(self) -> None:
        self._meta_path.write_text(json.dumps(self.meta, indent=2))

    def wait_until_finished(self) -> None:
        """Block until any in-flight save has committed (and the 'last'
        meta points at it)."""
        self._drain()

    @property
    def has_checkpoint(self) -> bool:
        self._drain()
        p = self.meta.get("last_path")
        return bool(p and Path(p).exists())

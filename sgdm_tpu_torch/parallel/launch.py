"""Starting N ranks from one process, and joining a world torchrun started.

`spawn(fn, nprocs, args, timeout)` runs ``fn(rank, *args)`` in ``nprocs``
fresh interpreters (the ``spawn`` start method: a child imports only what
``fn`` needs) and returns their results in rank order.  A rank that raises
stops every other rank at once, and the parent raises with that rank's
traceback: a rank left waiting in a collective for a peer that died would
otherwise hang.  A run still going at ``timeout`` seconds is stopped and
raises `TimeoutError`.

`rank_devices(device, world)` picks each rank's device (the CPU, or rank
r on card r mod cards) and the backend (`mesh.backend_for`).
"""

from __future__ import annotations

import multiprocessing as mp
import queue
import time
import traceback
from typing import Any, Callable, Sequence

import torch

from .mesh import backend_for

__all__ = ["spawn", "rank_devices"]


def rank_devices(device: str | torch.device, world: int) -> tuple[list[torch.device], str]:
    """(each rank's device, backend) for ``world`` ranks on ``device``'s kind."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return [dev] * world, "gloo"
    cards = torch.cuda.device_count()
    if cards == 0:
        raise RuntimeError("CUDA ranks asked for but torch.cuda.is_available() is False; "
                           "pass --device cpu to run the ranks on the host")
    devs = [torch.device("cuda", r % cards) for r in range(world)]
    return devs, backend_for(devs[0], world)


def _child(fn, rank: int, args: Sequence[Any], out) -> None:
    try:
        out.put((rank, True, fn(rank, *args)))
    except BaseException:  # noqa: BLE001 - the parent re-raises it
        out.put((rank, False, traceback.format_exc()))


def spawn(fn: Callable[..., Any], nprocs: int, args: Sequence[Any] = (),
          timeout: float | None = None) -> list[Any]:
    """``[fn(0, *args), …, fn(nprocs − 1, *args)]``, each in its own process."""
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    procs = [ctx.Process(target=_child, args=(fn, r, tuple(args), out), daemon=False)
             for r in range(nprocs)]
    for p in procs:
        p.start()
    results: dict[int, Any] = {}
    deadline = None if timeout is None else time.monotonic() + timeout
    try:
        while len(results) < nprocs:
            wait = 1.0 if deadline is None else min(1.0, deadline - time.monotonic())
            if deadline is not None and wait <= 0:
                raise TimeoutError(f"ranks {sorted(set(range(nprocs)) - set(results))} "
                                   f"still running after {timeout} s")
            try:
                r, ok, val = out.get(timeout=max(wait, 0.01))
            except queue.Empty:
                dead = [i for i, p in enumerate(procs)
                        if i not in results and not p.is_alive() and p.exitcode != 0]
                if dead:
                    # a child killed outright (e.g. by the OOM killer) posts nothing
                    raise RuntimeError(f"rank {dead[0]} exited with code "
                                       f"{procs[dead[0]].exitcode} and no result")
                continue
            if not ok:
                raise RuntimeError(f"rank {r} failed:\n{val}")
            results[r] = val
    finally:
        for p in procs:
            if p.is_alive() and len(results) < nprocs:
                p.terminate()
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
    return [results[r] for r in range(nprocs)]

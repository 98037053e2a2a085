"""Profiling utilities: the port's counterpart of `sgdm_tpu/utils/profiling.py`.

  * `trace(log_dir, device)`: a context manager around `torch.profiler`
    writing the chrome trace ``log_dir/trace.json`` of a few steps; the
    profiler it yields marks a step at every ``prof.step()``
    (`utils/trace_summary.py` reads the trace);
  * `block_timer`: the mean wall time of a call, the card synchronised;
  * `cuda_time`, `device_ms`, `device_ms_in_turns`: a call's time on the
    card by CUDA events, and its kernels' own device time by the profiler;
  * peak device memory is polled by `training.trainer._device_stats`.
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path
from typing import Callable

import torch
from torch.profiler import ProfilerAction, ProfilerActivity, profile

from ..device import resolve_device
from .logging import logger
from .trace_summary import STEP_MARK  # noqa: F401  (each step's range in the trace)

__all__ = ["trace", "block_timer", "cuda_time", "device_ms", "device_ms_in_turns"]


def _record(_step: int) -> ProfilerAction:
    return ProfilerAction.RECORD


@contextlib.contextmanager
def trace(log_dir: str | Path, device: str | torch.device = "cuda"):
    """Profile the block (CPU ops, and the card's kernels and copies when
    ``device`` is the card) and write ``log_dir/trace.json`` on exit, the
    card synchronised first.  Yields the profiler: a ``prof.step()`` between
    two steps closes one ``ProfilerStep#N`` range and opens the next (the
    first opens on entry, the last closes on exit)."""
    dev = resolve_device(device)
    out = Path(log_dir).expanduser()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    # a schedule that records every step makes the profiler mark its steps
    prof = profile(activities=acts, schedule=_record)
    prof.start()
    logger.warning(f"profiler trace → {out}")
    try:
        yield prof
    finally:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        prof.stop()
        out.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(out / "trace.json"))


def block_timer(fn: Callable, *args, iters: int = 10, warmup: int = 2, **kwargs) -> float:
    """Mean wall seconds a call over ``iters`` calls after ``warmup`` calls,
    the card synchronised after the warm-up and after the loop."""
    sync = torch.cuda.synchronize if torch.cuda.is_available() else (lambda: None)
    for _ in range(warmup):
        fn(*args, **kwargs)
    sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args, **kwargs)
    sync()
    return (time.perf_counter() - t0) / iters


def cuda_time(fn, iters: int, warmup: int = 2) -> float:
    """Mean ms per call on the card (CUDA events around ``iters`` calls)."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int) -> float:
    """Mean device time per call, ms: the self device time of every kernel that
    ``iters`` calls launch, summed by torch.profiler (``key_averages``), so
    the host's work around the launches (the Python wrapper) is out of it."""
    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # a trace now and then comes back without its device events
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total = sum(getattr(e, "self_device_time_total", 0.0) or 0.0
                    for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA)
        if total > 0:
            return total / 1e3 / iters
    raise AssertionError("the profiler saw no device time")


def device_ms_in_turns(kernel, library, iters: int) -> dict:
    """`device_ms` of a kernel and of its library call, in turns (kernel,
    library, library, kernel) in one process on one card: the means and
    each turn."""
    k1, l1 = device_ms(kernel, iters), device_ms(library, iters)
    l2, k2 = device_ms(library, iters), device_ms(kernel, iters)
    return dict(device_ms=(k1 + k2) / 2, library_device_ms=(l1 + l2) / 2,
                device_ms_turns=[k1, k2], library_device_ms_turns=[l1, l2])

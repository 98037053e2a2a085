"""Summarise a `torch.profiler` chrome trace: device time by category and the
top kernels by accumulated time.  The port's counterpart of
`sgdm_tpu/utils/trace_summary.py`.

Usage:
  python -m sgdm_tpu_torch.utils.trace_summary outputs/<run>/profile [top_n]

Reads the ``trace.json`` that `utils/profiling.trace` writes (the trainer's
``profile=1`` runs), with nothing but `json`: no TensorBoard.  Prints the
device, its steps and ms a step from the step marks (``ProfilerStep#N``:
their device spans where the trace has them, else their host spans), device
time by category in ms total and ms a step, the top kernels, and the
device's idle share.

Attribution:
  * copies and sets (``gpu_memcpy`` / ``gpu_memset``) run on the copy
    engines and may overlap kernels: they are reported apart, as the JAX
    version reports its async DMA windows, and left out of the top kernels;
  * a kernel is the port's when its symbol is a ``__global__`` function of
    ``sgdm_tpu_torch/csrc`` (the hand-written kernels), else convolution
    (cuDNN), collective (NCCL), GEMM (cuBLAS / CUTLASS), or elementwise /
    other (PyTorch's own kernels, SDPA's).
"""

from __future__ import annotations

import collections
import functools
import json
import re
import sys
from pathlib import Path

__all__ = ["summarize", "trace_idle", "device_idle", "categorize", "profile_rows", "main"]

CSRC = Path(__file__).resolve().parents[1] / "csrc"
COPY_CATS = ("gpu_memcpy", "gpu_memset")
DEVICE_CATS = ("kernel",) + COPY_CATS
STEP_MARK = "ProfilerStep#"


@functools.lru_cache(maxsize=1)
def _port_kernel_re() -> re.Pattern:
    """A pattern matching the symbol of any ``__global__`` function in csrc/."""
    names = set()
    for src in sorted(CSRC.glob("*.cu*")):
        names.update(re.findall(r"__global__\s+void\s+(?:__launch_bounds__\s*\([^()]*\)\s*)?"
                                r"(\w+)\s*\(", src.read_text()))
    return re.compile(r"(?:^|[\s:])(" + "|".join(sorted(names)) + r")\s*[<(]")


def categorize(event: dict) -> str:
    """The category of one device event of a chrome trace."""
    cat = event.get("cat")
    if cat in COPY_CATS:
        return cat
    name = event.get("name", "")
    low = name.lower()
    if _port_kernel_re().search(name):
        return "port kernels"
    if "nccl" in low:
        return "collective"
    if "cudnn" in low or "conv" in low or "fprop" in low or "dgrad" in low or "wgrad" in low:
        return "convolution"
    if any(s in low for s in ("gemm", "cutlass", "cublas", "nvjet", "matmul")):
        return "gemm"
    return "elementwise / other"


def load_trace(path: str | Path) -> dict:
    """A chrome trace: ``path`` is the file or the directory holding ``trace.json``."""
    p = Path(path)
    return json.loads((p / "trace.json" if p.is_dir() else p).read_text())


def device_idle(events: list) -> dict:
    """Device busy time and idle share of a `torch.profiler` chrome trace's
    events, over the span from its first device activity (kernel, copy,
    set) to its last, overlapping activities counted once."""
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("cat") in DEVICE_CATS and "dur" in e)
    if not spans:
        return dict(device_events=0)
    busy, (start, end) = 0.0, spans[0]
    for a, b in spans[1:]:
        if a > end:
            busy += end - start
            start, end = a, b
        else:
            end = max(end, b)
    busy += end - start
    window = max(b for _, b in spans) - spans[0][0]
    return dict(device_events=len(spans), window_ms=window / 1e3, device_busy_ms=busy / 1e3,
                device_idle_share=1.0 - busy / window)


def trace_idle(path) -> dict:
    """`device_idle` of the chrome trace at ``path``."""
    return device_idle(load_trace(path)["traceEvents"])


def _steps(events: list) -> tuple[int, float, str]:
    """(steps, their summed duration in µs, "device" or "host") from the step marks."""
    for cat, where in (("gpu_user_annotation", "device"), ("user_annotation", "host")):
        marks = [e for e in events
                 if e.get("cat") == cat and e.get("name", "").startswith(STEP_MARK)]
        if marks:
            return len(marks), sum(e.get("dur", 0.0) for e in marks), where
    return 0, 0.0, "host"


def summarize(profile_dir: str | Path, top: int = 25) -> dict:
    """Print the summary of ``profile_dir``'s trace and return it: device,
    steps, ms a step, categories (ms total and a step), the top kernels and
    the idle share; ``device_events`` 0 when the trace holds none."""
    trace = load_trace(profile_dir)
    events = trace["traceEvents"]
    dev = [e for e in events if e.get("cat") in DEVICE_CATS and "dur" in e]
    if not dev:
        print("no device events found")
        return dict(device_events=0)
    props = trace.get("deviceProperties") or [{}]
    device = props[0].get("name", "CUDA device")
    steps, step_us, where = _steps(events)
    per = max(steps, 1)
    bycat: collections.Counter = collections.Counter()
    byname: collections.Counter = collections.Counter()
    count: collections.Counter = collections.Counter()
    for e in dev:
        cat = categorize(e)
        bycat[cat] += e["dur"]
        if cat not in COPY_CATS:
            byname[e["name"]] += e["dur"]
            count[e["name"]] += 1
    idle = device_idle(events)
    out = dict(device=device, steps=steps, step_marks=where,
               ms_per_step=step_us / 1e3 / per,
               categories={c: dict(ms=d / 1e3, ms_per_step=d / 1e3 / per)
                           for c, d in bycat.most_common()},
               top=[dict(name=n, ms=d / 1e3, count=count[n]) for n, d in byname.most_common(top)],
               **idle)
    print(f"== {device}: {steps} steps, {out['ms_per_step']:.1f} ms/step ({where} step marks), "
          f"device idle {idle['device_idle_share']:.1%} of {idle['window_ms']:.1f} ms")
    print("-- categories (ms total / ms per step):")
    for c, d in bycat.most_common():
        tag = "  [copy engine, may overlap kernels]" if c in COPY_CATS else ""
        print(f"  {d / 1e3:9.1f} {d / 1e3 / per:8.2f}  {c}{tag}")
    print("-- top sync kernels:")
    for row in out["top"]:
        print(f"  {row['ms']:9.1f} ms {row['count']:6d}x  {row['name'][:120]}")
    return out


def profile_rows(prof, wall_us, named=()):
    """Device busy share of the wall time and device time by kernel name of
    a live profiler (``key_averages``); for each substring in ``named``, the
    device time of the kernels whose name holds it."""
    import torch

    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = lambda e: getattr(e, "self_device_time_total", 0.0) or 0.0
    rows = sorted(((e.key, dev_us(e), e.count) for e in kernels if dev_us(e) > 0),
                  key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    assert busy > 0, "the profiler saw no device time"
    out = dict(wall_ms=wall_us / 1e3, device_busy_ms=busy / 1e3,
               device_idle_share=max(0.0, 1.0 - busy / wall_us),
               top=[dict(name=k[:90], device_ms=t / 1e3, share=t / busy, count=c)
                    for k, t, c in rows[:15]])
    if named:
        out["named"] = {}
        for part in named:
            hit = [(t, c) for k, t, c in rows if part in k]
            t = sum(h[0] for h in hit)
            out["named"][part] = dict(device_ms=t / 1e3, share=t / busy,
                                      count=sum(h[1] for h in hit))
    return out


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv or len(argv) > 2:
        print("usage: python -m sgdm_tpu_torch.utils.trace_summary <run>/profile [top_n]",
              file=sys.stderr)
        return 2
    summarize(argv[0], int(argv[1]) if len(argv) > 1 else 25)
    return 0


if __name__ == "__main__":
    sys.exit(main())

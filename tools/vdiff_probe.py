#!/usr/bin/env python3
"""Where a cc12m_1_cfg forward spends its time on the card.

    python3 tools/vdiff_probe.py [--batches 1,8] [--iters 3]

Writes seeded random weights of `sgdm_tpu_torch.models.zoo_vdiff`'s
cc12m_1_cfg (full width, f32) to a temporary ``.pth``, times reading it
back (``torch.load`` plain and memory-mapped, then to the card), then one
forward per batch size under TF32 off in three set-ups, by CUDA events:
cuDNN's heuristic algorithm choice on NCHW, ``cudnn.benchmark`` on NCHW, and
``cudnn.benchmark`` on channels-last tensors.  For the first two at the
first batch size it prints torch.profiler's ten largest device-time
entries.  One JSON line per measurement; the card's name and power limit
first.  Needs a card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from sgdm_tpu_torch.device import no_tf32
    from sgdm_tpu_torch.models import zoo_vdiff as zv

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batches", default="1,8")
    ap.add_argument("--iters", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("vdiff_probe: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "cc12m_1_cfg.pth"
        torch.manual_seed(0)
        model, meta = zv.get_vdiff_model("cc12m_1_cfg", dev)
        torch.save({k: v.cpu() for k, v in model.state_dict().items()}, path)
        del model
        for mmap in (False, True):
            t = time.perf_counter()
            sd = torch.load(path, map_location="cpu", weights_only=True, mmap=mmap)
            t_load = time.perf_counter() - t
            sd = {k: v.to(dev) for k, v in sd.items()}
            torch.cuda.synchronize()
            print(json.dumps({"load": dict(mmap=mmap, load_s=t_load,
                                           to_card_s=time.perf_counter() - t - t_load)}),
                  flush=True)
            del sd
        t = time.perf_counter()
        model = zv.load_vdiff_torch_checkpoint("cc12m_1_cfg", str(path), dev)
        torch.cuda.synchronize()
        print(json.dumps({"load_vdiff_torch_checkpoint_s": time.perf_counter() - t}), flush=True)

    size = meta.shape[0]
    batches = [int(v) for v in args.batches.split(",")]
    for b in batches:
        x = torch.randn(b, 3, size, size, device=dev)
        t = torch.full((b,), 0.6, device=dev)
        ce = torch.randn(b, meta.clip_dim, device=dev)
        for name, bench, fmt in (("heuristic_nchw", False, torch.contiguous_format),
                                 ("benchmark_nchw", True, torch.contiguous_format),
                                 ("benchmark_channels_last", True, torch.channels_last)):
            torch.backends.cudnn.benchmark = bench
            model = model.to(memory_format=fmt)
            xf = x.contiguous(memory_format=fmt)
            fwd = lambda: model(xf, t, ce)  # noqa: E731
            with torch.no_grad(), no_tf32():
                t0 = time.perf_counter()
                fwd()
                torch.cuda.synchronize()
                first_s = time.perf_counter() - t0
                fwd()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(args.iters):
                    fwd()
                end.record()
                torch.cuda.synchronize()
                row = dict(batch=b, setup=name, first_call_s=first_s,
                           ms=start.elapsed_time(end) / args.iters)
                if b == batches[0] and fmt == torch.contiguous_format:
                    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                        fwd()
                        torch.cuda.synchronize()
                    ev = [e for e in prof.key_averages()
                          if e.device_type == torch.autograd.DeviceType.CUDA]
                    total = sum(e.self_device_time_total for e in ev)
                    row["device_ms"] = total / 1e3
                    row["top"] = [(e.key[:90], e.count, e.self_device_time_total / 1e3)
                                  for e in sorted(ev, key=lambda e: -e.self_device_time_total)
                                  [:10]]
            print(json.dumps(row), flush=True)
    torch.backends.cudnn.benchmark = False
    return 0


if __name__ == "__main__":
    sys.exit(main())

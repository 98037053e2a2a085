#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (`sgdm_tpu_torch`) on one GPU.

    python3 chip_smoke.py                 # every phase, as below
    python3 chip_smoke.py --phases build,kernels --quick
    python3 chip_smoke.py --phases build,profile   # device time by kernel

Phases (each one fails the run with a non-zero exit):
  1. build   the card's name and power limit, torch/CUDA versions, and the
             nvcc build of every kernel in sgdm_tpu_torch/csrc/;
  2. kernels each kernel against its plain PyTorch version on the card, in
             bf16, at every shape the IN64 `unet_fast` forward gives it at
             model batch 128 (64 samples, CFG-doubled): max abs error, kernel
             ms, plain ms and a library yardstick (cuDNN conv composition for
             the ResBlocks, scaled_dot_product_attention for attention);
  3. forward one full-width UNET_FAST_IN64 forward (cond_dim 1000, batch
             128, bf16, seeded random f32 weights) with kernels on and off;
  4. sample  the serving path: `generate(n=64, batch_size=64, steps=50,
             cond_scale=2)`, with the kernel launch counters set to 0 just
             before and read just after; plus a 4-step kernels-on vs
             kernels-off sample of the same seed.
  (profile, only when asked for: torch.profiler over a 4-step sample at the
             served shape, device busy share and device time by kernel.)
Every phase prints its results as JSON lines; then come one JSON line
{"kernels": [...]}, the nvidia-smi line, and last {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory rate
BF16_FLOP_PER_S = 989e12      # H100 SXM dense bf16 tensor-core peak
MODEL_BATCH = 128             # 64 samples, doubled by the fused CFG pass
# (H, W, Cin, Cout, calls per UNet forward) of every ResBlock the IN64
# unet_fast forward sends to K1, and (H_in, C, resample) for K2
K1_SHAPES = [
    (64, 64, 128, 128, 2), (64, 64, 384, 128, 1), (64, 64, 256, 128, 2),
    (32, 32, 128, 256, 1), (32, 32, 256, 256, 1), (32, 32, 768, 256, 1),
    (32, 32, 512, 256, 1), (32, 32, 384, 256, 1), (16, 16, 256, 512, 1),
    (16, 16, 512, 512, 3), (16, 16, 1024, 512, 2), (16, 16, 768, 512, 1),
]
K2_SHAPES = [(64, 128, "down"), (32, 256, "down"), (16, 512, "up"), (32, 256, "up")]
K3_SHAPE = (MODEL_BATCH, 8, 256, 64)
K3_CALLS = 6
# Tolerances (max abs error of the bf16 output, relative to max|plain|):
# both sides round h1/h3 to bf16 and the output to bf16 at the same points;
# they differ in f32 summation order (GN statistics, conv accumulation),
# which can flip a bf16 rounding of h1/h3 and moves the output by a few bf16
# ulps (2^-8 relative each).
RESBLOCK_TOL = 2.0 ** -5
ATTENTION_TOL = 2.0 ** -6   # f32 logits and softmax on both; bf16 weights/out
FORWARD_TOL = 5e-2          # 27 kernel calls of bf16 flips, relative to max|eps|
# Mean |uint8 difference| of a 4-step sample, kernels on vs off: eps differs
# by the forward's bf16 flips (under 1 % of max|eps|), and DDIM's
# x0 = (x - sqrt(1-a)·eps)/sqrt(a) amplifies that by about 4 at the first of
# 4 steps (t = 751), before the uint8 rounding.
SAMPLE_TOL = 4.0


def nvidia_smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_time(fn, iters: int, warmup: int = 2) -> float:
    """Mean ms per call on the card (CUDA events around ``iters`` calls)."""
    import torch

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


@contextlib.contextmanager
def full_f32():
    """The plain side runs f32 convolutions and products without TF32."""
    import torch

    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------- phase 2

def resblock_operands(gen, h, w, cin, cout, dev, b=MODEL_BATCH):
    import torch

    r = lambda *s: torch.randn(*s, generator=gen, device=dev)
    x = r(b, h, w, cin).to(torch.bfloat16)
    ops = dict(
        gn1_scale=1 + 0.1 * r(cin), gn1_bias=0.1 * r(cin),
        w1=r(3, 3, cin, cout) / math.sqrt(9 * cin), b1=0.1 * r(cout),
        film_scale=(0.1 * r(b, cout)).to(torch.bfloat16),
        film_shift=(0.1 * r(b, cout)).to(torch.bfloat16),
        gn2_scale=1 + 0.1 * r(cout), gn2_bias=0.1 * r(cout),
        w2=r(3, 3, cout, cout) / math.sqrt(9 * cout), b2=0.1 * r(cout),
    )
    if cin != cout:
        ops["skip_w"] = r(1, 1, cin, cout) / math.sqrt(cin)
        ops["skip_b"] = 0.1 * r(cout)
    return x, ops


def library_resblock(x, o, resample=None):
    """cuDNN yardstick: the same block as bf16 NCHW/channels_last PyTorch ops."""
    import torch
    import torch.nn.functional as F

    bf = torch.bfloat16
    cin, cout = x.shape[-1], o["w1"].shape[-1]
    xc = x.permute(0, 3, 1, 2)
    h = F.silu(F.group_norm(xc.float(), math.gcd(32, cin), o["gn1_scale"], o["gn1_bias"],
                            1e-5)).to(bf)
    skip = xc
    if resample == "down":
        h, skip = F.avg_pool2d(h, 2), F.avg_pool2d(xc, 2)
    elif resample == "up":
        h, skip = (F.interpolate(t, scale_factor=2, mode="nearest") for t in (h, xc))
    h = F.conv2d(h, o["w1"].permute(3, 2, 0, 1).to(bf), o["b1"].to(bf), padding=1)
    h = F.group_norm(h.float(), math.gcd(32, cout), o["gn2_scale"], o["gn2_bias"], 1e-5)
    h = F.silu(h * (1 + o["film_scale"].float()[:, :, None, None])
               + o["film_shift"].float()[:, :, None, None]).to(bf)
    h = F.conv2d(h, o["w2"].permute(3, 2, 0, 1).to(bf), o["b2"].to(bf), padding=1)
    if "skip_w" in o:
        skip = F.conv2d(xc, o["skip_w"].permute(3, 2, 0, 1).to(bf), o["skip_b"].to(bf))
    return (skip + h).permute(0, 2, 3, 1)


def resblock_cost(h, w, cin, cout, resample, proj):
    b = MODEL_BATCH
    ho, wo = (h // 2, w // 2) if resample == "down" else (
        (2 * h, 2 * w) if resample == "up" else (h, w))
    macs = ho * wo * (9 * cin * cout + 9 * cout * cout + (cin * cout if proj else 0))
    nbytes = (b * h * w * cin * 2 + b * ho * wo * cout * 2              # x in, out
              + 2 * (9 * cin * cout + 9 * cout * cout + (cin * cout if proj else 0))
              + 2 * b * cout * 2 + 4 * (2 * cin + 4 * cout + (cout if proj else 0)))
    return bound_ms(nbytes, 2.0 * b * macs)


def check_kernel(fn, plain, library, iters):
    import torch

    with full_f32():
        ref = plain()
    out = fn()
    torch.cuda.synchronize()
    assert out.shape == ref.shape and out.dtype == ref.dtype, (out.shape, ref.shape)
    assert torch.isfinite(out.float()).all()
    err = (out.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    ms = cuda_time(fn, iters)
    with full_f32():
        plain_ms = cuda_time(plain, max(1, iters // 2), warmup=1)
    library_ms = cuda_time(library, iters) if library is not None else None
    return err, scale, ms, plain_ms, library_ms


def phase_kernels(dev, iters: int) -> dict:
    import torch

    from sgdm_tpu_torch.ops import attention as att
    from sgdm_tpu_torch.ops import resblock as rb

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    agg = {k: dict(err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0, by={})
           for k in ("resblock", "resblock_resample", "self_attention")}

    def add(kernel, calls, err, ms, plain_ms, lib_ms, bnd, by):
        a = agg[kernel]
        a["err"] = max(a["err"], err)
        a["ms"] += calls * ms
        a["plain_ms"] += calls * plain_ms
        a["library_ms"] += calls * lib_ms
        a["bound_ms"] += calls * bnd
        a["by"][by] = a["by"].get(by, 0.0) + calls * bnd

    for h, w, cin, cout, calls in K1_SHAPES:
        x, o = resblock_operands(gen, h, w, cin, cout, dev)
        args = [o[k] for k in ("gn1_scale", "gn1_bias", "w1", "b1", "film_scale",
                               "film_shift", "gn2_scale", "gn2_bias", "w2", "b2")]
        skw, skb = o.get("skip_w"), o.get("skip_b")
        err, scale, ms, pms, lms = check_kernel(
            lambda: rb.resblock_cuda(x, *args, skw, skb),
            lambda: rb.resblock_plain(x, *args, skw, skb),
            lambda: library_resblock(x, o), iters)
        bnd, by = resblock_cost(h, w, cin, cout, None, skw is not None)
        row = dict(kernel="resblock", shape=[MODEL_BATCH, h, w, cin, cout], calls=calls,
                   max_abs_err=err, max_abs_ref=scale, ms=ms, plain_ms=pms, library_ms=lms,
                   bound_ms=bnd, bound_by=by)
        print(json.dumps(row), flush=True)
        assert err <= RESBLOCK_TOL * max(scale, 1.0), f"K1 {row['shape']}: err {err}"
        add("resblock", calls, err, ms, pms, lms, bnd, by)

    for h, c, resample in K2_SHAPES:
        x, o = resblock_operands(gen, h, h, c, c, dev)
        args = [o[k] for k in ("gn1_scale", "gn1_bias", "w1", "b1", "film_scale",
                               "film_shift", "gn2_scale", "gn2_bias", "w2", "b2")]
        err, scale, ms, pms, lms = check_kernel(
            lambda: rb.resblock_resample_cuda(x, *args, resample=resample),
            lambda: rb.resblock_plain(x, *args, resample=resample),
            lambda: library_resblock(x, o, resample), iters)
        bnd, by = resblock_cost(h, h, c, c, resample, False)
        row = dict(kernel="resblock_resample", shape=[MODEL_BATCH, h, h, c, resample],
                   calls=1, max_abs_err=err, max_abs_ref=scale, ms=ms, plain_ms=pms,
                   library_ms=lms, bound_ms=bnd, bound_by=by)
        print(json.dumps(row), flush=True)
        assert err <= RESBLOCK_TOL * max(scale, 1.0), f"K2 {row['shape']}: err {err}"
        add("resblock_resample", 1, err, ms, pms, lms, bnd, by)

    b, nh, n, d = K3_SHAPE
    q, k, v = (torch.randn(b, nh, n, d, generator=gen, device=dev).to(torch.bfloat16)
               for _ in range(3))
    import torch.nn.functional as F

    err, scale, ms, pms, lms = check_kernel(
        lambda: att.self_attention_cuda(q, k, v),
        lambda: att.self_attention_plain(q, k, v),
        lambda: F.scaled_dot_product_attention(q, k, v, scale=1.0 / math.sqrt(d)), iters)
    bnd, by = bound_ms(4 * b * nh * n * d * 2, 4.0 * b * nh * n * n * d)
    row = dict(kernel="self_attention", shape=list(K3_SHAPE), calls=K3_CALLS, max_abs_err=err,
               max_abs_ref=scale, ms=ms, plain_ms=pms, library_ms=lms, bound_ms=bnd,
               bound_by=by)
    print(json.dumps(row), flush=True)
    assert err <= ATTENTION_TOL * max(scale, 1.0), f"K3: err {err}"
    add("self_attention", K3_CALLS, err, ms, pms, lms, bnd, by)
    check_odd_shapes(dev, gen)
    return agg


def check_odd_shapes(dev, gen) -> None:
    """Correctness only, at shapes the IN64 path never gives: channel counts
    that are not multiples of 8 (the kernels' scalar load paths), widths
    that do not fill a tile, sequences that do not fill a key chunk."""
    import torch

    from sgdm_tpu_torch.ops import attention as att
    from sgdm_tpu_torch.ops import resblock as rb

    rows = []
    for h, w, cin, cout, resample in [(8, 24, 36, 20, None), (10, 6, 40, 40, None),
                                      (12, 10, 24, 24, "down"), (5, 7, 20, 20, "up"),
                                      (6, 8, 40, 48, None)]:
        x, o = resblock_operands(gen, h, w, cin, cout, dev, b=3)
        args = [o[k] for k in ("gn1_scale", "gn1_bias", "w1", "b1", "film_scale",
                               "film_shift", "gn2_scale", "gn2_bias", "w2", "b2")]
        skw, skb = o.get("skip_w"), o.get("skip_b")
        if resample is None:
            out = rb.resblock_cuda(x, *args, skw, skb)
        else:
            out = rb.resblock_resample_cuda(x, *args, resample=resample)
        with full_f32():
            ref = rb.resblock_plain(x, *args, skw, skb, resample=resample)
        err = (out.float() - ref.float()).abs().max().item()
        scale = ref.float().abs().max().item()
        rows.append(dict(kernel="resblock", shape=[3, h, w, cin, cout, resample],
                         max_abs_err=err, max_abs_ref=scale))
        assert err <= RESBLOCK_TOL * max(scale, 1.0), rows[-1]
    for b, nh, n, d in [(3, 2, 100, 32), (1, 3, 17, 128), (2, 1, 1024, 64)]:
        q, k, v = (torch.randn(b, nh, n, d, generator=gen, device=dev).to(torch.bfloat16)
                   for _ in range(3))
        out = att.self_attention_cuda(q, k, v)
        with full_f32():
            ref = att.self_attention_plain(q, k, v)
        err = (out.float() - ref.float()).abs().max().item()
        scale = ref.float().abs().max().item()
        rows.append(dict(kernel="self_attention", shape=[b, nh, n, d],
                         max_abs_err=err, max_abs_ref=scale))
        assert err <= ATTENTION_TOL * max(scale, 1.0), rows[-1]
    print(json.dumps({"odd_shapes": rows}), flush=True)


# ---------------------------------------------------------------- phases 3, 4

def build_model(dev, seed: int = 0):
    import torch

    from sgdm_tpu_torch.models.factory import UNET_FAST_IN64, create_denoiser, \
        init_random_params

    cfg = dict(UNET_FAST_IN64, cond_dim=1000)
    model = create_denoiser(dtype=torch.bfloat16, **cfg)
    init_random_params(model, seed)
    return cfg, model.to(dev).eval()


def phase_forward(dev, model) -> None:
    import torch

    from sgdm_tpu_torch.models.layers import set_kernels

    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    b = MODEL_BATCH
    x = torch.randn(b, 64, 64, 3, generator=gen, device=dev)
    t = torch.randint(1, 1000, (b,), generator=gen, device=dev)
    cond = torch.nn.functional.one_hot(
        torch.randint(0, 1000, (b,), generator=gen, device=dev), 1000).float()
    mask = torch.arange(b, device=dev) >= b // 2
    with torch.inference_mode(), full_f32():  # only the kernels differ
        set_kernels(model, True)
        eps_k = model(x, t, cond=cond, cond_drop_mask=mask)
        set_kernels(model, False)
        eps_p = model(x, t, cond=cond, cond_drop_mask=mask)
        set_kernels(model, True)
    torch.cuda.synchronize()
    assert eps_k.shape == (b, 64, 64, 3) and torch.isfinite(eps_k).all()
    rel = ((eps_k - eps_p).abs().max() / eps_p.abs().max()).item()
    print(json.dumps({"forward": dict(rel_max_err=rel, max_abs_eps=eps_p.abs().max().item())}),
          flush=True)
    assert rel <= FORWARD_TOL, f"kernels-on vs kernels-off forward: rel err {rel}"


def phase_sample(dev, cfg, model, card: str) -> dict:
    import torch

    from sgdm_tpu_torch import ops
    from sgdm_tpu_torch.generate import generate
    from sgdm_tpu_torch.models.layers import set_kernels

    n, steps = 64, 50
    kw = dict(n=n, batch_size=n, cond_scale=2.0, seed=0, device=dev, model=model)
    # small input, kernels on vs off (plain versions), same seed and x_T draw
    small = dict(kw, n=4, batch_size=4, steps=4)
    with torch.inference_mode():
        with full_f32():  # only the kernels differ
            img_k = generate(cfg, **small)
            set_kernels(model, False)
            img_p = generate(cfg, **small)
            set_kernels(model, True)
        diff = (img_k.int() - img_p.int()).abs()
        small_row = dict(max_uint8_diff=int(diff.max()),
                         mean_uint8_diff=float(diff.float().mean()))
        print(json.dumps({"sample_small": small_row}), flush=True)
        assert small_row["mean_uint8_diff"] <= SAMPLE_TOL, small_row

        generate(cfg, **dict(kw, steps=4))  # warm-up at the served shape
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        imgs = generate(cfg, **dict(kw, steps=steps))
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        counts = ops.launch_counts()
    assert imgs.dtype == torch.uint8 and tuple(imgs.shape) == (n, 64, 64, 3), imgs.shape
    assert imgs.float().std().item() > 0, "constant images"
    want = {"resblock": steps * 17, "resblock_resample": steps * 4,
            "self_attention": steps * K3_CALLS}
    print(json.dumps({"sample": dict(card=card, n=n, steps=steps, seconds=elapsed,
                                     ddim_steps_per_s=steps / elapsed,
                                     images_per_s=n / elapsed, launches=counts,
                                     mean_pixel=float(imgs.float().mean()))}), flush=True)
    assert counts == want, f"launch counts {counts} != {want}"
    return counts


def phase_profile(dev, cfg, model, steps: int = 4) -> None:
    """torch.profiler over a short guided sample at the served shape: device
    busy share of the wall time and device time by kernel name."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from sgdm_tpu_torch.generate import generate

    kw = dict(n=64, batch_size=64, cond_scale=2.0, seed=0, device=dev, model=model,
              steps=steps)
    with torch.inference_mode():
        generate(cfg, **kw)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            generate(cfg, **kw)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    # device-side events only (a CPU op's device time repeats its kernels')
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = lambda e: getattr(e, "self_device_time_total", 0.0) or 0.0
    rows = sorted(((e.key, dev_us(e), e.count) for e in kernels if dev_us(e) > 0),
                  key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    profile_row = dict(
        steps=steps, wall_ms=wall_us / 1e3, device_busy_ms=busy / 1e3,
        device_idle_share=max(0.0, 1.0 - busy / wall_us),
        top=[dict(name=k[:90], device_ms=t / 1e3, share=t / busy, count=c)
             for k, t, c in rows[:15]])
    print(json.dumps({"profile": profile_row}), flush=True)
    assert busy > 0, "the profiler saw no device time"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default="build,kernels,forward,sample")
    ap.add_argument("--quick", action="store_true", help="fewer timing iterations")
    args = ap.parse_args()
    phases = set(args.phases.split(","))

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    from sgdm_tpu_torch.ops import build

    dev = torch.device("cuda", 0)
    smi = nvidia_smi_line()
    print(f"card: {smi}; torch {torch.__version__}; CUDA {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    built = build.build_all()
    print(f"kernel build: {time.perf_counter() - t0:.1f} s {built}", flush=True)
    if args.quick:
        for log in sorted(build._build_dir().glob("*.log")):
            print(log.read_text()[-4000:])

    agg = phase_kernels(dev, 3 if args.quick else 20) if "kernels" in phases else {}
    counts = {}
    if phases & {"forward", "sample", "profile"}:
        cfg, model = build_model(dev)
        if "forward" in phases:
            phase_forward(dev, model)
        if "sample" in phases:
            counts = phase_sample(dev, cfg, model, smi)
        if "profile" in phases:
            phase_profile(dev, cfg, model)

    # launches: read just after the served run of the sample phase; null
    # when that phase was not asked for (nothing was measured)
    rows = []
    meta = {
        "resblock": ("sgdm_tpu_torch/csrc/resblock.cu", "sgdm_tpu/ops/pallas/resblock.py:153"),
        "resblock_resample": ("sgdm_tpu_torch/csrc/resblock.cu",
                              "sgdm_tpu/ops/pallas/resblock.py:211"),
        "self_attention": ("sgdm_tpu_torch/csrc/attention.cu",
                           "sgdm_tpu/ops/pallas/attention.py:33"),
    }
    for name, a in agg.items():
        by = max(a["by"], key=a["by"].get)
        rows.append({"name": name, "route": "cuda", "source": meta[name][0],
                     "replaces": meta[name][1], "launches": counts.get(name),
                     "max_abs_err": a["err"], "ms": a["ms"], "plain_ms": a["plain_ms"],
                     "bound_ms": a["bound_ms"], "bound_by": by, "library_ms": a["library_ms"]})
    print(json.dumps({"kernels": rows}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Where K9's f32 kernels spend their time on the card, by ablation.

    python3 tools/f32_attention_probe.py [--iters 20] [--variants base,fwd_no_pv,...]

Builds ``sgdm_tpu_torch/csrc/attention.cu`` once per variant of
``attention_f32.cuh`` (the header patched as below, in
``build/probe/<variant>/``; every nvcc at once), then times each variant's
``sgdm_self_attention_f32`` and ``sgdm_attention_bwd_f32`` at the
classifier's shape [128, 8, 256, 64] on the strided views of a packed
projection, with CUDA events, the variants in turns (forward order, then
reverse).  A variant that cuts out work computes wrong numbers on purpose:
its time says what the rest costs.  Two micro-kernels give the card's
ceilings under the same clocks: an FFMA loop (8 independent chains a thread,
256 threads a block, 8 blocks an SM) and a loop of 16-byte shared loads,
each warp reading 4, 8 or 32 distinct addresses (the products' broadcast
patterns), with 16 FFMA on each load.  One JSON line per measurement; the
card's name and power limit first.  Needs the card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

SHAPE = (128, 8, 256, 64)
F32_FLOP_PER_S = 67e12

PREV = """    float4 prev[4];  // dQ summed over the key tiles before this one
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = q0 + qa + 8 * e;
      prev[e] = kt > 0 && row < n ? ld4(dq + (long long)row * p.sr[F_DQ] + dcol)
                                  : make_float4(0.f, 0.f, 0.f, 0.f);
    }
"""
# variant -> [(text in attention_f32.cuh, its replacement)]
VARIANTS = {
    "base": [],
    # the forward's parts
    "fwd_no_pv": [("    acc_rows<8, 2>(acc, Pw, 4 * LD, Vc + 4 * j, 64,\n"
                   "                   [](int u) { return (u >> 3) + 8 * (u & 7); });\n", "")],
    "fwd_no_s": [("    dot_rows<8, 8>(s, Qw, 4 * LD, Kc + j * LD, 8 * LD);\n", "")],
    "fwd_no_exp": [("        s[r][e] = expf(s[r][e] - mn);", "        s[r][e] = s[r][e] - mn;")],
    # the backward's parts
    "bwd_no_dq": [("for (int key = k4; key < KT; key += 4)",
                   "for (int key = k4; key < 0; key += 4)")],
    "bwd_no_dkdv": [("      acc_rows<8, 2>(acc, Tt + kr * LD, 4 * LD, (role ? Qc : DOc) + 4 * j,"
                     " LD,\n                     [](int u) { return (u >> 3) + 8 * (u & 7); });\n",
                     "")],
    "bwd_no_sdp": [("      dot_rows<8, 8>(t, Ks + kr * LD, 4 * LD, Qc + j * LD, 8 * LD);\n", ""),
                   ("      dot_rows<8, 8>(t, Vs + kr * LD, 4 * LD, DOc + j * LD, 8 * LD);\n", "")],
}

MICRO = r"""
#include <cuda_runtime.h>
__global__ void __launch_bounds__(256) ffma_loop(float* out, int iters) {
  float a[8];
  for (int i = 0; i < 8; ++i) a[i] = threadIdx.x * 1e-3f + i;
  const float b = 0.999f, c = 1e-4f;
  for (int t = 0; t < iters; ++t)
#pragma unroll
    for (int i = 0; i < 8; ++i) a[i] = fmaf(a[i], b, c);
  float s = 0.f;
  for (int i = 0; i < 8; ++i) s += a[i];
  if (s == 12345.f) out[threadIdx.x] = s;
}
// every warp loads float4 rows: lane -> row (lane >> 3) * 68 / 4 ... by `distinct`
__global__ void __launch_bounds__(256) lds_loop(float* out, int iters, int distinct) {
  __shared__ __align__(16) float sm[64 * 68];
  for (int u = threadIdx.x; u < 64 * 68; u += 256) sm[u] = u * 1e-6f;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int row = distinct == 4 ? lane >> 3 : distinct == 8 ? lane & 7 : lane;
  const float* p = sm + row * 68;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int t = 0; t < iters; ++t) {
#pragma unroll
    for (int d = 0; d < 64; d += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + ((d + 4 * t) & 63));
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[e] = fmaf(v.x, acc[e], v.y);
        acc[e] = fmaf(v.z, acc[e], v.w);
        acc[e] = fmaf(v.x, acc[e], v.w);
        acc[e] = fmaf(v.y, acc[e], v.z);
      }
    }
  }
  if (acc[0] + acc[1] + acc[2] + acc[3] == 12345.f) out[threadIdx.x] = acc[0];
}
extern "C" int probe_ffma(float* out, int blocks, int iters, void* s) {
  ffma_loop<<<blocks, 256, 0, (cudaStream_t)s>>>(out, iters);
  return (int)cudaGetLastError();
}
extern "C" int probe_lds(float* out, int blocks, int iters, int distinct, void* s) {
  lds_loop<<<blocks, 256, 0, (cudaStream_t)s>>>(out, iters, distinct);
  return (int)cudaGetLastError();
}
"""


def ptxas_f32(log: str) -> dict:
    """Registers and spill bytes of each f32 kernel in an nvcc -Xptxas -v log."""
    import re

    found, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1) if "f32_" in m.group(1) else None
        elif name and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            found.setdefault(name, {}).update(spill_stores=int(m[1]), spill_loads=int(m[2]))
        elif name and (m := re.search(r"Used (\d+) registers", line)):
            found.setdefault(name, {})["registers"] = int(m[1])
    return found


def build(variants: list[str]) -> dict[str, Path]:
    from sgdm_tpu_torch.ops import build as kb

    nvcc = kb._nvcc()
    root = ROOT / "build" / "probe"
    shutil.rmtree(root, ignore_errors=True)
    procs = {}
    for name in variants:
        d = root / name
        shutil.copytree(ROOT / "sgdm_tpu_torch" / "csrc", d)
        header = d / "attention_f32.cuh"
        text = header.read_text()
        for old, new in VARIANTS[name]:
            if old not in text:
                raise SystemExit(f"variant {name}: patch target not found: {old!r}")
            text = text.replace(old, new)
        header.write_text(text)
        procs[name] = subprocess.Popen(
            [nvcc, *kb.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(d / "libattention.so"),
             str(d / "attention.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
    (root / "micro.cu").write_text(MICRO)
    procs["micro"] = subprocess.Popen(
        [nvcc, *kb.NVCC_FLAGS, "-o", str(root / "libmicro.so"), str(root / "micro.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        libs[name] = root / ("libmicro.so" if name == "micro" else f"{name}/libattention.so")
        if name != "micro":
            print(json.dumps({"variant": name, "ptxas": ptxas_f32(log)}), flush=True)
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--check", action="store_true",
                    help="only check that every variant's patch applies (no card needed)")
    args = ap.parse_args()
    if args.check:
        text = (ROOT / "sgdm_tpu_torch" / "csrc" / "attention_f32.cuh").read_text()
        missing = [name for name in args.variants.split(",")
                   for old, _ in VARIANTS[name] if old not in text]
        print(json.dumps({"variants": args.variants.split(","), "missing": missing}))
        return 1 if missing else 0
    import torch

    if not torch.cuda.is_available():
        print("f32_attention_probe: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    from sgdm_tpu_torch.ops.attention import _bnhd_like, _scale

    variants = args.variants.split(",")
    t0 = time.perf_counter()
    paths = build(variants)
    print(json.dumps({"build_s": time.perf_counter() - t0}), flush=True)
    dev = torch.device("cuda")
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    ll = ctypes.POINTER(ctypes.c_longlong)

    def timed(fn, iters):
        for _ in range(3):
            fn()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / iters

    micro = ctypes.CDLL(str(paths.pop("micro")))
    micro.probe_ffma.argtypes = [vp, i, i, vp]
    micro.probe_lds.argtypes = [vp, i, i, i, vp]
    out = torch.zeros(256, device=dev)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    iters_ffma = 20000
    ms = timed(lambda: micro.probe_ffma(ctypes.c_void_p(out.data_ptr()), 8 * sms, iters_ffma,
                                        stream), args.iters)
    flop = 2.0 * 8 * iters_ffma * 256 * 8 * sms
    print(json.dumps({"micro": "ffma", "ms": ms, "tflop_per_s": flop / ms / 1e9,
                      "share_of_67": flop / ms / 1e9 / 67}), flush=True)
    for distinct in (4, 8, 32):
        iters_lds = 2000
        ms = timed(lambda: micro.probe_lds(ctypes.c_void_p(out.data_ptr()), 8 * sms, iters_lds,
                                           distinct, stream), args.iters)
        loads = 16.0 * iters_lds * 8 * 8 * sms   # warp-wide LDS.128 instructions
        flop = 2.0 * 16 * 16 * iters_lds * 256 * 8 * sms
        print(json.dumps({"micro": "lds128", "distinct_per_warp": distinct, "ms": ms,
                          "lds_per_sm_per_ns": loads / sms / ms / 1e6,
                          "tflop_per_s": flop / ms / 1e9}), flush=True)

    b, h, n, d = SHAPE
    gen = torch.Generator(device=dev).manual_seed(0)
    q, k, v = torch.randn(b, n, 3, h, d, generator=gen, device=dev).permute(2, 0, 3, 1, 4)
    do = torch.randn(b, h, n, d, generator=gen, device=dev)
    o, lse = _bnhd_like(q), torch.empty(b, h, n, device=dev)
    grads = [_bnhd_like(q) for _ in range(3)]
    dr = torch.empty(b, h, n, device=dev)
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())
    fs = (ctypes.c_longlong * 12)(*(s for t in (q, k, v, o) for s in t.stride()[:3]))
    bs = (ctypes.c_longlong * 24)(*(s for t in (q, k, v, o, do, *grads) for s in t.stride()[:3]))
    runs = {}
    for name, path in paths.items():
        lib = ctypes.CDLL(str(path))
        lib.sgdm_self_attention_f32.argtypes = [vp, vp, vp, vp, i, i, i, i, ll, f, vp, vp]
        lib.sgdm_attention_bwd_f32.argtypes = [vp] * 10 + [i, i, i, i, ll, f, vp]
        runs[name] = (
            lambda lib=lib: lib.sgdm_self_attention_f32(ptr(q), ptr(k), ptr(v), ptr(o), b, h, n,
                                                        d, fs, _scale(d), ptr(lse), stream),
            lambda lib=lib: lib.sgdm_attention_bwd_f32(ptr(q), ptr(k), ptr(v), ptr(o), ptr(do),
                                                       ptr(lse), ptr(dr), *map(ptr, grads), b, h,
                                                       n, d, bs, _scale(d), stream))
    fwd_flop, bwd_flop = 4.0 * b * h * n * n * d, 10.0 * b * h * n * n * d
    times = {name: {"fwd": [], "bwd": []} for name in runs}
    for order in (list(runs), list(reversed(runs))):
        for name in order:
            fwd, bwd = runs[name]
            assert fwd() == 0 and bwd() == 0, name
            times[name]["fwd"].append(timed(fwd, args.iters))
            times[name]["bwd"].append(timed(bwd, args.iters))
    for name, t in times.items():
        fm, bm = sum(t["fwd"]) / 2, sum(t["bwd"]) / 2
        print(json.dumps({"variant": name, "shape": list(SHAPE), "fwd_ms": t["fwd"],
                          "bwd_ms": t["bwd"], "fwd_share_of_bound": fwd_flop / F32_FLOP_PER_S
                          / (fm / 1e3), "bwd_share_of_bound": bwd_flop / F32_FLOP_PER_S
                          / (bm / 1e3)}), flush=True)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())

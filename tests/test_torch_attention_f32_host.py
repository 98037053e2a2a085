"""K9's f32 kernels (`sgdm_tpu_torch/csrc/attention_f32.cuh`) run on the CPU:
the header is compiled by g++ against `tests/cuda_host/`, which gives its
CUDA constructs a host form (a block's 256 threads are fibers on one OS
thread that wait at real barriers, deadlocks reported; shuffles through an
array between warp barriers; named barriers; cp.async copies that land only
when a wait drains their group, into shared memory that starts as NaN), and
the kernels' own code computes from the operands the port's wrappers hand
the card, with the parameters the C entry points build
(`tests/cuda_host/run_f32_attention.py`, in a child process whose time is
bounded).  Held against the plain versions at the card's tolerance
(`K9_F32_TOL`, 1e-4 of each output's max|plain|; the code is the card's,
apart in FMA contraction and `expf`): at the classifier's packed strided
layout (batch and heads cut), at the chip script's odd shapes and across
the tile edges; the backward twice, bit for bit, and K3's f32 forward (no
lse) equal to K9's."""

import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from sgdm_tpu_torch.ops.attention import flash_attention_bwd_plain, flash_attention_plain

K9_F32_TOL = 1e-4
ROOT = Path(__file__).resolve().parents[1]
# [B, H, N, D]: the classifier's shape (batch and heads cut), the head-dim-64
# route across its tile edges (64-key chunks, 128-key tiles, 256-row blocks),
# and the chip script's odd shapes (the two largest with batch and heads cut:
# a fiber per CUDA thread is slow)
SHAPES = [(1, 2, 256, 64), (1, 1, 65, 64), (1, 1, 129, 64), (1, 1, 320, 64), (3, 2, 100, 64),
          (1, 3, 17, 128), (1, 1, 300, 128), (1, 1, 1024, 64)]


@pytest.fixture(scope="module")
def host_runs(tmp_path_factory):
    """Every shape's operands and kernel results: the kernels built for the
    host (a copy of the header beside the stand-in hopper.cuh, so its
    `#include "hopper.cuh"` finds the stand-in) and run in a child process."""
    out = tmp_path_factory.mktemp("f32_attention_host")
    for src in (ROOT / "tests" / "cuda_host").glob("*.*"):
        shutil.copy(src, out / src.name)
    shutil.copy(ROOT / "sgdm_tpu_torch" / "csrc" / "attention_f32.cuh", out)
    so = out / "libf32_attention_host.so"
    subprocess.run(["g++", "-std=c++20", "-O2", "-pthread", "-shared", "-fPIC", "-o", str(so),
                    str(out / "f32_attention_host.cpp")], check=True, capture_output=True,
                   timeout=300)
    saved = out / "runs.pt"
    subprocess.run([sys.executable, str(out / "run_f32_attention.py"), str(so), str(saved),
                    *(",".join(map(str, s)) for s in SHAPES)], check=True, timeout=300)
    return torch.load(saved)


def _close(got, want, name):
    scale = want.abs().max().item()
    err = (got - want).abs().max().item()
    assert torch.isfinite(got).all() and err <= K9_F32_TOL * max(scale, 1e-6), (name, err, scale)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_kernel_code_on_the_host_matches_plain(host_runs, shape):
    r = host_runs[shape]
    q, k, v, do, out, lse = (r[x] for x in ("q", "k", "v", "do", "out", "lse"))
    ref, ref_lse = flash_attention_plain(q, k, v)
    _close(out, ref, "out")
    _close(lse, ref_lse, "lse")
    assert torch.equal(r["k3"], out)
    for name, got, want in zip(("dq", "dk", "dv"), r["grads"],
                               flash_attention_bwd_plain(q, k, v, out, lse, do)):
        _close(got, want, name)
    _close(r["dr"], (do * out).sum(-1), "dr")
    assert all(torch.equal(a, c) for a, c in zip(r["grads"], r["again"]))

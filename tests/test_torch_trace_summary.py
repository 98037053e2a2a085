"""`sgdm_tpu_torch/utils/trace_summary.py` on the CPU: a hand-built chrome
trace with known kernels, copies and step marks gives exact categories,
ms a step, top kernels and idle share; the trainer's CPU trace has no
device events; the CLI runs."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from sgdm_tpu_torch.utils import trace_summary

from torch_port_common import one_torch_thread, profiled_cli_run  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]

CONV = "void conv_kernel<0, true, 1>(ConvArgs)"              # the port's (csrc/conv_core.cuh)
F32K = "void f32k::f32_fwd_kernel<64>(F32Args)"             # the port's, in a namespace
CUDNN = "sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc"
GEMM = "nvjet_hsh_128x256_64x4_2x1_v_bz_coopA_NTT"
NCCL = "ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgsStorage<4096ul>)"
ELEM = "void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<float>>"


def _event(name, ts, dur, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 0, "tid": 7}


def _trace():
    """Two steps on the card: the device marks span 0-100 and 100-190 µs."""
    events = [
        _event("ProfilerStep#0", 0, 100, "gpu_user_annotation"),
        _event("ProfilerStep#1", 100, 90, "gpu_user_annotation"),
        _event("ProfilerStep#0", -5, 50, "user_annotation"),
        _event("ProfilerStep#1", 45, 50, "user_annotation"),
        _event("aten::add", 1, 3, "cpu_op"),
        _event(CONV, 0, 30), _event(CONV, 100, 30),
        _event(CUDNN, 40, 20), _event(GEMM, 60, 10), _event(NCCL, 140, 20),
        _event(ELEM, 75, 5), _event(ELEM, 180, 10), _event(F32K, 130, 6),
        _event("Memcpy HtoD (Pageable -> Device)", 35, 10, "gpu_memcpy"),   # overlaps CONV
        _event("Memset (Device)", 165, 5, "gpu_memset"),
    ]
    return {"deviceProperties": [{"id": 0, "name": "NVIDIA H100 80GB HBM3"}],
            "traceEvents": events}


def _old_trace_idle(path) -> dict:
    """`chip_smoke.py trace_idle` as it stood before it moved to `utils/trace_summary.py`."""
    events = json.loads(Path(path).read_text())["traceEvents"]
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset") and "dur" in e)
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


@pytest.fixture
def trace_dir(tmp_path):
    (tmp_path / "trace.json").write_text(json.dumps(_trace()))
    return tmp_path


def test_summary_of_a_known_trace(trace_dir, capsys):
    got = trace_summary.summarize(trace_dir, top=3)
    assert got["device"] == "NVIDIA H100 80GB HBM3"
    assert got["steps"] == 2 and got["step_marks"] == "device"
    assert got["ms_per_step"] == pytest.approx(0.095, abs=1e-12)
    cats = {k: v["ms"] for k, v in got["categories"].items()}
    assert cats == pytest.approx({"port kernels": 0.066, "convolution": 0.020, "gemm": 0.010,
                                  "collective": 0.020, "elementwise / other": 0.015,
                                  "gpu_memcpy": 0.010, "gpu_memset": 0.005}, abs=1e-12)
    assert got["categories"]["port kernels"]["ms_per_step"] == pytest.approx(0.033, abs=1e-12)
    # copies and sets stay out of the top kernels
    assert [(r["name"], r["count"]) for r in got["top"]] == [(CONV, 2), (CUDNN, 1), (NCCL, 1)]
    assert got["top"][0]["ms"] == pytest.approx(0.060, abs=1e-12)
    # busy: 0-30, 35-70, 75-80, 100-136, 140-160, 165-170, 180-190 µs of a 190 µs window
    assert got["device_busy_ms"] == pytest.approx(0.141, abs=1e-12)
    assert got["device_idle_share"] == pytest.approx(49 / 190, abs=1e-12)
    old = _old_trace_idle(trace_dir / "trace.json")
    assert trace_summary.trace_idle(trace_dir) == old
    assert got["device_idle_share"] == old["device_idle_share"]
    out = capsys.readouterr().out
    assert "2 steps, 0.1 ms/step" in out and "[copy engine, may overlap kernels]" in out


def test_host_step_marks_where_the_device_has_none(tmp_path):
    trace = _trace()
    trace["traceEvents"] = [e for e in trace["traceEvents"] if e["cat"] != "gpu_user_annotation"]
    (tmp_path / "trace.json").write_text(json.dumps(trace))
    got = trace_summary.summarize(tmp_path)
    assert got["steps"] == 2 and got["step_marks"] == "host"
    assert got["ms_per_step"] == pytest.approx(0.050, abs=1e-12)


def test_trainer_cpu_trace_has_no_device_events(tmp_path, capsys, one_torch_thread):
    profile_dir = profiled_cli_run(tmp_path / "run")
    capsys.readouterr()
    assert trace_summary.main([str(profile_dir)]) == 0
    assert capsys.readouterr().out.strip() == "no device events found"
    assert trace_summary.summarize(profile_dir) == {"device_events": 0}
    assert trace_summary.trace_idle(profile_dir / "trace.json") == {"device_events": 0}


def test_cli_entry(trace_dir):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-m", "sgdm_tpu_torch.utils.trace_summary",
                          str(trace_dir), "2"], capture_output=True, text=True, env=env,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.splitlines()
    assert lines[0].startswith("== NVIDIA H100 80GB HBM3: 2 steps")
    assert lines[-2].endswith(CONV) and lines[-1].endswith(CUDNN)
    bad = subprocess.run([sys.executable, "-m", "sgdm_tpu_torch.utils.trace_summary"],
                         capture_output=True, text=True, env=env, timeout=120)
    assert bad.returncode == 2 and "usage" in bad.stderr


@pytest.mark.parametrize("kernel", [
    "conv_kernel", "gn_coef_kernel", "wgrad_kernel", "gn_bwd_kernel", "colsum_kernel",
    "attn_kernel", "attn_pp_kernel", "attn_bwd_kernel", "f32_fwd_kernel", "f32_bwd_kernel",
    "f32_fwd_tile_kernel", "f32_bwd_tile_kernel", "null_kv_kernel", "gn_cluster_kernel",
    "gn_split_stats_kernel", "gn_split_apply_kernel", "adamw_ema_kernel"])
def test_every_csrc_kernel_is_the_ports(kernel):
    """Every `__global__` function of csrc/ reads as the port's, templated,
    in a namespace or not; a library kernel whose name holds one does not."""
    for name in (f"void {kernel}<0, 1, false>(Args)", f"void ns::{kernel}(Args)"):
        assert trace_summary.categorize({"cat": "kernel", "name": name}) == "port kernels"
    assert trace_summary.categorize({"cat": "kernel", "name": f"void my_{kernel}<1>(A)"}) != \
        "port kernels"

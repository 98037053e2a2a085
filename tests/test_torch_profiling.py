"""`sgdm_tpu_torch/utils/profiling.py` against `sgdm_tpu/utils/profiling.py`
on the CPU: `block_timer`'s calls and arithmetic, `trace`'s chrome trace
with its step marks, and the trainer's ``profile=true`` trace."""

import itertools
import json
import time

import jax.numpy as jnp
import pytest
import torch

from sgdm_tpu.utils import profiling as jax_profiling
from sgdm_tpu_torch.utils import profiling

from torch_port_common import one_torch_thread, profiled_cli_run  # noqa: F401


@pytest.mark.parametrize("iters,warmup", [(10, 2), (3, 0), (1, 4)])
def test_block_timer_matches_jax(monkeypatch, iters, warmup):
    """The same calls (warm-up + iterations) and the same mean seconds a call
    under one patched clock."""
    got = {}
    for name, timer, value in (("jax", jax_profiling.block_timer, lambda: jnp.ones(2)),
                               ("port", profiling.block_timer, lambda: torch.ones(2))):
        clock = itertools.count(0.0, 1.5)
        monkeypatch.setattr(time, "perf_counter", lambda: next(clock))
        calls = []

        def fn(x, scale=1.0):
            calls.append((x, scale))
            return value()

        seconds = timer(fn, 7, iters=iters, warmup=warmup, scale=2.0)
        got[name] = (seconds, calls)
    assert got["port"] == got["jax"]
    assert got["port"][0] == 1.5 / iters and len(got["port"][1]) == iters + warmup


def test_trace_writes_a_chrome_trace_with_step_marks(tmp_path, one_torch_thread):
    x = torch.randn(16, 16)
    with profiling.trace(tmp_path / "profile", device="cpu") as prof:
        for i in range(3):
            if i:
                prof.step()
            (x @ x).relu().sum()
    events = json.loads((tmp_path / "profile" / "trace.json").read_text())["traceEvents"]
    marks = sorted(e["name"] for e in events if e.get("cat") == "user_annotation"
                   and e["name"].startswith(profiling.STEP_MARK))
    assert marks == ["ProfilerStep#0", "ProfilerStep#1", "ProfilerStep#2"]
    assert any(e.get("name") == "aten::mm" for e in events)


def test_trainer_profile_trace_marks_its_steps(tmp_path, one_torch_thread):
    """`python -m sgdm_tpu_torch.main --device cpu … profile=true`: the trace
    of steps 2-3 of epoch 1 at <log_dir>/profile/trace.json, one mark a step,
    each holding that step's ops."""
    trace = json.loads((profiled_cli_run(tmp_path / "run") / "trace.json").read_text())
    events = trace["traceEvents"]
    marks = sorted((e for e in events if e.get("cat") == "user_annotation"
                    and e["name"].startswith(profiling.STEP_MARK)), key=lambda e: e["ts"])
    assert [e["name"] for e in marks] == ["ProfilerStep#0", "ProfilerStep#1"]
    for m in marks:
        inside = [e for e in events if e.get("cat") == "cpu_op"
                  and m["ts"] <= e["ts"] <= m["ts"] + m["dur"]]
        assert any(e["name"] == "aten::convolution_backward" for e in inside)

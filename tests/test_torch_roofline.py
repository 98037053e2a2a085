"""`sgdm_tpu_torch/utils/roofline.py` on the CPU: the kernel cost functions
against PERF.md's kernel-table bounds; an audited step's rows (operand +
result bytes, `FlopCounterMode`'s FLOPs, views left out, every operator's
time in one row); the attribution of a card's trace (kernel wrappers'
launches, an operator's kernels, annotations, the unattributed row) on a
hand-built event tree; the CLI's modes at a tiny width."""

import math
from types import SimpleNamespace

import pytest
import torch
import torch.nn.functional as F
from torch.autograd import DeviceType
from torch.utils.flop_counter import FlopCounterMode

import chip_smoke as cs
from sgdm_tpu_torch import ops
from sgdm_tpu_torch.utils import roofline as rl

from torch_port_common import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _per_step_bounds() -> dict:
    """Bound ms a step (sampling: a UNet forward at model batch 128;
    training: a train step at batch 128) of every row of PERF.md's table."""
    b = cs.MODEL_BATCH
    k1 = sum(n * rl.resblock_cost(b, h, w, ci, co, None, ci != co).bound()[0]
             for h, w, ci, co, n in cs.K1_SHAPES)
    k2 = sum(rl.resblock_cost(b, h, h, c, c, rs).bound()[0] for h, c, rs in cs.K2_SHAPES)
    return dict(
        K1=k1, K2=k2, K3=cs.K3_CALLS * rl.attention_cost(*cs.K3_SHAPE).bound()[0],
        K7=cs.K7_CALLS * rl.null_kv_cost(*cs.K7_SHAPE).bound()[0],
        K9_fwd_f32=cs.CLS_K9 * rl.attention_cost(*cs.K9_F32_SHAPE, itemsize=4,
                                                 lse=True).bound()[0],
        K9_bwd_f32=cs.CLS_K9 * rl.attention_bwd_cost(*cs.K9_F32_SHAPE, itemsize=4).bound()[0],
        **{f"path_{k}": v for k, v in cs.train_path_bounds().items()})


@pytest.mark.parametrize("row,printed,digits", [
    ("K1", 7.07, 2), ("K2", 2.66, 2), ("K3", 0.240, 3), ("path_resblock_train", 7.07, 2),
    ("path_resblock_bwd", 14.14, 2), ("path_adamw_ema", 0.798, 3),
    ("path_flash_attention_fwd", 0.242, 3), ("path_flash_attention_bwd", 0.483, 3),
    ("K7", 0.136, 3), ("K9_fwd_f32", 0.769, 3), ("K9_bwd_f32", 1.923, 3),
])
def test_cost_functions_reproduce_the_kernel_table(row, printed, digits):
    """PERF.md §5's bound column (K1 … K9, chip_smoke `kernels` at model batch
    128) to its printed precision, from `utils/roofline.py`'s functions."""
    assert round(_per_step_bounds()[row], digits) == printed


def test_cost_bound_by():
    """Which side bounds each kernel, as the table says."""
    assert rl.resblock_cost(128, 64, 64, 128, 128).bound()[1] == "operations"
    assert rl.resblock_bwd_cost(128, 64, 64, 128, 128, False).bound()[1] == "operations"
    assert rl.attention_cost(*cs.K3_SHAPE).bound()[1] == "bytes"
    assert rl.adamw_ema_cost(cs.N_PARAMS_IN64).bound()[1] == "bytes"
    assert rl.attention_bwd_cost(*cs.K9_F32_SHAPE, itemsize=4).bound()[1] == "operations"


def _known_step():
    a, b = torch.randn(32, 48), torch.randn(48, 16)
    x, w = torch.randn(2, 3, 8, 8), torch.randn(4, 3, 3, 3)

    def step(state, batch, seed=0):
        y = a @ b                       # aten::mm
        F.conv2d(x, w, padding=1)       # aten::convolution
        y[:4].sum()                     # aten::slice (a view), then aten::sum of 4 × 16
        y.t().contiguous()              # aten::t (a view), then aten::clone
        return state, {}

    return step, SimpleNamespace(params=torch.zeros(1))


def test_rows_count_operands_results_and_flops():
    step, state = _known_step()
    out = rl.audit_train_step(step, state, [None], steps=2)
    rows = {r["name"]: r for r in out["rows"]}
    f32 = 4 / 1e9
    mm = rows["aten::mm"]
    assert mm["gb"] == pytest.approx((32 * 48 + 48 * 16 + 32 * 16) * f32, rel=1e-12)
    assert mm["written_gb"] == pytest.approx(32 * 16 * f32, rel=1e-12)
    assert mm["gflop"] == pytest.approx(2 * 32 * 48 * 16 / 1e9, rel=1e-12)
    assert mm["calls"] == 2          # in the traced window of 2 steps
    with FlopCounterMode(display=False) as fc:
        F.conv2d(torch.randn(2, 3, 8, 8), torch.randn(4, 3, 3, 3), padding=1)
    conv = rows["aten::convolution"]
    assert conv["gflop"] == pytest.approx(fc.get_total_flops() / 1e9, rel=1e-12)
    assert conv["gb"] == pytest.approx((2 * 3 * 64 + 4 * 27 + 2 * 4 * 64) * f32, rel=1e-12)
    # a view counts at its own size (4 of y's 32 rows), not its storage's
    assert rows["aten::sum"]["gb"] == pytest.approx((4 * 16 + 1) * f32, rel=1e-12)
    assert rows["aten::clone"]["gb"] == pytest.approx(2 * 32 * 16 * f32, rel=1e-12)
    # the bound: the f32 product's operations at the f32 peak, bytes at 3.35 TB/s
    assert mm["bound_ms"] == pytest.approx(max(mm["gb"] * 1e9 / rl.HBM_BYTES_PER_S,
                                               mm["gflop"] * 1e9 / rl.F32_FLOP_PER_S) * 1e3,
                                           rel=1e-12)


def test_views_have_no_row():
    step, state = _known_step()
    names = {r["name"] for r in rl.audit_train_step(step, state, [None], steps=1)["rows"]}
    assert {"aten::mm", "aten::convolution", "aten::sum", "aten::clone"} <= names
    assert not names & {"aten::t", "aten::slice", "aten::view", "aten::transpose"}


def test_every_operator_with_time_lands_in_one_row():
    """On the CPU every event's self time is in one row or the unattributed
    one, and their sum is the window's."""
    from torch.profiler import ProfilerActivity, profile

    step, state = _known_step()
    out = rl.audit_train_step(step, state, [None], steps=3)
    assert out["rows_ms"] + out["unattributed"]["ms"] == pytest.approx(out["device_ms"],
                                                                       rel=1e-12)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(state, None)
    events = prof.events()
    att = rl.attribute(events, {"aten::mm", "aten::convolution", "aten::sum", "aten::clone"},
                       device=False)
    total = sum(e.self_cpu_time_total for e in events if not e.is_async)
    assert att["total_us"] == pytest.approx(total, rel=1e-12)
    assert sum(r["us"] for r in att["rows"].values()) + att["unattributed_us"] == \
        pytest.approx(total, rel=1e-12)


def test_an_in_place_gradient_sum_takes_its_out_of_place_row():
    """The autograd engine sums the two gradients of ``y`` in place
    (``aten::add_``) in the traced steps but out of place (``aten::add``)
    under the accounting pass's dispatch mode: the sum is the ``aten::add``
    row's, beside the forward's add."""
    x = torch.randn(64, 64, requires_grad=True)

    def step(state, batch, seed=0):
        y = x * 2
        torch.autograd.grad((y.sin() + y.cos()).sum(), x)
        return state, {}

    out = rl.audit_train_step(step, SimpleNamespace(params=torch.zeros(1)), [None], steps=2)
    rows = {r["name"]: r for r in out["rows"]}
    assert "aten::add_" not in rows
    assert rows["aten::add"]["calls"] == 2 * 2     # the forward's add and the gradient sum
    assert rl._row_name("aten::add_", {"aten::add"}) == "aten::add"
    assert rl._row_name("aten::copy_", {"aten::copy_"}) == "aten::copy_"
    assert rl._row_name("aten::mul_", {"aten::add"}) is None


class _Ev(SimpleNamespace):
    """A `FunctionEvent` as `attribute` reads it."""

    def __init__(self, name, start, end, parent=None, device=False, id=0, linked=0):
        super().__init__(name=name, time_range=SimpleNamespace(start=start, end=end),
                         cpu_parent=parent, is_async=False, id=id, linked_correlation_id=linked,
                         device_type=DeviceType.CUDA if device else DeviceType.CPU,
                         self_cpu_time_total=0.0)


def test_attribution_of_a_card_trace():
    """A kernel wrapper's range owns the kernels launched inside it, those
    its aten calls launched included, even where an autograd node encloses
    it; an aten kernel goes to its outermost operator the accounting pass
    saw; device annotations are skipped; a launch under nothing is
    unattributed; each kernel counts once."""
    node = _Ev("_ResBlockTrainBackward", 0, 100)
    rng = _Ev("sgdm::resblock_bwd", 10, 90, node)
    to = _Ev("aten::to", 20, 30, rng, id=101)
    lin = _Ev("aten::linear", 100, 140)
    addmm = _Ev("aten::addmm", 105, 135, lin, id=102)
    cpu = [node, rng, to, lin, addmm,
           _Ev("cudaLaunchKernel", 40, 41, None, id=7),        # ctypes launch: no parent
           _Ev("cudaLaunchKernel", 25, 26, to, id=8),
           _Ev("cudaLaunchKernel", 110, 111, addmm, id=9),
           _Ev("cudaLaunchKernel", 150, 151, None, id=10),     # outside every range
           _Ev("cudaMemcpyAsync", 160, 161, None, id=11)]
    dev = [_Ev("void wgrad_kernel<9>(WgradArgs)", 200, 260, device=True, id=7),
           _Ev("void at::native::copy_kernel", 260, 262, device=True, id=8, linked=101),
           _Ev("nvjet_gemm", 262, 300, device=True, id=9, linked=102),
           _Ev("void mystery_kernel", 300, 305, device=True, id=10),
           _Ev("Memcpy DtoD", 305, 306, device=True, id=11),
           _Ev("sgdm::resblock_bwd", 200, 262, device=True, id=12)]   # gpu_user_annotation
    att = rl.attribute(cpu + dev, {"aten::to", "aten::addmm"}, device=True)
    assert att["rows"] == {"resblock_bwd": dict(us=62.0, kernels=2, calls=1),
                           "aten::addmm": dict(us=38.0, kernels=1, calls=1)}
    assert (att["unattributed_us"], att["unattributed_kernels"]) == (6.0, 2)
    assert att["total_us"] == 106.0


def test_attribution_by_the_kernels_an_operator_holds():
    """Where a kernel event has neither a launch event nor a link (older
    profilers keep no ``linked_correlation_id``), the operator whose
    ``kernels`` list holds it by name and duration owns it, each entry once."""
    mul = _Ev("aten::mul", 0, 10, id=201)
    mul.kernels = [SimpleNamespace(name="void mul_kernel", duration=5.0)] * 2
    dev = [_Ev("void mul_kernel", 100, 105, device=True, id=31),
           _Ev("void mul_kernel", 105, 110, device=True, id=32),
           _Ev("void mul_kernel", 110, 115, device=True, id=33)]
    for d in dev:
        del d.linked_correlation_id
    att = rl.attribute([mul] + dev, {"aten::mul"}, device=True)
    assert att["rows"] == {"aten::mul": dict(us=10.0, kernels=2, calls=1)}
    assert (att["unattributed_us"], att["unattributed_kernels"]) == (5.0, 1)
    assert att["unattributed_names"] == {"void mul_kernel": 1}


def test_kernel_ranges_swap_and_restore_every_wrapper():
    """Inside `kernel_ranges` each wrapper's module name is a `_Ranged` whose
    ``launches`` is the wrapper's own count; outside, the wrappers again."""
    import sys

    originals = dict(ops._WRAPPERS)
    with rl.kernel_ranges():
        for name, fn in originals.items():
            ranged = getattr(sys.modules[fn.__module__], fn.__name__)
            assert isinstance(ranged, rl._Ranged) and ranged.fn is fn
            before = fn.launches
            ranged.launches += 1
            assert fn.launches == before + 1
            fn.launches = before
    for name, fn in originals.items():
        assert getattr(sys.modules[fn.__module__], fn.__name__) is fn
    assert ops._WRAPPERS == originals


@pytest.mark.parametrize("mode", ["fused", "xla", "sample"])
def test_cli_modes_at_a_tiny_width(mode, capsys):
    out = rl.main(["--mode", mode, "--device", "cpu", "--batch-size", "2", "--image-size", "16",
                   "--model-channels", "16", "--cond-dim", "10", "--iters", "1",
                   "--num-steps", "2", "--top", "5"])
    text = capsys.readouterr().out
    assert "operator" in text and rl.UNATTRIBUTED in text and "(remaining" in text
    assert out["rows"] and all(r["ms"] > 0 and math.isfinite(r["gb"]) for r in out["rows"])
    assert out["rows_ms"] + out["unattributed"]["ms"] == pytest.approx(out["device_ms"],
                                                                       rel=1e-9)
    names = {r["name"] for r in out["rows"]}
    if mode == "sample":
        assert out["reps"] == 1 and all("execs" in r for r in out["rows"])
        assert "%dev" in text
    else:
        assert {"aten::convolution", "aten::convolution_backward"} <= names
        assert "%step" in text

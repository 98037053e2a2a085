"""Per-operator device time against its bound: the roofline audit of the
fused train step and of the DDIM sampler.  The port's counterpart of
`sgdm_tpu/utils/roofline.py`.

    python -m sgdm_tpu_torch.utils.roofline [--mode fused|xla|pallas|sample]
        [--batch-size N] [--num-steps K] [--iters I] [--top T] [--device cuda|cpu]

prints, for a train step (``--batch-size`` 192 by default) or a guided DDIM
sample (64 images, ``--num-steps`` 50, cond_scale 2.0: the model batch is
doubled), the table

    operator | GB | GFLOP | ms | bound ms | of bound | GB/s | % of step [| execs]

and two traffic totals: "written" (results only: a floor) and "operand +
result" (an upper bound: a tensor read by two operators counts twice).
Modes: ``fused`` is `train.build` (K4, K5, K9 and K8); ``xla`` the same step
with every kernel off (`models.layers.set_kernels`); ``pallas`` the same
kernels with the update outside any kernel (the optax-order update that
`bench.py build` takes by default: the port maps both of the JAX package's
kernel modes in training onto one route, `models/layers.py`); ``sample``
`training.state.make_sample_fn` at `bench.py bench_ddim`'s shape (K1, K2,
K3).  The weights are seeded random ones.  `audit_train_step` and
`audit_sample_step` audit a step or sampler the caller built.

Where the port differs from the JAX version, and why.  The port has no HLO,
so JAX's `hlo_traffic` / `_shape_bytes` parser has no counterpart:

  * rows are the operators that launch device work: an aten operator, or
    one of the port's kernel wrappers (`ops._WRAPPERS`).  A row's ms is the
    device time of the kernels it launched, from the `torch.profiler` event
    tree.  A kernel belongs to the wrapper whose range holds its launch,
    else to the outermost operator above its launch that the accounting
    pass saw (an in-place operator it saw out of place by its out-of-place
    form: the autograd engine's gradient sums); a kernel under neither is in the "(unattributed)" row, which
    is printed, never dropped.  The wrappers launch through ctypes, below
    the dispatcher: for the audit only, each is swapped at its call site
    for one that opens a ``sgdm::<kernel>`` range around the call;
  * bytes are each call's operands and results (each distinct tensor once,
    a view at its own size), counted in one extra untimed pass of the same
    step under a `TorchDispatchMode`, and FLOPs those `FlopCounterMode`
    counts in that pass.  A wrapper's row takes its kernel's own traffic and
    FLOPs (the cost functions below: each input read once, each output
    written once, outputs written in place included) and owns the aten
    operators it calls.  Only operators that launched a kernel in the trace
    keep a row, so views, reshapes and allocations drop out (JAX's audit
    intersects HLO names with traced names alike);
  * the bound: JAX's table is bytes only, but on this card the
    convolutions and attention are bound by operations, so a row's bound is
    the sum over its calls of max(bytes / HBM_BYTES_PER_S, FLOPs / peak) at
    the peak of the call's operand type (`bound_ms`).
  * JAX's ``--param-dtype`` (a cast of the sampler's weights) has no
    counterpart: the port's `make_sample_fn` takes no such cast.

One thread launches at a time in an audited step (the autograd engine's
runs while the caller waits), so a launch inside a wrapper's range is the
wrapper's.  On ``--device cpu`` (the tests) a row's ms is its operators'
CPU self time; the bound is the card's all the same.
"""

from __future__ import annotations

import argparse
import bisect
import collections
import contextlib
import inspect
import sys
import time
from typing import Any, Callable, NamedTuple

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from ..device import resolve_device
from .trace_summary import STEP_MARK

__all__ = ["HBM_BYTES_PER_S", "BF16_FLOP_PER_S", "TF32_FLOP_PER_S", "F32_FLOP_PER_S",
           "bound_ms", "Cost", "resblock_cost", "resblock_bwd_cost", "attention_cost",
           "attention_bwd_cost", "null_kv_cost", "groupnorm_cost", "adamw_ema_cost",
           "kernel_ranges", "attribute", "audit_train_step", "audit_sample_step", "main"]

HBM_BYTES_PER_S = 3.35e12     # H100 SXM's published device memory rate
BF16_FLOP_PER_S = 989e12      # H100 SXM's published dense bf16 tensor-core peak
TF32_FLOP_PER_S = 495e12      # H100 SXM's published dense TF32 tensor-core peak
F32_FLOP_PER_S = 67e12        # H100 SXM's published f32 peak outside the tensor cores

RANGE = "sgdm::"              # the range a kernel wrapper's call opens in an audit
UNATTRIBUTED = "(unattributed)"
_ANNOTATIONS = (RANGE, STEP_MARK)
# operators that move no data: allocations and reshapes (views are told by their schema)
_NO_WORK = {"aten::empty", "aten::empty_like", "aten::empty_strided", "aten::new_empty",
            "aten::new_empty_strided", "aten::_unsafe_view", "aten::lift_fresh"}


def bound_ms(nbytes: float, flops: float, peak: float = BF16_FLOP_PER_S) -> tuple[float, str]:
    """The least time of moving ``nbytes`` and doing ``flops`` at ``peak``,
    ms, and which of the two bounds it."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


class Cost(NamedTuple):
    """One kernel call: bytes moved (each input read once, each output
    written once), of them written, operations and the peak they run at."""
    nbytes: float
    written: float
    flops: float
    peak: float = BF16_FLOP_PER_S

    def bound(self) -> tuple[float, str]:
        return bound_ms(self.nbytes, self.flops, self.peak)


# ------------------------------------------------------------- kernel costs

def resblock_cost(b, h, w, cin, cout, resample=None, proj=False, residuals=False) -> Cost:
    """K1 / K2 (and K4 with ``residuals``: h2 in f32 and the GN mean and rstd
    of x and h2 are written too) on bf16 x [b, h, w, cin]."""
    ho, wo = (h // 2, w // 2) if resample == "down" else (
        (2 * h, 2 * w) if resample == "up" else (h, w))
    nw = 9 * cin * cout + 9 * cout * cout + (cin * cout if proj else 0)
    written = b * ho * wo * cout * 2
    nbytes = (b * h * w * cin * 2 + written + 2 * nw + 2 * b * cout * 2
              + 4 * (2 * cin + 4 * cout + (cout if proj else 0)))
    if residuals:
        saved = b * ho * wo * cout * 4 + 2 * b * (cin + cout) * 4
        nbytes, written = nbytes + saved, written + saved
    return Cost(nbytes, written, 2.0 * b * ho * wo * nw)


def resblock_bwd_cost(b, h, w, cin, cout, proj) -> Cost:
    """K5: its four gradient convolutions (and the skip's two) are twice the
    forward's products; bytes: read x, dout, h2, the weights, FiLM and GN
    statistics once, write dx, the weight gradients (f32) and dFiLM."""
    nw = 9 * cin * cout + 9 * cout * cout + (cin * cout if proj else 0)
    written = b * h * w * cin * 2 + nw * 4 + 2 * b * cout * 2 + 2 * 4 * (cin + cout)
    nbytes = (b * h * w * (cin * 2 + cout * 2 + cout * 4) + b * h * w * cin * 2
              + nw * (2 + 4) + 2 * b * cout * (2 + 2) + 2 * b * (cin + cout) * 4
              + 4 * 4 * (cin + cout))
    return Cost(nbytes, written, 2.0 * b * 2 * h * w * nw)


def _peak(itemsize: int) -> float:
    return BF16_FLOP_PER_S if itemsize == 2 else F32_FLOP_PER_S


def attention_cost(b, nh, n, d, itemsize=2, lse=False) -> Cost:
    """K3 (``lse``: K9's forward, which also writes the f32 row log-sum-exp):
    q, k, v read and out written once, 4·N²·D operations a head."""
    out = b * nh * n * d * itemsize + (b * nh * n * 4 if lse else 0)
    return Cost(3 * b * nh * n * d * itemsize + out, out, 4.0 * b * nh * n * n * d,
                _peak(itemsize))


def attention_bwd_cost(b, nh, n, d, itemsize=2) -> Cost:
    """K9's backward: q, k, v, o, dO and the lse read, dq, dk, dv written once;
    P recomputed (2N²D), dV, dP, dQ, dK (2N²D each) a head."""
    written = 3 * b * nh * n * d * itemsize
    return Cost(5 * b * nh * n * d * itemsize + b * nh * n * 4 + written, written,
                10.0 * b * nh * n * n * d, _peak(itemsize))


def null_kv_cost(b, n, h, d, m) -> Cost:
    """K7: q [b, n, h, d] against k, v [b, m, d], bf16."""
    written = b * n * h * d * 2
    return Cost(2 * (b * n * h * d + b * m * d) * 2, written, 4.0 * b * h * n * m * d)


def groupnorm_cost(b, h, w, c, film, itemsize=2) -> Cost:
    """K6: x read and y written once, the affine (f32) and FiLM (bf16) read;
    ≈10 f32 operations an element."""
    written = b * h * w * c * itemsize
    return Cost(b * h * w * c * itemsize + written + 2 * c * 4 + (2 * b * c * 2 if film else 0),
                written, 10.0 * b * h * w * c, F32_FLOP_PER_S)


def adamw_ema_cost(n) -> Cost:
    """K8 over n f32 parameters: p, g, μ, ν, EMA read, p, μ, ν, EMA written."""
    return Cost(36.0 * n, 16.0 * n, 15.0 * n, F32_FLOP_PER_S)


def _wrapper_cost(name: str, fn: Callable, args: tuple, kwargs: dict) -> Cost:
    """The cost of one call of the kernel wrapper ``name`` from its arguments."""
    p = inspect.signature(fn).bind(*args, **kwargs).arguments
    if name.startswith("resblock"):
        x = p["x"]
        b, h, w, cin = x.shape
        if name == "resblock_bwd":
            return resblock_bwd_cost(b, h, w, cin, p["w1"].shape[-1], p.get("skip_w") is not None)
        return resblock_cost(b, h, w, cin, p["w1"].shape[-1], p.get("resample"),
                             p.get("skip_w") is not None, residuals=name == "resblock_train")
    if name == "self_attention" or name.startswith("flash_attention"):
        q = p["q"]
        if "_bwd" in name:
            return attention_bwd_cost(*q.shape, itemsize=q.element_size())
        return attention_cost(*q.shape, itemsize=q.element_size(), lse=name != "self_attention")
    if name == "null_kv_attention":
        b, n, h, d = p["q"].shape
        return null_kv_cost(b, n, h, d, p["k"].shape[1])
    if name == "groupnorm_silu":
        x = p["x"]
        return groupnorm_cost(*x.shape, p.get("film_scale") is not None, x.element_size())
    if name == "adamw_ema":
        return adamw_ema_cost(p["p"].numel())
    raise KeyError(f"no cost function for kernel {name!r}")


# ------------------------------------------------------------- accounting

class _Rows(dict):
    """Accounting-pass rows: name → calls, bytes, written, FLOPs, bound."""

    def add(self, name: str, cost: Cost) -> None:
        r = self.setdefault(name, dict(calls=0, nbytes=0.0, written=0.0, flops=0.0,
                                       bound_ms=0.0, by={"bytes": 0.0, "operations": 0.0}))
        bnd, by = cost.bound()
        r["calls"] += 1
        r["nbytes"] += cost.nbytes
        r["written"] += cost.written
        r["flops"] += cost.flops
        r["bound_ms"] += bnd
        r["by"][by] += bnd


def _unique_bytes(tensors) -> int:
    seen, n = set(), 0
    for t in tensors:
        key = (t.data_ptr(), tuple(t.shape), tuple(t.stride()), t.dtype)
        if key not in seen:
            seen.add(key)
            n += t.numel() * t.element_size()
    return n


def _tensors(tree) -> list:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _op_peak(name: str, tensors) -> float:
    """The card's peak for an operator on these operands: bf16 / f16 on the
    tensor cores; f32 at TF32 where cuDNN or cuBLAS may take it, else on the
    f32 units."""
    for t in tensors:
        if t.is_floating_point():
            if t.dtype in (torch.bfloat16, torch.float16):
                return BF16_FLOP_PER_S
            tf32 = (torch.backends.cudnn.allow_tf32 if "conv" in name
                    else torch.backends.cuda.matmul.allow_tf32)
            return TF32_FLOP_PER_S if tf32 and t.dtype == torch.float32 else F32_FLOP_PER_S
    return F32_FLOP_PER_S


class _Account(TorchDispatchMode):
    """Counts each aten call's operand + result bytes and `FlopCounterMode`'s
    FLOPs (the mode below this one) by operator; calls inside a kernel
    wrapper (``depth`` > 0) are the wrapper's; views (a result on an
    operand's storage where the schema lets it alias), allocations and
    reshapes get no row."""

    def __init__(self, flops: FlopCounterMode):
        super().__init__()
        self.rows, self.depth, self.flops = _Rows(), 0, flops

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        schema = func._schema
        if self.depth or schema.name in _NO_WORK:
            return func(*args, **kwargs)
        before = self.flops.get_total_flops()
        out = func(*args, **kwargs)
        flops = self.flops.get_total_flops() - before
        operands, results = _tensors((args, kwargs)), _tensors(out)
        if any(r.alias_info is not None and not r.alias_info.is_write for r in schema.returns):
            storages = {t.untyped_storage().data_ptr() for t in operands}
            if all(t.untyped_storage().data_ptr() in storages for t in results):
                return out
        mutated = []
        for i, arg in enumerate(schema.arguments):
            if arg.alias_info is not None and arg.alias_info.is_write:
                mutated += _tensors(args[i] if i < len(args) else kwargs.get(arg.name))
        name = schema.name
        self.rows.add(name, Cost(_unique_bytes(operands + results),
                                 _unique_bytes(results + mutated), flops,
                                 _op_peak(name, operands)))
        return out


class _Ranged:
    """A kernel wrapper at its call site: opens ``sgdm::<name>`` around the
    call, or in the accounting pass counts the call's cost and makes the
    aten calls inside it the wrapper's.  ``launches`` is the wrapper's own
    count (the wrapper adds to it through the name it finds here)."""

    def __init__(self, name: str, fn: Callable, account: _Account | None):
        self.name, self.fn, self.account = name, fn, account

    @property
    def launches(self) -> int:
        return self.fn.launches

    @launches.setter
    def launches(self, value: int) -> None:
        self.fn.launches = value

    def __call__(self, *args, **kwargs):
        acct = self.account
        if acct is None:
            with record_function(RANGE + self.name):
                return self.fn(*args, **kwargs)
        acct.depth += 1
        try:
            out = self.fn(*args, **kwargs)
        finally:
            acct.depth -= 1
        acct.rows.add(self.name, _wrapper_cost(self.name, self.fn, args, kwargs))
        return out


@contextlib.contextmanager
def kernel_ranges(account: _Account | None = None):
    """Every kernel wrapper of `ops._WRAPPERS` swapped, in the module whose
    functions call it, for a `_Ranged` one; put back on exit."""
    from .. import ops

    saved = []
    for name, fn in ops._WRAPPERS.items():
        mod = sys.modules[fn.__module__]
        saved.append((mod, fn.__name__, fn))
        setattr(mod, fn.__name__, _Ranged(name, fn, account))
    try:
        yield
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


# ------------------------------------------------------------- attribution

def _row_name(name: str, names) -> str | None:
    """``name``'s row: itself, or for an in-place operator absent from
    ``names`` its out-of-place form.  The autograd engine sums a gradient
    that two uses feed in place (``aten::add_``), but out of place
    (``aten::add``) while a dispatch mode is on, as in the accounting pass."""
    if name in names:
        return name
    if name.endswith("_") and name[:-1] in names:
        return name[:-1]
    return None


def _walk(e, names) -> tuple[str | None, Any]:
    """The row of a CPU event: the kernel wrapper whose range holds it, else
    its outermost ancestor (itself included) with a row in ``names``."""
    row = owner = None
    while e is not None:
        if e.name.startswith(RANGE):
            return e.name[len(RANGE):], e
        if (found := _row_name(e.name, names)) is not None:
            row, owner = found, e
        e = e.cpu_parent
    return row, owner


def attribute(events, names, device: bool) -> dict:
    """Rows of a profiled window: name → us, kernels, calls; plus the window's
    total, the unattributed us and kernels.  ``device``: the card's kernels,
    copies and sets (device events), each once; else the CPU self time of
    every CPU event."""
    cpu = [e for e in events if e.device_type == DeviceType.CPU and not e.is_async]
    rows: dict[str, dict] = {}
    owners: dict[str, set] = {}
    missed: collections.Counter = collections.Counter()   # unattributed kernels by name
    total = lost = lost_n = 0.0

    def add(e, us, row, owner):
        nonlocal lost, lost_n
        if row is None:
            lost, lost_n = lost + us, lost_n + 1
            return
        r = rows.setdefault(row, dict(us=0.0, kernels=0, calls=0))
        r["us"] += us
        r["kernels"] += 1
        owners.setdefault(row, set()).add(id(owner))

    if device:
        ann = {e.name for e in cpu if e.name.startswith(_ANNOTATIONS)
               or getattr(e, "is_user_annotation", False)}
        ranges = sorted((e.time_range.start, e.time_range.end, e) for e in cpu
                        if e.name.startswith(RANGE))
        starts = [r[0] for r in ranges]
        launches = {e.id: e for e in cpu if e.name.startswith("cu")}
        by_id = {e.id: e for e in cpu if not e.name.startswith("cu")}
        # (kernel name, µs) → the operators the profiler hung such a kernel on
        # (`FunctionEvent.kernels`), where a kernel event carries no link
        hung: dict[tuple, list] = {}
        for e in cpu:
            for k in getattr(e, "kernels", ()):
                hung.setdefault((k.name, k.duration), []).append(e)
        for d in events:
            if d.device_type != DeviceType.CUDA or d.name in ann:
                continue
            us = d.time_range.end - d.time_range.start
            total += us
            row = owner = None
            launch = launches.get(d.id)
            linked = getattr(d, "linked_correlation_id", None)
            if launch is not None:
                t = (launch.time_range.start + launch.time_range.end) / 2
                i = bisect.bisect_right(starts, t) - 1
                if i >= 0 and ranges[i][1] >= t:
                    owner = ranges[i][2]
                    row = owner.name[len(RANGE):]
                else:
                    row, owner = _walk(launch.cpu_parent, names)
            if row is None and linked in by_id:
                row, owner = _walk(by_id[linked], names)
            if row is None and hung.get((d.name, us)):
                row, owner = _walk(hung[(d.name, us)].pop(), names)
            if row is None:
                missed[d.name] += 1
            add(d, us, row, owner)
    else:
        for e in cpu:
            us = e.self_cpu_time_total
            if us <= 0:
                continue
            total += us
            row, owner = _walk(e, names)
            add(e, us, row, owner)
    for name, r in rows.items():
        r["calls"] = len(owners[name])
    return dict(rows=rows, total_us=total, unattributed_us=lost, unattributed_kernels=int(lost_n),
                unattributed_names=dict(missed.most_common(5)))


# ------------------------------------------------------------- audits

def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _audit(run: Callable[[int], None], dev: torch.device, reps: int) -> tuple[dict, dict, float]:
    """The accounting pass (one call of ``run``), then ``reps`` calls under
    the profiler: (accounting rows, attribution, wall seconds a call)."""
    with FlopCounterMode(display=False) as fc, _Account(fc) as acct, kernel_ranges(acct):
        run(1)
    _sync(dev)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    with kernel_ranges(), profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run(reps)
        _sync(dev)
        wall = (time.perf_counter() - t0) / reps
    return acct.rows, attribute(prof.events(), set(acct.rows), dev.type == "cuda"), wall


def _table(acct: dict, att: dict, reps: int, ref_ms: float, execs: bool) -> dict:
    """Rows per call (step or sampler call) joined with their accounting."""
    rows = []
    for name, t in att["rows"].items():
        a = acct[name]
        ms = t["us"] / 1e3 / reps
        rows.append(dict(name=name, calls=t["calls"], kernels=t["kernels"], gb=a["nbytes"] / 1e9,
                         written_gb=a["written"] / 1e9, gflop=a["flops"] / 1e9, ms=ms,
                         bound_ms=a["bound_ms"], bound_by=max(a["by"], key=a["by"].get),
                         share_of_bound=a["bound_ms"] / ms if ms > 0 else float("nan"),
                         share_of_step=ms / ref_ms if ref_ms > 0 else float("nan"),
                         **({"execs": t["calls"] / reps} if execs else {})))
    rows.sort(key=lambda r: -r["ms"])
    return dict(rows=rows, device_ms=att["total_us"] / 1e3 / reps,
                rows_ms=sum(r["ms"] for r in rows),
                unattributed=dict(ms=att["unattributed_us"] / 1e3 / reps,
                                  kernels=att["unattributed_kernels"],
                                  names=att["unattributed_names"]),
                written_gb=sum(r["written_gb"] for r in rows), upper_gb=sum(r["gb"] for r in rows))


def _print_rows(out: dict, top: int, ref: str, execs: bool) -> None:
    rows = out["rows"]
    print(f"{'operator':48s} {'GB':>7s} {'GFLOP':>8s} {'ms':>8s} {'bound':>7s} {'%bound':>6s} "
          f"{'GB/s':>6s} {ref:>6s}" + (f" {'execs':>6s}" if execs else ""))
    for r in rows[:top]:
        gbs = r["gb"] / (r["ms"] / 1e3) if r["ms"] > 0 else float("nan")
        print(f"{r['name'][:48]:48s} {r['gb']:7.3f} {r['gflop']:8.1f} {r['ms']:8.3f} "
              f"{r['bound_ms']:7.3f} {r['share_of_bound']:6.1%} {gbs:6.0f} "
              f"{r['share_of_step']:6.1%}" + (f" {r['execs']:6.0f}" if execs else ""))
    rest = rows[top:]
    print(f"{'(remaining ' + str(len(rest)) + ' operators)':48s} "
          f"{sum(r['gb'] for r in rest):7.3f} {sum(r['gflop'] for r in rest):8.1f} "
          f"{sum(r['ms'] for r in rest):8.3f}")
    u = out["unattributed"]
    print(f"{UNATTRIBUTED + ' ' + str(u['kernels']) + ' events':48s} {'':7s} {'':8s} "
          f"{u['ms']:8.3f}")


def audit_train_step(step: Callable, state, batches: list, *, steps: int = 5, seed: int = 0,
                     top: int = 20, title: str = "") -> dict:
    """Audit ``step(state, batch, seed=)``: one accounting step, then
    ``steps`` steps traced (``batches`` in turn).  Prints the table and
    returns its rows a step, the step's wall ms and device ms, the
    unattributed time and both traffic totals."""
    dev = state.params.device
    holder = [state]

    def run(n: int) -> None:
        for i in range(n):
            holder[0], _ = step(holder[0], batches[i % len(batches)], seed=seed)

    acct, att, wall = _audit(run, dev, steps)
    step_ms = wall * 1e3
    out = dict(steps=steps, ms_per_step=step_ms, **_table(acct, att, steps, step_ms, False))
    dt = step_ms / 1e3
    print(f"# {title}{steps} traced steps, {step_ms:.1f} ms/step "
          f"({'kernel' if dev.type == 'cuda' else 'CPU op'} sum {out['device_ms']:.1f} ms)")
    print(f"# traffic: written {out['written_gb']:.2f} GB/step "
          f"({out['written_gb'] / dt:.0f} GB/s, "
          f"{out['written_gb'] * 1e9 / dt / HBM_BYTES_PER_S:.0%} of "
          f"{HBM_BYTES_PER_S / 1e9:.0f} GB/s) · operand+result upper bound "
          f"{out['upper_gb']:.2f} GB/step")
    _print_rows(out, top, "%step", False)
    return out


def audit_sample_step(sample: Callable, *args, device: str | torch.device = "cuda",
                      reps: int = 3, top: int = 20, title: str = "", **kwargs) -> dict:
    """Audit ``sample(*args, **kwargs)``: one accounting call, then ``reps``
    calls traced.  Rows are a call's, with ``execs`` (calls of the operator
    a sampler call) and their share of the call's device time."""
    dev = resolve_device(device)

    def run(n: int) -> None:
        for _ in range(n):
            sample(*args, **kwargs)

    acct, att, wall = _audit(run, dev, reps)
    dev_ms = att["total_us"] / 1e3 / reps
    out = dict(reps=reps, ms_per_call=wall * 1e3, **_table(acct, att, reps, dev_ms, True))
    print(f"# {title}{wall * 1e3:.1f} ms/call traced wall; "
          f"{'kernel' if dev.type == 'cuda' else 'CPU op'} sum {dev_ms:.1f} ms/call")
    print(f"# traffic/call: written {out['written_gb']:.2f} GB · operand+result upper bound "
          f"{out['upper_gb']:.2f} GB ({out['upper_gb'] / max(dev_ms / 1e3, 1e-12):.0f} GB/s "
          f"over device time)")
    _print_rows(out, top, "%dev", True)
    return out


def main(argv: list[str] | None = None) -> dict:
    p = argparse.ArgumentParser(prog="sgdm_tpu_torch.utils.roofline",
                                description="Roofline audit of the train step or DDIM sample.")
    p.add_argument("--mode", choices=["fused", "xla", "pallas", "sample"], default="fused")
    p.add_argument("--batch-size", type=int, default=None, help="192 (train), 64 (sample)")
    p.add_argument("--top", type=int, default=20)
    p.add_argument("--iters", type=int, default=5, help="traced steps or sampler calls")
    p.add_argument("--num-steps", type=int, default=50, help="DDIM steps (sample mode)")
    p.add_argument("--image-size", type=int, default=64)
    p.add_argument("--model-channels", type=int, default=128)
    p.add_argument("--cond-dim", type=int, default=1000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    dev = resolve_device(a.device)
    from .. import train
    from ..models.layers import set_kernels

    if a.mode == "sample":
        from ..diffusion.core import GaussianDiffusion
        from ..models.factory import UNET_FAST_IN64, create_denoiser, init_random_params
        from ..training.state import make_sample_fn

        bs = a.batch_size or 64
        cfg = dict(UNET_FAST_IN64, image_size=a.image_size, cond_dim=a.cond_dim,
                   condition_method=train.CONDITION["unet"], model_channels=a.model_channels)
        model = init_random_params(create_denoiser(dtype=torch.bfloat16, **cfg), a.seed).to(dev)
        sample = make_sample_fn(model, GaussianDiffusion(num_timesteps=1000),
                                sampling_method="ddim", num_steps=a.num_steps, cond_scale=2.0,
                                device=dev)
        gen = torch.Generator(device=dev)
        gen.manual_seed(a.seed)
        ids = torch.randint(0, a.cond_dim, (bs,), generator=gen, device=dev)
        cond = torch.nn.functional.one_hot(ids, a.cond_dim).float()
        return audit_sample_step(
            sample, model, gen, bs, a.image_size, 3, cond=cond, device=dev, reps=a.iters,
            top=a.top, title=f"DDIM sample: bs={bs} (CFG-doubled {2 * bs}) "
                             f"steps={a.num_steps} ch={a.model_channels} {a.image_size}px — ")
    bs = a.batch_size or 192
    run = train.build(bs, a.image_size, a.cond_dim, model_channels=a.model_channels,
                      init="random", seed=a.seed, device=dev)
    step = run["step"]
    if a.mode == "xla":
        set_kernels(run["model"], False)
    elif a.mode == "pallas":
        from ..training.state import make_train_step

        step = make_train_step(run["model"], run["diffusion"], run["tx"],
                               cond_drop_prob=train.COND_DROP_PROB, ema_decay=0.9999,
                               fused_optim=False, device=dev)
    batches = train.make_batches(2, bs, a.image_size, a.cond_dim, dev, a.seed)
    return audit_train_step(step, run["state"], batches, steps=a.iters, seed=a.seed, top=a.top,
                            title=f"mode={a.mode} bs={bs} ch={a.model_channels} "
                                  f"{a.image_size}px — ")


if __name__ == "__main__":
    main()

"""Build and load the hand-written CUDA kernels (`sgdm_tpu_torch/csrc/*.cu`).

Each source is compiled by ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface, which is loaded with `ctypes`.  The
libraries go to ``build/kernels/<hash of sources and flags>/`` at the root
of the checkout, at first CUDA use; all sources are compiled at once, one
``nvcc`` process each, so a cold build takes as long as the slowest file.
Nothing is built when this module is imported.  ``nvcc``'s ``-Xptxas -v``
report (registers, shared memory, spills) is kept beside each library as
``<stem>.log``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

__all__ = ["library", "build_all", "NVCC_FLAGS"]

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built")
    return found


def _sources() -> list[Path]:
    return sorted(_CSRC.glob("*.cu"))


def _build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(_CSRC.iterdir()):
        if src.suffix in (".cu", ".cuh"):
            h.update(src.name.encode())
            h.update(src.read_bytes())
    return _BUILD_ROOT / h.hexdigest()[:16]


def build_all() -> dict[str, float]:
    """Compile every source not yet built, in parallel; returns seconds per source."""
    out_dir = _build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for src in _sources():
        so = out_dir / f"lib{src.stem}.so"
        if so.exists():
            continue
        tmp = out_dir / f".lib{src.stem}.{os.getpid()}.so"
        cmd = [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp), str(src)]
        procs[src.stem] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), tmp, so)
    times = {}
    for stem, (proc, tmp, so) in procs.items():
        log, _ = proc.communicate()
        times[stem] = time.perf_counter() - t0
        (out_dir / f"{stem}.log").write_text(log)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {stem}.cu:\n{log}")
        os.replace(tmp, so)  # atomic: a concurrent build sees all or nothing
    return times


def library(stem: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<stem>.cu`` (built on first use)."""
    with _lock:
        lib = _libs.get(stem)
        if lib is None:
            so = _build_dir() / f"lib{stem}.so"
            if not so.exists():
                build_all()
            lib = ctypes.CDLL(str(so))
            _libs[stem] = lib
        return lib

"""Device resolution that raises instead of falling back.

Entry points take ``device="cuda"`` by default.  With no CUDA device they
raise; only an explicit ``device="cpu"`` (the CPU tests) runs on the host.
"""

from __future__ import annotations

import contextlib

import torch

__all__ = ["resolve_device", "no_tf32"]


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """``device`` as a `torch.device`; raises when CUDA is asked for and absent."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA device requested but torch.cuda.is_available() is False; "
                "pass device='cpu' to run on the host explicitly")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r} (want 'cuda' or 'cpu')")
    return dev


@contextlib.contextmanager
def no_tf32():
    """Matmuls and cuDNN convolutions in full float32 inside the block
    (cuDNN's default is TF32 on Ampere and later)."""
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved

"""Device resolution that raises instead of falling back.

Entry points take ``device="cuda"`` by default.  With no CUDA device they
raise; only an explicit ``device="cpu"`` (the CPU tests) runs on the host.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


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

"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

Nothing here builds or imports a kernel at import time: `build.library`
compiles ``csrc/*.cu`` at the first launch.
"""

from .attention import fused_self_attention, self_attention_cuda, self_attention_plain
from .resblock import fused_resblock, resblock_cuda, resblock_plain, resblock_resample_cuda

__all__ = ["fused_resblock", "resblock_plain", "fused_self_attention",
           "self_attention_plain", "launch_counts", "reset_launch_counts"]

# kernel name -> wrapper carrying its `launches` count
_WRAPPERS = {
    "resblock": resblock_cuda,
    "resblock_resample": resblock_resample_cuda,
    "self_attention": self_attention_cuda,
}


def launch_counts() -> dict[str, int]:
    """Kernel launches (one per call of the wrapper that launches it) by kernel name."""
    return {name: fn.launches for name, fn in _WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in _WRAPPERS.values():
        fn.launches = 0

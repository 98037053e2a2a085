"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

Nothing here builds or imports a kernel at import time: `build.library`
compiles ``csrc/*.cu`` at the first launch.
"""

from .attention import (flash_attention, flash_attention_bwd_cuda, flash_attention_bwd_f32_cuda,
                        flash_attention_fwd_cuda, flash_attention_fwd_f32_cuda,
                        fused_null_kv_attention, fused_self_attention, null_kv_attention_cuda,
                        null_kv_attention_plain, self_attention_cuda, self_attention_plain)
from .fused_optim import adamw_ema_cuda, fused_adamw_ema
from .groupnorm import fused_groupnorm_silu, groupnorm_silu_cuda, groupnorm_silu_plain
from .resblock import (fused_resblock, fused_resblock_train, resblock_bwd_cuda, resblock_cuda,
                       resblock_plain, resblock_resample_cuda, resblock_train_cuda)

__all__ = ["fused_resblock", "fused_resblock_train", "resblock_plain", "fused_self_attention",
           "self_attention_plain", "flash_attention", "fused_adamw_ema",
           "fused_null_kv_attention", "null_kv_attention_plain", "fused_groupnorm_silu",
           "groupnorm_silu_plain", "launch_counts", "reset_launch_counts"]

# kernel name -> wrapper carrying its `launches` count
_WRAPPERS = {
    "resblock": resblock_cuda,
    "resblock_resample": resblock_resample_cuda,
    "self_attention": self_attention_cuda,
    "resblock_train": resblock_train_cuda,
    "resblock_bwd": resblock_bwd_cuda,
    "flash_attention_fwd": flash_attention_fwd_cuda,
    "flash_attention_bwd": flash_attention_bwd_cuda,
    "flash_attention_fwd_f32": flash_attention_fwd_f32_cuda,
    "flash_attention_bwd_f32": flash_attention_bwd_f32_cuda,
    "adamw_ema": adamw_ema_cuda,
    "groupnorm_silu": groupnorm_silu_cuda,
    "null_kv_attention": null_kv_attention_cuda,
}


def launch_counts() -> dict[str, int]:
    """Kernel launches (one per call of the wrapper that launches it) by kernel name."""
    return {name: fn.launches for name, fn in _WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in _WRAPPERS.values():
        fn.launches = 0

"""PyTorch/CUDA port of `sgdm_tpu`, slice by slice.

The package mirrors `sgdm_tpu`'s module layout and names.  It imports
torch and never JAX, and nothing of `sgdm_tpu`: what it needs of the JAX
package's numpy-only helpers it keeps as its own copy.  Every Pallas TPU
kernel on a ported path becomes a hand-written CUDA kernel for Hopper
(`csrc/`, built by `ops/build.py`), with a plain PyTorch version beside it
that CPU tensors take.

Entry points run on the card by default and raise when there is none,
unless the caller asks for ``device="cpu"`` (see `device.py`).
"""

from .device import resolve_device

__all__ = ["resolve_device"]

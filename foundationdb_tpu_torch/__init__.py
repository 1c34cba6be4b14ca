"""foundationdb_tpu_torch: the PyTorch/CUDA port of foundationdb_tpu.

The JAX package (foundationdb_tpu/) stays the reference; this package
mirrors its module paths and function names and imports nothing of it.
Entry points run on the CUDA card unless the caller passes device="cpu".
"""

from .device import resolve_device

__all__ = ["resolve_device"]

"""PyTorch/CUDA port of the SPM reproduction, for one NVIDIA H100.

The JAX package ``repro`` is the reference; this package mirrors its module
layout (``core/``, ``kernels/``, ``layers/``, ``models/``, ``configs/``,
``serve/``, ``launch/``) so each file has an obvious counterpart.  It imports
``torch`` and numpy, never ``jax`` and nothing of ``repro``.

Every SPM linear on the serving path runs through a hand-written CUDA kernel
(``kernels/csrc``): K1, the fused stage-stack forward, and K3, the
norm-to-SPM block forward.  Entry points run on ``cuda`` unless the caller
passes ``device="cpu"``; on CPU tensors the kernel wrappers run their plain
PyTorch versions, which is how the tests compare the port with ``repro``.
"""

from repro_torch.device import kernels_available, resolve_device  # noqa: F401

__all__ = ["kernels_available", "resolve_device"]

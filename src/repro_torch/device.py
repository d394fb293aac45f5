"""Device policy: the card by default, the CPU only when asked for.

``resolve_device(None)`` is ``cuda`` and raises when no GPU is present; it
never carries on quietly on the CPU.  ``resolve_device("cpu")`` is the CPU,
where the kernel wrappers run their plain versions (the tests' path).
"""

from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device", "kernels_available"]

DeviceLike = Union[None, str, torch.device]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another.  Raises ``RuntimeError`` for a CUDA device without a GPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the GPU by default; pass "
            "device='cpu' to run the plain versions on the CPU")
    return dev


def kernels_available(device: Optional[torch.device] = None) -> bool:
    """True when CUDA is present with compute capability >= (9, 0) and the
    hand-written kernels build and load (building them at first call)."""
    if not torch.cuda.is_available():
        return False
    dev = torch.device("cuda" if device is None else device)
    if torch.cuda.get_device_capability(dev) < (9, 0):
        return False
    from repro_torch.kernels import build
    try:
        build.load_all()
    except build.BuildError:
        return False
    return True

"""The feature-sharding context (port of ``repro/parallel/ctx.py``, the
``"feature"`` kind only).

A ``FeatureMesh`` is the port's counterpart of a JAX mesh with one
``"model"`` axis (``repro/launch/mesh.make_host_mesh``): S shards of the
feature axis, each bound to a device.  The executor
(``parallel/spm_shard.py``) keeps one slab per shard and hands a partner's
slab over at a cross stage; in this slice every shard must be on the
input's device, so the hand-over needs no collective.

``activation_sharding(mesh, shard_feature=True)`` makes the mesh active for
the block; ``feature_mesh(n_shards)`` is what ``core/spm.spm_apply`` asks
to decide whether a two_level operator runs sharded.  The reference's other
kinds (heads, batch) are placement hints for XLA with no counterpart in a
one-process port.

The reference decides once, when it traces.  The port decides at every
call, and a checkpointed layer's forward runs again in the backward, on
the autograd engine's thread for the device.  So the context is
per-thread, and ``models/transformer.py`` hands the one of the original
forward to its recompute (``current_context`` / ``use_context``): the
recompute routes every linear as the forward did.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Optional, Tuple

import torch

from repro_torch.device import DeviceLike, resolve_device

__all__ = ["FeatureMesh", "make_feature_mesh", "activation_sharding",
           "feature_mesh", "current_context", "use_context"]

_STATE = threading.local()


@dataclasses.dataclass(frozen=True)
class FeatureMesh:
    """S shards of the feature axis over the ``"model"`` axis; shard j
    lives on ``devices[j]``."""

    devices: Tuple[torch.device, ...]

    @property
    def axis_names(self) -> Tuple[str, ...]:
        """The mesh's one axis, as a JAX mesh's ``axis_names``."""
        return ("model",)

    @property
    def shape(self) -> dict:
        """Axis sizes by name, as a JAX mesh's ``shape``."""
        return {"model": len(self.devices)}


def make_feature_mesh(n_shards: int,
                      device: DeviceLike = None) -> FeatureMesh:
    """A mesh of ``n_shards`` shards, all on ``device`` (``cuda`` unless
    the caller asks for the CPU)."""
    return FeatureMesh((resolve_device(device),) * n_shards)


def _current() -> Optional[dict]:
    return getattr(_STATE, "ctx", None)


def current_context() -> Optional[dict]:
    """This thread's active context (None outside any), for
    ``use_context``."""
    return _current()


@contextlib.contextmanager
def use_context(ctx: Optional[dict]):
    """Make ``ctx`` (from ``current_context``, maybe None) this thread's
    context within the block."""
    prev = _current()
    _STATE.ctx = ctx
    try:
        yield
    finally:
        _STATE.ctx = prev


def activation_sharding(mesh: FeatureMesh, *, shard_feature: bool = False):
    """Make ``mesh`` the active mesh within the block; with
    ``shard_feature`` two_level SPM operators whose ``n_shards`` matches
    it run in the sharded executor."""
    return use_context({"mesh": mesh, "shard_feature": shard_feature})


def feature_mesh(n_shards: Optional[int] = None) -> Optional[FeatureMesh]:
    """The active mesh when feature sharding is on and (when ``n_shards``
    is given) its ``"model"`` axis has that size, else None."""
    ctx = _current()
    if ctx is None or not ctx["shard_feature"]:
        return None
    mesh = ctx["mesh"]
    if n_shards is not None and mesh.shape["model"] != n_shards:
        return None
    return mesh

"""The mesh contexts: feature sharding (port of ``repro/parallel/ctx.py``,
the ``"feature"`` kind only) and a data-parallel pod's axis binding.

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
from typing import Any, List, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.device import DeviceLike, resolve_device

__all__ = ["FeatureMesh", "make_feature_mesh", "activation_sharding",
           "feature_mesh", "current_context", "use_context", "PodMesh",
           "bind_axis", "bound_axis"]

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


POD_AXIS = "pod"


@dataclasses.dataclass
class PodMesh:
    """One rank's view of a data-parallel pod of ``size`` members:
    ``axis_names == ("pod",)``, the rank, its device, the backend and the
    process group (None: the default group)."""

    rank: int
    size: int
    device: torch.device
    backend: Optional[str] = None     # None for a one-member pod
    group: Any = None
    owned: bool = False               # launch.mesh initialised the group

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return (POD_AXIS,)

    @property
    def shape(self) -> dict:
        return {POD_AXIS: self.size}

    def all_reduce(self, t: torch.Tensor, op=dist.ReduceOp.SUM) -> None:
        """In place over the pod; nothing for one member."""
        if self.size > 1:
            dist.all_reduce(t, op=op, group=self.group)

    def barrier(self) -> None:
        if self.size > 1:
            dist.barrier(group=self.group)

    def broadcast_object(self, obj: Any) -> Any:
        """Rank 0's ``obj`` on every rank."""
        if self.size == 1:
            return obj
        box = [obj]
        dist.broadcast_object_list(box, src=self._global(0),
                                   group=self.group)
        return box[0]

    def all_gather_object(self, obj: Any) -> List[Any]:
        """Every rank's ``obj``, in rank order."""
        if self.size == 1:
            return [obj]
        out: List[Any] = [None] * self.size
        dist.all_gather_object(out, obj, group=self.group)
        return out

    def gather_to_root(self, t: torch.Tensor) -> Optional[List[torch.Tensor]]:
        """Every rank's ``t`` on rank 0, in rank order, as CPU tensors (None
        elsewhere).  NCCL gathers on the rank's card, gloo on the host."""
        if self.size == 1:
            return [t.cpu()]
        t = t.to(self.device) if self.backend == "nccl" else t.cpu()
        out = ([torch.empty_like(t) for _ in range(self.size)]
               if self.rank == 0 else None)
        dist.gather(t, out, dst=self._global(0), group=self.group)
        return None if out is None else [x.cpu() for x in out]

    def _global(self, rank: int) -> int:
        return (rank if self.group is None
                else dist.get_global_rank(self.group, rank))

    def close(self) -> None:
        """Tear down the group when ``launch.mesh`` made it."""
        if self.owned and dist.is_initialized():
            dist.destroy_process_group()
            self.owned = False


def _axes() -> dict:
    axes = getattr(_STATE, "axes", None)
    if axes is None:
        axes = _STATE.axes = {}
    return axes


@contextlib.contextmanager
def bind_axis(mesh: PodMesh, name: str = POD_AXIS):
    """Bind axis ``name`` to ``mesh`` for this thread's collectives inside
    the block."""
    axes = _axes()
    saved = axes.get(name)
    axes[name] = mesh
    try:
        yield mesh
    finally:
        if saved is None:
            axes.pop(name, None)
        else:
            axes[name] = saved


def bound_axis(name: str) -> PodMesh:
    """The pod bound to axis ``name``; ``ValueError`` when none is."""
    try:
        return _axes()[name]
    except KeyError:
        raise ValueError(
            f"unbound axis name {name!r}: a step that reduces over it "
            f"runs inside make_pod_train_step (parallel.ctx.bind_axis)"
        ) from None

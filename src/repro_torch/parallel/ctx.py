"""The mesh contexts: feature sharding (port of ``repro/parallel/ctx.py``,
the ``"feature"`` kind only) and a data-parallel pod's axis binding.

A ``FeatureMesh`` is the port's counterpart of a JAX mesh with one
``"model"`` axis (``repro/launch/mesh.make_host_mesh``): S shards of the
feature axis, each bound to a device.  It has two forms, told apart by its
``rank`` field (never by comparing devices: ranks that share a card all
name ``cuda:0``):

* **one process** (``rank`` None, ``make_feature_mesh``): every shard is
  on the input's device and the executor (``parallel/spm_shard.py``)
  keeps one slab per shard; a cross stage's hand-over is the partner's
  slab itself;
* **one shard a rank** (``launch/mesh.make_feature_rank_mesh``): shard j
  lives on rank j of the process group, which runs only its own shard's
  steps; a cross stage's hand-over is ``exchange`` (one
  ``batch_isend_irecv`` with the partner rank), the operator's output and
  grads are assembled by ``all_gather`` (the reference's ``shard_map``
  with ``ppermute`` over the ``"model"`` axis).  With gloo a CUDA slab is
  staged through the host: the rule for ranks that share a card.

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
import time
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
    lives on ``devices[j]``, and, in the rank form, on rank j of ``group``
    (None: the default group): this process is rank ``rank`` and holds
    only shard ``rank``."""

    devices: Tuple[torch.device, ...]
    rank: Optional[int] = None
    group: Any = dataclasses.field(default=None, compare=False)
    backend: Optional[str] = None
    # the rank form's transport channels (``kernels/peer.py``), by key
    channels: dict = dataclasses.field(default_factory=dict, compare=False,
                                       repr=False)
    # the rank form's collectives so far: calls, bytes sent, wall seconds
    stats: dict = dataclasses.field(
        default_factory=lambda: {"calls": 0, "bytes": 0, "seconds": 0.0},
        compare=False, repr=False)

    @property
    def ranked(self) -> bool:
        """Whether this is the rank form (one shard a rank)."""
        return self.rank is not None

    @property
    def shards(self) -> Tuple[int, ...]:
        """The shards this process runs: all of them, or its rank's."""
        return ((self.rank,) if self.ranked
                else tuple(range(len(self.devices))))

    @property
    def device(self) -> torch.device:
        """This process's device (the rank form's)."""
        return self.devices[self.rank if self.ranked else 0]

    def _host(self, t: torch.Tensor) -> torch.Tensor:
        # gloo moves host memory: a CUDA tensor is staged through it
        return t.cpu() if self.backend != "nccl" else t.contiguous()

    def exchange(self, t: torch.Tensor, k: int) -> torch.Tensor:
        """The rank form's cross-stage hand-over: send ``t`` to the partner
        rank ``rank ^ k`` and return the partner's tensor of the same shape
        (one ``batch_isend_irecv``)."""
        t0 = time.perf_counter()
        src = self._host(t)
        out = torch.empty_like(src)
        peer = self._global(self.rank ^ k)
        for w in dist.batch_isend_irecv(
                [dist.P2POp(dist.isend, src, peer, group=self.group),
                 dist.P2POp(dist.irecv, out, peer, group=self.group)]):
            w.wait()
        out = out.to(t.device)
        self._count(src, t0)
        return out

    def all_gather(self, t: torch.Tensor) -> List[torch.Tensor]:
        """Every rank's ``t`` (the same shape on each), in rank order, on
        ``t``'s device."""
        t0 = time.perf_counter()
        src = self._host(t)
        out = [torch.empty_like(src) for _ in self.devices]
        dist.all_gather(out, src, group=self.group)
        out = [o.to(t.device) for o in out]
        self._count(src, t0)
        return out

    def _count(self, sent: torch.Tensor, t0: float) -> None:
        st = self.stats
        st["calls"] += 1
        st["bytes"] += sent.numel() * sent.element_size()
        st["seconds"] += time.perf_counter() - t0

    def all_gather_object(self, obj: Any) -> List[Any]:
        """Every rank's ``obj``, in rank order."""
        out: List[Any] = [None] * len(self.devices)
        dist.all_gather_object(out, obj, group=self.group)
        return out

    def _global(self, rank: int) -> int:
        return (rank if self.group is None
                else dist.get_global_rank(self.group, rank))

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
    """A one-process mesh of ``n_shards`` shards, all on ``device``
    (``cuda`` unless the caller asks for the CPU)."""
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

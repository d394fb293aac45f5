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
to decide whether a two_level operator runs sharded.

Under a ``DeviceMesh`` (the dry-run's production mesh,
``launch/mesh.make_production_mesh``) the context also carries the
reference's placement hints: ``constrain(x, kind)`` redistributes a
``DTensor`` activation to the kind's placements (module docstring of the
reference's ``ctx.py``: ``heads``/``kv_heads`` (B, T, H, dh) heads over
``"model"`` and batch over the data axes, ``btd`` batch over the data
axes, ``batch_full`` batch over the data axes and ``"model"``,
``feature`` the last axis over ``"model"``).  With no context, under a
``FeatureMesh`` or on a plain tensor it returns ``x`` itself.

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
           "feature_mesh", "constrain", "whole_features", "whole_params",
           "reduced", "placements_of", "placed_as", "grad_placed_as",
           "current_context", "use_context", "PodMesh", "bind_axis",
           "bound_axis"]

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
    # the rank form's collectives so far: calls, bytes sent, wall seconds,
    # and the cross-stage exchanges' calls and bytes among them
    stats: dict = dataclasses.field(
        default_factory=lambda: {"calls": 0, "bytes": 0, "seconds": 0.0,
                                 "exchange_calls": 0, "exchange_bytes": 0},
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
        self.stats["exchange_calls"] += 1
        self.stats["exchange_bytes"] += src.numel() * src.element_size()
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


def _axis_names(mesh) -> Tuple[str, ...]:
    """A mesh's axis names: a ``DeviceMesh``'s ``mesh_dim_names`` or a
    ``FeatureMesh``'s/``PodMesh``'s ``axis_names``."""
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names) if names is not None else tuple(mesh.axis_names)


def activation_sharding(mesh, *, shard_heads: bool = True,
                        shard_feature: bool = False,
                        full_batch: bool = False,
                        features: Optional[FeatureMesh] = None):
    """Make ``mesh`` the active mesh within the block.  With
    ``shard_feature`` two_level SPM operators whose ``n_shards`` matches
    the feature mesh run in the sharded executor: ``mesh`` itself when it
    is a ``FeatureMesh``, else ``features`` (the rank form over a
    ``DeviceMesh``'s ``"model"`` group).  Over a ``DeviceMesh``,
    ``shard_heads`` and ``full_batch`` switch ``constrain``'s
    ``heads``/``kv_heads`` and ``batch_full`` kinds on, as in the
    reference."""
    if isinstance(mesh, FeatureMesh):
        features = mesh
    dp = tuple(a for a in ("pod", "data") if a in _axis_names(mesh))
    return use_context({"mesh": mesh, "dp": dp, "shard_heads": shard_heads,
                        "shard_feature": shard_feature,
                        "full_batch": full_batch, "features": features})


def feature_mesh(n_shards: Optional[int] = None) -> Optional[FeatureMesh]:
    """The active feature mesh when feature sharding is on and (when
    ``n_shards`` is given) its ``"model"`` axis has that size, else
    None."""
    ctx = _current()
    if ctx is None or not ctx["shard_feature"]:
        return None
    mesh = ctx.get("features")
    if mesh is None:
        return None
    if n_shards is not None and mesh.shape["model"] != n_shards:
        return None
    return mesh


def whole_features(x: torch.Tensor, *dims: int) -> torch.Tensor:
    """``x`` with axes ``dims`` (the last, the feature axis, by default)
    whole on every rank: a ``DTensor`` split there is gathered over those
    mesh dims (an SPM stage pairs lanes across the whole feature axis, and
    XLA gathers the same for the reference); anything else is returned as
    it is."""
    if placements_of(x) is None:
        return x
    from torch.distributed.tensor import Replicate
    whole = {d % x.dim() for d in (dims or (-1,))}
    # Shard and _StridedShard (a split of a merged dim) both carry ``dim``
    pl = [Replicate() if getattr(p, "dim", None) is not None
          and p.dim % x.dim() in whole else p for p in x.placements]
    if pl == list(x.placements):
        return x
    return x.redistribute(x.device_mesh, pl)


def reduced(x: torch.Tensor) -> torch.Tensor:
    """``x`` with its pending partial sums reduced: a ``DTensor`` that is
    ``Partial`` on a mesh dim (a lookup in a vocabulary split over it)
    all-reduced to ``Replicate`` there; anything else as it is."""
    if placements_of(x) is None:
        return x
    from torch.distributed.tensor import Replicate
    pl = [Replicate() if p.is_partial() else p for p in x.placements]
    if pl == list(x.placements):
        return x
    return x.redistribute(x.device_mesh, pl)


def placements_of(x: torch.Tensor):
    """A ``DTensor``'s placements, None for any other tensor."""
    if type(x) in (torch.Tensor, torch.nn.Parameter):
        return None
    return getattr(x, "placements", None)


def placed_as(x: torch.Tensor, placements) -> torch.Tensor:
    """``x`` redistributed to ``placements`` (``placements_of`` a tensor
    it matches, e.g. a forward output for its grad; where that was a
    partial sum, the grad is whole on every rank); ``x`` itself when
    ``placements`` is None or already its own."""
    if placements is None:
        return x
    from torch.distributed.tensor import Replicate
    placements = tuple(Replicate() if p.is_partial() else p
                       for p in placements)
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(x.device_mesh, placements)


class _GradPlaced(torch.autograd.Function):
    """The identity forward; the backward lays the grad out as the forward
    value was."""

    @staticmethod
    def forward(ctx, x):
        ctx.placements = tuple(x.placements)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return placed_as(g, ctx.placements)


def grad_placed_as(x: torch.Tensor) -> torch.Tensor:
    """``x``, whose grad will be laid out as ``x`` is before it flows on:
    a ``DTensor`` grad split otherwise (the sequence over a mesh axis,
    from the loss) would merge into a strided split when the grad of a
    reshape flattens it.  ``x`` itself on a plain tensor."""
    if placements_of(x) is None or not x.requires_grad:
        return x
    return _GradPlaced.apply(x)


def whole_params(params, lead: int = 0):
    """One linear's parameter leaves (a ``Params`` or a dict of tensors)
    whole on every rank but for splits of their first ``lead`` dims (an
    expert axis): a dict when a leaf is a split ``DTensor``, else
    ``params`` itself.  The kernels' plain versions read whole tables; the
    reference's executor replicates them too."""
    leaves = {k: params[k] for k in params.keys()}
    if all(type(v) in (torch.Tensor, torch.nn.Parameter)
           for v in leaves.values()):
        return params
    return {k: whole_features(v, *range(lead, v.dim())) if v.dim() > lead
            else v for k, v in leaves.items()}


def constrain(x: torch.Tensor, kind: str) -> torch.Tensor:
    """The activation placement of ``kind`` (module docstring) under the
    active ``DeviceMesh`` context: a ``DTensor`` redistributed to it.
    ``x`` itself with no context, under a ``FeatureMesh`` or when ``x`` is
    not a ``DTensor``."""
    if kind not in ("heads", "kv_heads", "btd", "batch_full", "feature"):
        raise ValueError(kind)
    ctx = _current()
    if ctx is None or isinstance(ctx["mesh"], (FeatureMesh, PodMesh)):
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    dp = ctx["dp"]
    if kind in ("heads", "kv_heads"):
        if not ctx["shard_heads"]:
            return x
        spec = (dp, None, "model", None)
    elif kind == "btd":
        spec = (dp,) + (None,) * (x.dim() - 1)
    elif kind == "batch_full":
        if not ctx["full_batch"]:
            return x
        spec = (dp + ("model",),) + (None,) * (x.dim() - 1)
    else:
        if not ctx["shard_feature"]:
            return x
        spec = (None,) * (x.dim() - 1) + ("model",)
    from repro_torch.parallel.sharding import placements
    return x.redistribute(x.device_mesh, placements(spec, x.device_mesh))


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

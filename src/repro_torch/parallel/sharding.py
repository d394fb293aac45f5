"""PartitionSpec rule table: parameters and caches, over a mesh's named
axes (port of ``repro/parallel/sharding.py``), and a pod's rows.

**Strategy** (the reference's): FSDP × TP inside a pod over mesh axes
``("data", "model")``; the optional ``"pod"`` axis is an outer pure-DP
axis (params replicated across pods, gradients all-reduced).  Rules are
written against the trailing dims of each parameter and left-padded with
``None``; the expert axis goes over ``"model"``.  ``PROFILES`` are the
reference's five: ``tp`` (the Megatron table), ``spm_dp``/``spm_dp_g``/
``spm_dp_g2`` (SPM and small params replicated, the model axis for the
vocabulary and the experts) and ``spm_feat`` (``spm_dp`` plus the SPM
tables split over ``"model"`` in the blocks the feature-sharded executor
reads).

**The torch form of a spec.**  A spec is a tuple with one entry a tensor
dim, as a ``PartitionSpec`` has: ``None``, a mesh axis name, or a tuple
of names.  ``placements(spec, mesh)`` turns it into a ``DTensor``
placement list, one entry a mesh dim: ``Shard(d)`` where the mesh dim's
axis names tensor dim d, else ``Replicate()``.  A tuple of axes on one
dim, such as ``("pod", "data")``, is ``Shard(d)`` on each of those mesh
dims; ``DTensor`` splits the dim over them in mesh-dim order, the first
the major one, which is JAX's order for a tuple written in mesh order.
A tuple out of mesh order would need another split and raises.

**The port's layout.**  Its layers are unstacked and its names dotted
(``layers.3.mixer.q.mix``); the reference stacks a scanned pattern's
layers into one array a leaf (``layers/l0/mixer/q/mix``, a leading group
axis).  ``reference_path`` maps a port leaf to the reference's path
through ``models.transformer.stack_key``, and the rules match on that
``/`` string.  A stacked leaf's spec is computed on the stacked shape;
its group axis must be ``None`` (asserted), and the port's spec is the
rest.  The expert rule's ``expert_axis = 1`` for ``layers/.../mlp/``
paths assumes that group axis: every MoE config in the registry is
stacked, so it holds.

A pod member's rows are those of ``batch_spec`` under ``P("pod")``: rank r
of n takes rows ``[r*B/n, (r+1)*B/n)`` of the global batch.  Every rank
builds the whole global batch of a step from (seed, step) and slices its
own rows (``member_rows``), so the data cursor and resume are those of one
process.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Tuple

__all__ = ["data_axes", "batch_spec", "member_rows", "tree_path_str",
           "reference_path", "PROFILES", "param_spec", "placements",
           "param_shardings", "cache_specs", "mesh_axes"]

Spec = Tuple[Any, ...]


def mesh_axes(mesh) -> Dict[str, int]:
    """Axis sizes by name, in mesh order: a ``DeviceMesh``'s
    ``mesh_dim_names`` and shape, or a ``FeatureMesh``'s or ``PodMesh``'s
    ``axis_names`` and ``shape``."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    return {a: mesh.shape[a] for a in mesh.axis_names}


def data_axes(mesh) -> Tuple[str, ...]:
    """The pure data-parallel axes of ``mesh`` (``"pod"``, ``"data"``).  A
    ``FeatureMesh`` has none: rows are not sharded."""
    axes = mesh_axes(mesh)
    return tuple(a for a in ("pod", "data") if a in axes)


def batch_spec(mesh, *, seq_sharded: bool = False) -> Spec:
    """The spec of (B, T, ...) batch arrays: the batch axis over all the
    data-parallel axes; with ``seq_sharded`` (the 500k decode cells, B ==
    1) the sequence axis over ``"data"`` instead."""
    dp = data_axes(mesh)
    if seq_sharded:
        rest = tuple(a for a in dp if a != "data")
        return (rest if rest else None, "data")
    return (dp,)
def member_rows(batch: Any, mesh) -> Any:
    """This member's rows of a global batch (a dict, possibly nested, of
    tensors with rows first; M-RoPE ``positions`` (3, B, T) has them
    second).  A mesh without a data axis takes every row."""
    axes = data_axes(mesh)
    n = 1
    for a in axes:
        n *= mesh.shape[a]
    if n == 1:
        return batch
    rank = mesh.rank

    def cut(x, key=None):
        if isinstance(x, dict):
            return {k: cut(v, k) for k, v in x.items()}
        axis = 1 if key == "positions" and x.dim() == 3 else 0
        b = x.shape[axis]
        if b % n:
            raise ValueError(f"batch {b} does not split over a pod of {n}")
        per = b // n
        return x.narrow(axis, rank * per, per)

    return cut(batch)


def tree_path_str(name: str) -> str:
    """A port leaf's dotted name (``layers.3.ffn.w``) as the reference's
    ``/`` path string (``layers/3/ffn/w``)."""
    return name.replace(".", "/")


def reference_path(name: str, cfg=None) -> Tuple[str, int]:
    """``(path, groups)``: the reference's path string of the array that
    the port's parameter ``name`` is part of, and the length of its
    leading group axis (0: not stacked).  Without ``cfg`` the name maps
    as it is."""
    if cfg is None:
        return tree_path_str(name), 0
    from repro_torch.models.transformer import stack_groups, stack_key
    key = stack_key(cfg)(name)
    if key == name:
        return tree_path_str(name), 0
    return tree_path_str(key), cfg.n_layers // stack_groups(cfg)


# SPM parameters: pair / feature axes split over "model" in the same
# contiguous blocks the feature-sharded executor (parallel/spm_shard.py)
# reads: stage coeffs by the trailing pair axis, diagonals and bias by the
# feature axis.  Shared by the "tp" rule table and the "spm_feat" profile.
_SPM_PARAM_RULES = (
    (lambda p: p.endswith("/mix"), (None, "model", None)),
    (lambda p: p.endswith("/theta"), (None, "model")),
    (lambda p: any(p.endswith(s) for s in
                   ("/d_in", "/d_out", "/bias", "/res_scale")),
     ("model",)),
)

# (predicate on the path, trailing spec); the first match wins
_RULES = (
    # embeddings: (vocab, d), vocab-parallel TP, FSDP over d
    (lambda p: p.endswith("embed/table") or p.endswith("embed/out"),
     ("model", "data")),
    # routers are small classifiers: replicated
    (lambda p: p.endswith("router"), (None, None)),
    # output-expanding dense mats: column-parallel, FSDP rows
    (lambda p: any(p.endswith(s) for s in
                   ("/q/w", "/k/w", "/v/w", "/up/w", "/gate/w", "/wz/w",
                    "/wr/w", "/wh/w", "/uz/w", "/ur/w", "/uh/w", "/mix/w",
                    "in_proj/w")),
     ("data", "model")),
    # input-contracting dense mats: row-parallel, FSDP columns
    (lambda p: any(p.endswith(s) for s in
                   ("/o/w", "/down/w", "out_proj/w", "/head/w")),
     ("model", "data")),
    *_SPM_PARAM_RULES,
    # mamba conv: (K, conv_dim), conv_dim over model
    (lambda p: p.endswith("conv_w"), (None, "model")),
)

PROFILES = ("tp", "spm_dp", "spm_dp_g", "spm_dp_g2", "spm_feat")


def _replicated(ndim: int) -> Spec:
    return (None,) * ndim


def _padded(ndim: int, trailing: Spec) -> Spec:
    k = len(trailing)
    return _replicated(ndim) if ndim < k else \
        (None,) * (ndim - k) + tuple(trailing)


def param_spec(path_str: str, ndim: int, mesh, profile: str = "tp") -> Spec:
    """The spec of one parameter by its reference path string (the
    reference's ``param_spec``, rule for rule).

    ``tp``: the Megatron-style table.  ``spm_dp*``: SPM, norm and small
    params replicated; the model axis for vocab-parallel embeddings and
    expert parallelism.  ``spm_feat``: ``spm_dp`` plus the SPM stage
    coefficients and vectors split over ``"model"``."""
    axes = mesh_axes(mesh)
    have_model, have_data = "model" in axes, "data" in axes

    def expert_axis_spec() -> Spec:
        # the expert axis sits after a stacked group axis in
        # "layers/<g>/mlp/experts/..." paths
        axis = 1 if path_str.startswith("layers/") and "/mlp/" in path_str \
            else 0
        spec = [None] * ndim
        if axis < ndim:
            spec[axis] = "model"
        return tuple(spec)

    if profile.startswith("spm_dp") or profile == "spm_feat":
        if path_str.endswith("embed/table") or path_str.endswith("embed/out"):
            return (None,) * (ndim - 2) + ("model", None)
        if "/experts/" in path_str and ndim >= 2 and have_model:
            return expert_axis_spec()
        if profile == "spm_feat" and have_model:
            for pred, trailing in _SPM_PARAM_RULES:
                if pred(path_str):
                    return _padded(ndim, trailing)
        return _replicated(ndim)
    if profile != "tp":
        raise ValueError(f"unknown profile {profile!r}; known: {PROFILES}")

    def mesh_ok(ax) -> bool:
        return (ax is None or (ax == "model" and have_model)
                or (ax == "data" and have_data))

    is_expert = "/experts/" in path_str or path_str.endswith("/experts")
    for pred, trailing in _RULES:
        if not pred(path_str):
            continue
        if is_expert:
            # the expert axis takes "model"; the rule's inner dims give it
            # up so no axis is used twice
            trailing = tuple("data" if ax == "data" else None
                             for ax in trailing)
            k = len(trailing)
            if ndim < k + 1:
                return _replicated(ndim)
            return (None,) * (ndim - k - 1) + ("model",) + trailing
        trailing = tuple(ax if mesh_ok(ax) else None for ax in trailing)
        return _padded(ndim, trailing)
    if is_expert and ndim >= 2 and have_model:
        return expert_axis_spec()
    return _replicated(ndim)


def _names(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def _drop_indivisible(spec: Spec, shape, mesh) -> Spec:
    """Drop every axis assignment that its dim cannot divide evenly (the
    reference's rule for ``jit`` in_shardings; e.g. vocab 50280 over a
    16-way model axis)."""
    if shape is None:
        return spec
    axes = mesh_axes(mesh)
    out = []
    for i, ax in enumerate(spec):
        if i >= len(shape):
            out.append(None)
            continue
        if ax is None:
            out.append(None)
            continue
        size = math.prod(axes[a] for a in _names(ax))
        out.append(ax if shape[i] % size == 0 else None)
    return tuple(out)


def placements(spec: Spec, mesh) -> tuple:
    """``spec``'s ``DTensor`` placements over ``mesh``, one a mesh dim
    (module docstring: a tuple of axes on one dim shards it over them in
    mesh order)."""
    from torch.distributed.tensor import Replicate, Shard
    order = list(mesh_axes(mesh))
    dim_of: Dict[str, int] = {}
    for d, entry in enumerate(spec):
        names = _names(entry)
        pos = [order.index(a) for a in names]
        if pos != sorted(pos):
            raise ValueError(f"axes {names} on dim {d} are not in mesh "
                             f"order {tuple(order)}")
        for a in names:
            if a in dim_of:
                raise ValueError(f"axis {a!r} named on dims {dim_of[a]} "
                                 f"and {d}")
            dim_of[a] = d
    return tuple(Shard(dim_of[a]) if a in dim_of else Replicate()
                 for a in order)


def _leaf_placements(name: str, shape, mesh, profile: str, cfg) -> tuple:
    path, groups = reference_path(name, cfg)
    full = ((groups,) if groups else ()) + tuple(shape)
    spec = _drop_indivisible(param_spec(path, len(full), mesh, profile),
                             full, mesh)
    if groups:
        assert spec[0] is None, (
            f"{path}: the stacked group axis is placed {spec[0]!r}")
        spec = spec[1:]
    return placements(spec, mesh)


def param_shardings(mesh, params, profile: str = "tp", *,
                    cfg=None) -> Dict[str, tuple]:
    """``{name: placements}`` for every parameter of ``params`` (a
    ``Params`` tree or a dict of tensors by dotted name).  With the model
    config ``cfg`` the rules see the reference's stacked paths and shapes
    (``reference_path``)."""
    named = (dict(params.named_parameters())
             if hasattr(params, "named_parameters") else dict(params))
    return {k: _leaf_placements(k, tuple(v.shape), mesh, profile, cfg)
            for k, v in named.items()}


def cache_specs(mesh, cache, *, seq_sharded: bool = False):
    """The placements of a decode cache (``models.transformer.
    init_cache``'s list of per-layer dicts), in the same structure.

    Default: batch over the data axes, KV heads over ``"model"``; with
    ``seq_sharded`` (long context, B = 1) the KV sequence over ``"data"``.
    KV caches are (B, S, Hkv, dh), SSM states (B, H, P, N), conv states
    (B, K, C).  A KV head count that ``"model"`` does not divide falls back
    to head_dim, as in the reference."""
    axes = mesh_axes(mesh)
    dp = data_axes(mesh)
    n_model = axes.get("model", 1)
    n_dp = math.prod(axes[a] for a in dp) if dp else 1

    def fit(shape, trailing) -> Spec:
        spec = list(trailing)
        off = len(shape) - len(spec)
        for i, ax in enumerate(spec):
            if ax is None:
                continue
            if ax == "model":
                if shape[off + i] % n_model:
                    # try the next dim to the right (Hkv -> head_dim)
                    spec[i] = None
                    if (i + 1 < len(spec) and spec[i + 1] is None
                            and shape[off + i + 1] % n_model == 0):
                        spec[i + 1] = "model"
            elif shape[off + i] % math.prod(axes[a] for a in _names(ax)):
                spec[i] = None
        return tuple(spec)

    def one(path: str, x) -> tuple:
        nd = x.dim()
        if path.endswith("/k") or path.endswith("/v"):     # (B, S, Hkv, dh)
            tr = ((None, "data", "model", None) if seq_sharded
                  else (dp, None, "model", None))
        elif path.endswith("/ssm"):                        # (B, H, P, N)
            tr = ((None, "model", None, None) if seq_sharded
                  else (dp, "model", None, None))
        elif path.endswith("/conv"):                       # (B, K, C)
            tr = ((None, None, "model") if seq_sharded
                  else (dp, None, "model"))
        else:
            return placements(_replicated(nd), mesh)
        k = len(tr)
        trail = tuple(x.shape[-k:]) if nd >= k else tuple(x.shape)
        return placements(_padded(nd, fit(trail, tr)), mesh)

    def walk(t, path):
        if isinstance(t, dict):
            return {k: walk(v, f"{path}/{k}") for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return [walk(v, f"{path}/{i}") for i, v in enumerate(t)]
        return one(path, t)

    return [walk(layer, str(i)) for i, layer in enumerate(cache)]

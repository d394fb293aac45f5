"""Int8 error-feedback gradient compression for the pod all-reduce (port of
``repro/optim/compression.py``).

A pod member quantizes its gradient to int8 against one per-tensor scale
(absmax / 127), the members sum the int8 payloads in int32 and rescale,
and error feedback keeps each member's quantization error as a residual
that joins its next gradient (EF-SGD).

Trees are the port's: dicts of name -> tensor, nested dicts, tuples and
lists.  ``compress``, ``decompress``, ``compress_tree``,
``decompress_tree``, ``ef_step`` and ``init_residual`` are plain functions
of one process.  ``psum_compressed`` and ``psum_compressed_ef`` are
collectives over the pod bound to ``axis_name`` (``parallel.ctx``): the
reference's ``pmax`` is ``all_reduce(MAX)`` and its int32 ``psum`` is
``all_reduce(SUM)``.  Each is batched: the per-leaf scales go in one f32
vector (one ``MAX``), every int8 payload, widened to int32, in one flat
buffer (one ``SUM``), so a step makes two collectives whatever the number
of leaves; the reduction is elementwise, so the bits are those of one
collective a leaf.  ``pmean`` gives the uncompressed mean one flat f32
buffer.

The arithmetic keeps the reference's bits:

* divisions are by tensors (``absmax / 127``, ``g / s``, ``1 / n``): on
  the card a division by a host scalar is a multiply by its reciprocal;
* ``torch.round`` is half to even, as ``jnp.round``;
* the residual ``g' - q * s`` is rounded once, as the reference's compiled
  step computes it (XLA contracts it into a fused multiply-add): the
  difference is exact in f64 (q has 8 bits, s 24, and q != 0 only where
  |g'| is within a factor 2 of s or above) and is then rounded to f32;
* the residual stays in sum space and is always f32.

A per-tensor scale is per array of the reference.  The reference stacks a
model's layers into one array a parameter kind, the port keeps one tensor
a layer: ``groups`` (one key a leaf, in flatten order;
``models.transformer.stack_key`` gives a model's) makes the leaves of one
reference array share one scale, the max of theirs (rounding is monotone,
so it equals the scale of their concatenation).
"""

from __future__ import annotations

from typing import (Any, Callable, Hashable, List, Optional, Sequence,
                    Tuple)

import torch
import torch.distributed as dist

from repro_torch.parallel.ctx import bound_axis

__all__ = ["compress", "decompress", "compress_tree", "decompress_tree",
           "ef_step", "psum_compressed", "psum_compressed_ef", "pmean",
           "init_residual", "member_sum_compressed_ef"]

_CHUNK = 1 << 24          # f64 elements a residual chunk (128 MiB)
_LEAF = object()


def _f32(v: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=like.device)


def _amax_scale(x: torch.Tensor) -> torch.Tensor:
    """Per-tensor int8 scale: absmax / 127 (+1e-12), a 0-dim f32 tensor."""
    xf = x.float()
    return torch.max(torch.abs(xf)) / _f32(127.0, xf) + _f32(1e-12, xf)


def _is_compressed_leaf(x: Any) -> bool:
    """Whether ``x`` is a ``compress`` result: an int8 tensor and a 0-dim
    scale.  Keyed on the content, so that a ``(mu, nu)`` pair of trees is
    still traversed."""
    if not (isinstance(x, tuple) and len(x) == 2):
        return False
    q, s = x
    return (isinstance(q, torch.Tensor) and q.dtype == torch.int8
            and isinstance(s, torch.Tensor) and s.dim() == 0)


def _flatten(tree: Any, is_leaf: Optional[Callable] = None
             ) -> Tuple[List[Any], Any]:
    """The leaves of ``tree`` (tensors, or what ``is_leaf`` accepts) in
    walk order, and its structure for ``_unflatten``."""
    leaves: List[Any] = []

    def walk(node):
        if (is_leaf is not None and is_leaf(node)) or isinstance(
                node, torch.Tensor):
            leaves.append(node)
            return _LEAF
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        raise TypeError(f"not a tree of tensors: {type(node).__name__}")

    return leaves, walk(tree)


def _unflatten(spec: Any, leaves: List[Any]) -> Any:
    it = iter(leaves)

    def build(node):
        if node is _LEAF:
            return next(it)
        if isinstance(node, dict):
            return {k: build(v) for k, v in node.items()}
        return type(node)(build(v) for v in node)

    return build(spec)


def _map(fn: Callable, tree: Any) -> Any:
    leaves, spec = _flatten(tree)
    return _unflatten(spec, [fn(x) for x in leaves])


def _quantize(xf: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """clip(round(x / scale), -127, 127), in f32."""
    return torch.clamp(torch.round(xf / scale), -127.0, 127.0)


def _residual(gf: torch.Tensor, q: torch.Tensor,
              scale: torch.Tensor) -> torch.Tensor:
    """``gf - q * scale`` rounded once to f32 (module docstring), in
    chunks so that the f64 temporaries stay small."""
    out = torch.empty_like(gf, dtype=torch.float32)
    g, qq, o = gf.reshape(-1), q.reshape(-1), out.view(-1)
    s = scale.double()
    for lo in range(0, g.numel(), _CHUNK):
        hi = lo + _CHUNK
        o[lo:hi] = g[lo:hi].double() - qq[lo:hi].double() * s
    return out


def compress(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """f32 -> (int8 values, f32 scale)."""
    xf = x.float()
    scale = _amax_scale(xf)
    return _quantize(xf, scale).to(torch.int8), scale


def decompress(q: torch.Tensor, scale: torch.Tensor,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(int8 values, f32 scale) -> ``dtype`` (default f32)."""
    return (q.float() * scale).to(dtype)


def compress_tree(tree: Any) -> Any:
    """``compress`` every tensor leaf: a tree of (int8 values, scale)."""
    return _map(compress, tree)


def decompress_tree(ctree: Any, like: Any) -> Any:
    """Inverse of ``compress_tree``: every compressed leaf back to the
    dtype of the matching leaf of ``like``."""
    leaves, spec = _flatten(ctree, is_leaf=_is_compressed_leaf)
    dtypes = [x.dtype for x in _flatten(like)[0]]
    return _unflatten(spec, [decompress(c[0], c[1], d)
                             for c, d in zip(leaves, dtypes)])


def ef_step(grads: Any, residual: Any) -> Tuple[Any, Any]:
    """Error feedback in one process: g' = g + r; returns (dequant(quant(
    g')) in the grads' dtypes, the new residual g' - dequant(quant(g')))."""
    outs, news = [], []
    g_leaves, spec = _flatten(grads)
    for g, r in zip(g_leaves, _flatten(residual)[0]):
        gf = g.float() + r
        scale = _amax_scale(gf)
        q = _quantize(gf, scale)
        outs.append(decompress(q.to(torch.int8), scale, g.dtype))
        news.append(_residual(gf, q, scale))
    return _unflatten(spec, outs), _unflatten(spec, news)


def init_residual(params: Any) -> Any:
    """Zero error-feedback residual shaped like ``params``, always f32."""
    return _map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)


def _group_scales(scales: torch.Tensor, groups: Optional[Sequence[Hashable]],
                  mesh=None) -> torch.Tensor:
    """Each leaf's scale: the max over its group's (and with ``mesh`` over
    the pod's members, one ``MAX`` for all groups)."""
    if groups is None:
        if mesh is not None:
            mesh.all_reduce(scales, dist.ReduceOp.MAX)
        return scales
    ids = {g: i for i, g in enumerate(dict.fromkeys(groups))}
    index = torch.tensor([ids[g] for g in groups], device=scales.device)
    per = torch.full((len(ids),), float("-inf"), dtype=scales.dtype,
                     device=scales.device)
    per = per.scatter_reduce(0, index, scales, "amax")
    if mesh is not None:
        mesh.all_reduce(per, dist.ReduceOp.MAX)
    return per[index]


def _codes(leaves: List[torch.Tensor], scales: torch.Tensor,
           residual: Optional[List[torch.Tensor]] = None
           ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """Every leaf's codes against its scale (of g + r when ``residual`` is
    given) in one flat int32 buffer, and the new residuals.  g + r is
    formed again here, not kept from the scales' pass: one f32 copy of
    the grads fewer."""
    flat = torch.empty(sum(g.numel() for g in leaves), dtype=torch.int32,
                       device=leaves[0].device)
    news, lo = [], 0
    for i, g in enumerate(leaves):
        gf = g.float() if residual is None else g.float() + residual[i]
        q = _quantize(gf, scales[i])
        if residual is not None:
            news.append(_residual(gf, q, scales[i]))
        flat[lo: lo + g.numel()] = q.reshape(-1)
        lo += g.numel()
    return flat, news


def _rescale(total: torch.Tensor, leaves: List[torch.Tensor],
             scales: torch.Tensor, inv: Optional[torch.Tensor]
             ) -> List[torch.Tensor]:
    """Each leaf's slice of the summed int32 codes times its scale (times
    ``inv`` when given), in the leaf's dtype."""
    out, lo = [], 0
    for i, g in enumerate(leaves):
        t = total[lo: lo + g.numel()].view(g.shape).float() * scales[i]
        if inv is not None:
            t = t * inv
        out.append(t.to(g.dtype))
        lo += g.numel()
    return out


def psum_compressed(grads: Any, axis_name: str) -> Any:
    """All-reduce int8-compressed gradients over the pod bound to
    ``axis_name``: each leaf quantized against the pod-max scale, the
    codes summed in int32, then rescaled (a sum, not a mean)."""
    mesh = bound_axis(axis_name)
    leaves, spec = _flatten(grads)
    scales = _group_scales(torch.stack([_amax_scale(g) for g in leaves]),
                           None, mesh)
    total, _ = _codes(leaves, scales)
    mesh.all_reduce(total, dist.ReduceOp.SUM)
    return _unflatten(spec, _rescale(total, leaves, scales, None))


def psum_compressed_ef(grads: Any, residual: Any, axis_name: str, *,
                       mean: bool = True,
                       groups: Optional[Sequence[Hashable]] = None
                       ) -> Tuple[Any, Any]:
    """Error-feedback int8 all-reduce over the pod bound to ``axis_name``.

    Each member folds its residual into its gradient (g' = g + r),
    quantizes g' against the pod-max scale, the int32 sum of the codes is
    rescaled (and with ``mean`` multiplied by 1/n), and the member keeps
    r' = g' - q * s.  Returns ``(reduced grads, new residual)``."""
    mesh = bound_axis(axis_name)
    leaves, spec = _flatten(grads)
    res = _flatten(residual)[0]
    scales = _group_scales(torch.stack([_amax_scale(g.float() + r)
                                        for g, r in zip(leaves, res)]),
                           groups, mesh)
    total, news = _codes(leaves, scales, res)
    mesh.all_reduce(total, dist.ReduceOp.SUM)
    inv = None
    if mean:
        one = _f32(1.0, total)
        inv = one / _f32(float(mesh.size), total)
    return (_unflatten(spec, _rescale(total, leaves, scales, inv)),
            _unflatten(spec, news))


def pmean(tree: Any, axis_name: str) -> Any:
    """The mean over the pod bound to ``axis_name``: every leaf in one flat
    f32 buffer, summed, divided by n (then back to each leaf's dtype)."""
    mesh = bound_axis(axis_name)
    leaves, spec = _flatten(tree)
    flat = torch.cat([t.float().reshape(-1) for t in leaves])
    mesh.all_reduce(flat, dist.ReduceOp.SUM)
    flat = flat / _f32(float(mesh.size), flat)
    out, lo = [], 0
    for t in leaves:
        out.append(flat[lo: lo + t.numel()].view(t.shape).to(t.dtype))
        lo += t.numel()
    return _unflatten(spec, out)


def member_sum_compressed_ef(grads: Any, residual: Any, *,
                             mean: bool = True,
                             groups: Optional[Sequence[Hashable]] = None
                             ) -> Tuple[Any, Any]:
    """``psum_compressed_ef`` in one process, over a leading member axis of
    every leaf (the plain version that a pod's reduction is held to):
    returns the reduced grads (no member axis) and the new residual (with
    it)."""
    leaves, spec = _flatten(grads)
    gfs = [g.float() + r for g, r in zip(leaves, _flatten(residual)[0])]
    n = gfs[0].shape[0]
    scales = _group_scales(torch.stack([torch.max(torch.stack(
        [_amax_scale(m) for m in gf])) for gf in gfs]), groups)
    outs, news = [], []
    for i, (g, gf) in enumerate(zip(leaves, gfs)):
        q = _quantize(gf, scales[i])
        total = q.to(torch.int32).sum(0, dtype=torch.int32).float() \
            * scales[i]
        if mean:
            total = total * (_f32(1.0, gf) / _f32(float(n), gf))
        outs.append(total.to(g.dtype))
        news.append(_residual(gf, q, scales[i]))
    return _unflatten(spec, outs), _unflatten(spec, news)

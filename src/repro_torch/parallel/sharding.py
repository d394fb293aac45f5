"""Mesh-axis helpers (port of ``data_axes`` and ``batch_spec`` from
``repro/parallel/sharding.py``; the parameter and cache rule tables place
arrays for XLA and wait for tensor and expert parallelism across cards).

A pod member's rows are those of ``batch_spec`` under ``P("pod")``: rank r
of n takes rows ``[r*B/n, (r+1)*B/n)`` of the global batch.  Every rank
builds the whole global batch of a step from (seed, step) and slices its
own rows (``member_rows``), so the data cursor and resume are those of one
process.
"""

from __future__ import annotations

from typing import Any, Tuple

__all__ = ["data_axes", "batch_spec", "member_rows"]


def data_axes(mesh) -> Tuple[str, ...]:
    """The pure data-parallel axes of ``mesh`` (``"pod"``, ``"data"``).  A
    ``FeatureMesh`` has none: rows are not sharded."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def batch_spec(mesh) -> Tuple[Tuple[str, ...], ...]:
    """The placement of (B, T, ...) batch arrays: the batch axis over all
    the data-parallel axes (``P(data_axes(mesh))``), one entry a leading
    dim."""
    return (data_axes(mesh),)


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

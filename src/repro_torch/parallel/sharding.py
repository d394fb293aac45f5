"""Mesh-axis helpers (port of ``data_axes`` from
``repro/parallel/sharding.py``; the parameter and batch rule tables place
arrays for XLA and have no counterpart here)."""

from __future__ import annotations

from typing import Tuple

__all__ = ["data_axes"]


def data_axes(mesh) -> Tuple[str, ...]:
    """The pure data-parallel axes of ``mesh`` (``"pod"``, ``"data"``).  A
    ``FeatureMesh`` has none: rows are not sharded."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)

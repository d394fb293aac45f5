"""Carry the reference's parameters into the port.

``params_from_jax`` takes ``repro``'s parameter pytree, already brought to
numpy by the caller (e.g. ``jax.tree.map(np.asarray, params)``), and returns
the port's ``Params`` tree.  Scanned configs store their layers stacked,
``{"l0": leaf (n_groups, ...), ...}`` (``transformer.py:276-279`` of the
reference); those are unstacked into one tree per layer.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.params import Params

__all__ = ["params_from_jax"]


def _tensor(a: Any, device: torch.device) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":     # ml_dtypes: no torch.from_numpy
        arr = arr.astype(np.float32)
    return torch.from_numpy(np.array(arr)).to(device)   # a writable copy


def _tree(t: Any, device: torch.device, index=None) -> Any:
    if isinstance(t, dict):
        return {k: _tree(v, device, index) for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        return [_tree(v, device, index) for v in t]
    return _tensor(t if index is None else np.asarray(t)[index], device)


def params_from_jax(tree: dict, cfg, device=None) -> Params:
    """The port's parameters from the reference's numpy pytree for the
    model config ``cfg`` (``repro_torch.models.transformer.ModelConfig``),
    on ``device`` (``cuda`` unless the caller asks for the CPU)."""
    dev = resolve_device(device)
    layers = tree["layers"]
    if isinstance(layers, dict):          # stacked: (n_groups, ...) leaves
        g = len(layers)
        per_layer = [_tree(layers[f"l{i % g}"], dev, i // g)
                     for i in range(cfg.n_layers)]
    else:
        per_layer = [_tree(lp, dev) for lp in layers]
    out = {k: _tree(v, dev) for k, v in tree.items() if k != "layers"}
    out["layers"] = per_layer
    return Params(out)

"""Carry the reference's parameters into the port.

``tree_from_jax`` takes any of ``repro``'s parameter pytrees, already
brought to numpy by the caller (e.g. ``jax.tree.map(np.asarray, params)``),
and returns the port's ``Params`` tree with the same keys.
``params_from_jax`` does so for a transformer: scanned configs store their
layers stacked, ``{"l0": leaf (n_groups, ...), ...}``
(``transformer.py:276-279`` of the reference); those are unstacked into one
tree per layer.  ``state_from_jax`` carries a whole train state, as a
checkpoint holds it: the params, the AdamW moments (unstacked the same
way), the count and the step.

A feature-sharded config (``configs.with_feature_sharding``) needs no leaf
of its own: the sharded executor reads the same (L, n/2, 4) coefficient
tables and (n,) vectors, and the same converted params give the same
output with the feature mesh on and off (``tests/test_torch_shard.py``).
Neither does the overlap schedule (``configs.with_overlap_executor``) nor
int8 tables on the sharded path (``with_quantized_io``): both read those
same tables and quantize each shard's own at run time
(``tests/test_torch_overlap.py``).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.params import Params

__all__ = ["tree_from_jax", "params_from_jax", "state_from_jax",
           "unstack_layers"]


def _tensor(a: Any, device: torch.device) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":     # ml_dtypes: no torch.from_numpy
        arr = arr.astype(np.float32)
    return torch.from_numpy(np.array(arr)).to(device)   # a writable copy


def _tree(t: Any, device: torch.device) -> Any:
    if isinstance(t, dict):
        return {k: _tree(v, device) for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        return [_tree(v, device) for v in t]
    return _tensor(t, device)


def _index(t: Any, index: int) -> Any:
    """Row ``index`` of every numpy leaf of a stacked tree."""
    if isinstance(t, dict):
        return {k: _index(v, index) for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        return [_index(v, index) for v in t]
    return np.asarray(t)[index]


def tree_from_jax(tree: Any, device=None) -> Params:
    """The port's ``Params`` from any nested dict (and lists) of numpy
    leaves, keys kept: the MLP's ``{"mix", "head"}``, the char-LM's bare
    ``embed`` table beside its ``proj``, the GRU-LM's list of ``grus``; on
    ``device`` (``cuda`` unless the caller asks for the CPU)."""
    return Params(_tree(tree, resolve_device(device)))


def unstack_layers(layers: Any, n_layers: int, take=_index) -> list:
    """One tree a layer from the reference's ``layers`` (or a stacked
    cache): a stacked ``{"l0": leaf (n_groups, ...), ...}`` gives layer i
    as ``take(layers[f"l{i % g}"], i // g)``; a list is returned as it
    is."""
    if isinstance(layers, dict):          # stacked: (n_groups, ...) leaves
        g = len(layers)
        return [take(layers[f"l{i % g}"], i // g) for i in range(n_layers)]
    return list(layers)


def params_from_jax(tree: dict, cfg, device=None) -> Params:
    """The port's parameters from the reference's numpy pytree for the
    model config ``cfg`` (``repro_torch.models.transformer.ModelConfig``),
    on ``device`` (``cuda`` unless the caller asks for the CPU)."""
    out = {k: v for k, v in tree.items() if k != "layers"}
    out["layers"] = unstack_layers(tree["layers"], cfg.n_layers)
    return tree_from_jax(out, device)


def state_from_jax(state: dict, cfg=None, device=None) -> dict:
    """The port's train state (``train.state.make_train_state``'s layout)
    from the reference's, with numpy leaves: ``{"params", "opt": {"mu",
    "nu", "count"}, "step"}``.  With a transformer ``cfg`` the params and
    moments go through ``params_from_jax`` (unstacked when stacked), else
    through ``tree_from_jax``; on ``device`` (``cuda`` unless the caller
    asks for the CPU)."""
    from repro_torch.train.state import make_train_state
    dev = resolve_device(device)

    def tree(t):
        return (tree_from_jax(t, dev) if cfg is None
                else params_from_jax(t, cfg, dev))

    out = make_train_state(tree(state["params"]))
    opt = state["opt"]
    for name in ("mu", "nu"):
        moments = dict(tree(opt[name]).named_parameters())
        if moments.keys() != out["opt"][name].keys():
            raise ValueError(f"opt[{name!r}] does not match the params' "
                             f"tree")
        out["opt"][name] = {k: v.detach() for k, v in moments.items()}
    out["opt"]["count"] = torch.as_tensor(np.array(opt["count"]),
                                          dtype=torch.int32, device=dev)
    out["step"] = torch.as_tensor(np.array(state["step"]),
                                  dtype=torch.int32, device=dev)
    return out

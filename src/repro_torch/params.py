"""Parameter trees as ``nn.Module``s, addressed like the reference's pytrees.

``Params`` holds tensors as ``nn.Parameter``s and sub-trees as sub-modules,
so ``state_dict`` keys follow the JAX pytree keys (``layers.0.mixer.q.mix``,
``layers.0.norm1.scale``, ``embed.table``) and the port's functional layers
read ``params["mix"]`` exactly as ``repro``'s do.  Parameters are created
with ``requires_grad=False``, so serving builds no autograd graph;
``trainable()`` (called by ``train.state.make_train_state``) turns on
``requires_grad`` for every parameter of the tree.
"""

from __future__ import annotations

from typing import Any, Iterator

import torch
from torch import nn

__all__ = ["Params"]


class Params(nn.Module):
    """A tree of parameters: tensors, nested dicts, and lists of trees."""

    def __init__(self, tree: Any = None):
        super().__init__()
        for key, value in (tree or {}).items():
            self[key] = value

    def __setitem__(self, key: str, value: Any) -> None:
        if isinstance(value, nn.Module):
            self.add_module(key, value)
        elif isinstance(value, torch.Tensor):
            self.register_parameter(
                key, nn.Parameter(value, requires_grad=False))
        elif isinstance(value, dict):
            self.add_module(key, Params(value))
        elif isinstance(value, (list, tuple)):
            self.add_module(key, nn.ModuleList(
                v if isinstance(v, nn.Module) else Params(v) for v in value))
        else:
            raise TypeError(f"{key}: cannot hold {type(value).__name__}")

    def __getitem__(self, key: str) -> Any:
        if key in self._parameters:
            return self._parameters[key]
        if key in self._modules:
            return self._modules[key]
        raise KeyError(key)

    def __contains__(self, key: str) -> bool:
        return key in self._parameters or key in self._modules

    def get(self, key: str, default: Any = None) -> Any:
        """``self[key]`` when present, else ``default`` (dict idiom)."""
        return self[key] if key in self else default

    def trainable(self) -> "Params":
        """Turn on ``requires_grad`` for every parameter of the tree;
        returns self."""
        for p in self.parameters():
            p.requires_grad_(True)
        return self

    def keys(self) -> Iterator[str]:
        """Top-level keys: parameters first, then sub-trees."""
        yield from self._parameters
        yield from self._modules

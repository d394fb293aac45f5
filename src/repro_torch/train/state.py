"""The training state (port of ``repro/train/state.py``): the parameter
tree, the AdamW state and the step counter, as a plain dict.

``tree_leaves_with_path`` fixes the order in which a checkpoint stores the
state's tensors, and ``tree_signature`` is the structural fingerprint that
a checkpoint records and a restore checks (``train/checkpoint.py``).  The
order is the reference's: ``jax.tree_util`` flattens dict keys sorted at
every level and list items by index.  The port's state is another tree:

* ``Params`` modules, whose ``ModuleList`` children are keyed ``"0"``,
  ``"1"``, ...;
* ``opt["mu"]`` and ``opt["nu"]`` (and a compressed pod's ``opt["ef"]``),
  flat dicts keyed by dotted names (``layers.10.mixer.q.mix``);
* ``opt["decay"]``, a dict of Python bools.

So each leaf's path is split at the dots, a part made of digits is a list
index and compares as an int (``layers.2`` before ``layers.10``), and the
leaves are sorted by path.  Only tensors are leaves: ``opt["decay"]`` is
derived from the params, is not stored, and comes from the tree a
checkpoint is restored into.  An unstacked reference tree (the paper's
MLP and char-LM) then flattens to the port's tensors in the same order,
under the same treedef string; a scanned transformer's stacked tree does
not.  An empty dict or list holds no leaf and leaves no trace in the
treedef.
"""

from __future__ import annotations

from typing import Any, List, Optional, Tuple

import hashlib

import torch
from torch import nn

from repro_torch.optim.adamw import init_opt_state
from repro_torch.params import Params

__all__ = ["make_train_state", "param_count", "tree_leaves_with_path",
           "tree_signature", "numpy_dtype_name", "state_digest"]

Path = Tuple[Any, ...]

_NUMPY_NAMES = {torch.float64: "float64", torch.float32: "float32",
                torch.float16: "float16", torch.int64: "int64",
                torch.int32: "int32", torch.int16: "int16",
                torch.int8: "int8", torch.uint8: "uint8",
                torch.bool: "bool"}


def make_train_state(params: Params, ef_pod: int = 0) -> dict:
    """A fresh state for ``params``, which become trainable: zero moments,
    count 0, step 0, and the weight-decay mask of the reference's layout
    (``optim/adamw.decay_mask``).  ``ef_pod > 1`` adds the compressed
    pod's error-feedback residual ``opt["ef"]`` with a leading member axis
    of that size (``train/step.pod_residual``), checkpointed, restored and
    rolled back with the rest of the optimizer state."""
    params.trainable()
    named = dict(params.named_parameters())
    dev = next(iter(named.values())).device
    opt = init_opt_state(named)
    if ef_pod > 1:
        from repro_torch.train.step import pod_residual
        opt["ef"] = pod_residual(named, ef_pod)
    return {"params": params,
            "opt": opt,
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def param_count(state: dict) -> int:
    """Learnable scalars in ``state["params"]``."""
    return sum(p.numel() for p in state["params"].parameters())


def numpy_dtype_name(dtype: torch.dtype) -> Optional[str]:
    """numpy's name for a torch dtype (``"float32"``), or None when numpy
    has no such dtype (``torch.bfloat16``)."""
    return _NUMPY_NAMES.get(dtype)


def _parts(key: str) -> Path:
    return tuple(int(p) if p.isdigit() else p for p in str(key).split("."))


def tree_leaves_with_path(tree: Any) -> List[Tuple[Path, torch.Tensor]]:
    """``(path, tensor)`` for every tensor of ``tree`` (dicts, lists,
    ``Params`` and ``ModuleList`` modules), in the reference's flatten
    order (module docstring).  A path holds strings for keys and ints for
    list indices."""
    out = []

    def walk(node: Any, path: Path) -> None:
        if isinstance(node, torch.Tensor):
            out.append((path, node))
        elif isinstance(node, nn.ModuleList):
            for i, child in enumerate(node):
                walk(child, path + (i,))
        elif isinstance(node, nn.Module):
            for key, child in node.named_children():
                walk(child, path + _parts(key))
            for key, p in node.named_parameters(recurse=False):
                walk(p, path + _parts(key))
        elif isinstance(node, dict):
            for key, child in node.items():
                walk(child, path + _parts(key))
        elif isinstance(node, (list, tuple)):
            for i, child in enumerate(node):
                walk(child, path + (i,))

    walk(tree, ())
    out.sort(key=lambda e: tuple((isinstance(p, str), p) for p in e[0]))
    return out


def _treedef(paths: List[Path]) -> str:
    """``str(jax.tree_util.tree_structure(t))`` of the nested dicts and
    lists whose leaves sit at ``paths``."""
    leaf = object()
    root: dict = {}
    for path in paths:
        if not path:
            return "PyTreeDef(*)"
        node = root
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = leaf

    def fmt(node) -> str:
        if node is leaf:
            return "*"
        keys = sorted(node, key=lambda k: (isinstance(k, str), k))
        if keys and all(isinstance(k, int) for k in keys):
            return "[" + ", ".join(fmt(node[k]) for k in keys) + "]"
        return "{" + ", ".join(f"{k!r}: {fmt(node[k])}" for k in keys) + "}"

    return f"PyTreeDef({fmt(root)})"


def tree_signature(tree: Any) -> dict:
    """The structural signature of a state tree, JSON-serializable: the
    treedef string (as the reference's ``jax.tree_util`` prints it for the
    same nested dicts and lists) and each tensor's shape and numpy dtype
    name (torch's name where numpy has none), in flatten order.  Two
    trees with equal signatures exchange checkpointed arrays slot for
    slot.  Non-tensor values (the decay mask) are not part of it."""
    flat = tree_leaves_with_path(tree)
    return {"treedef": _treedef([p for p, _ in flat]),
            "leaves": [{"shape": list(t.shape),
                        "dtype": (numpy_dtype_name(t.dtype)
                                  or str(t.dtype).replace("torch.", ""))}
                       for _, t in flat]}


_DIGEST_CHUNK = 1 << 24
_BITS = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def _leaf_sums(t: torch.Tensor) -> torch.Tensor:
    """Two int64 sums of ``t``'s bit patterns on its device, plain and
    weighted by position (wrapping): a changed bit or a moved element
    changes them."""
    bits = t.detach().contiguous().view(-1).view(_BITS[t.element_size()])
    out = torch.zeros(2, dtype=torch.int64, device=t.device)
    for lo in range(0, bits.numel(), _DIGEST_CHUNK):
        c = bits[lo: lo + _DIGEST_CHUNK].to(torch.int64)
        w = torch.arange(lo + 1, lo + 1 + c.numel(), dtype=torch.int64,
                         device=t.device)
        out += torch.stack([c.sum(), (c * w).sum()])
    return out


def state_digest(tree: Any) -> str:
    """A digest of every tensor of ``tree`` (paths, shapes, dtypes and bit
    patterns), computed on the tensors' device with one copy to the host:
    two ranks whose states are bitwise equal give the same string."""
    flat = tree_leaves_with_path(tree)
    h = hashlib.sha256()
    for path, t in flat:
        h.update(f"{path}{tuple(t.shape)}{t.dtype}".encode())
    if flat:
        dev = flat[0][1].device
        sums = torch.stack([_leaf_sums(t).to(dev) for _, t in flat]).cpu()
        h.update(sums.numpy().tobytes())
    return h.hexdigest()

"""Production-mesh dry-run: run every (arch x shape x mesh) cell's real
step on fake tensors as one rank of the mesh (port of
``repro/launch/dryrun.py``).

For each cell:

* the default process group is torch's fake backend at 256 or 512 ranks
  (``launch/mesh.fake_process_group``), this process rank 0, and the mesh
  ``launch/mesh.make_production_mesh``'s;
* the state, batch and cache are ``launch/specs``'s stand-ins made fake
  tensors (``FakeTensorMode``: shapes, no storage) and then ``DTensor``s
  under the cell's placements (``parallel/sharding.param_shardings``,
  ``cache_specs``, ``_batch_shardings``);
* the cell's own step runs: the train step with AdamW
  (``train/step.make_train_step`` over ``causal_lm.lm_loss``), the prefill
  forward or one decode step (``causal_lm.decode_step``), under
  ``implicit_replication`` (the model builds plain tables: RoPE, masks,
  pair indices), with every parameter grad redistributed to its
  parameter's placements (the reference's ``out_shardings``: a grad left
  ``Partial`` issues no collective, so it would count no traffic);
* it records, for this rank: the state's resident bytes (its local
  shards), the live peak during the step (``MemTracker``, DTensor's
  global shape runs left out), the flops and
  bytes of its own local ops (``_Recorder``: a dispatch mode that leaves
  ``DTensor`` ops to ``DTensor`` and counts the local ops they become),
  the collectives' result bytes by kind (and ``CommDebugMode``'s counts),
  the feature-sharded executor's exchanges (``FeatureMesh.stats``),
  ``model_flops``, the roofline terms on ``hlo_analysis.HW`` (the card's
  data-sheet peaks, nothing measured) and ``useful_flops_ratio``.

A cell that fails is recorded with its error and traceback.  Profile
``spm_feat`` runs the two_level SPM linears in the rank form of the
feature-sharded executor over the mesh's ``"model"`` group of 16.

Usage (the CPU; no card):

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-1.7b \\
      --shape train_4k --profile spm_dp
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --profile tp
  PYTHONPATH=src python -m repro_torch.launch.dryrun --report

Results land in ``results/torch_dryrun/<mesh>/<arch>__<shape>[__<impl>]
[__<profile>][__noremat][__bf16logits].json``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import time
import traceback
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist
from torch import nn
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import (ARCH_IDS, SHAPES, arch_shapes, get_config,
                                 with_feature_sharding, with_overrides)
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.launch import hlo_analysis as H
from repro_torch.launch.mesh import (PRODUCTION_MESHES, fake_process_group,
                                     make_production_mesh)
from repro_torch.launch.specs import abstract_cache, abstract_state, \
    input_specs
from repro_torch.models import causal_lm as LM
from repro_torch.models import transformer as T
from repro_torch.optim.adamw import OptimizerConfig
from repro_torch.parallel import sharding as SH
from repro_torch.parallel.ctx import FeatureMesh, activation_sharding
from repro_torch.train.step import make_train_step

__all__ = ["RESULTS_DIR", "lower_cell", "model_flops", "run_cell", "main"]

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "torch_dryrun")

aten = torch.ops.aten


# ---------------------------------------------------------------------------
# what a rank does: flops, bytes and collectives of its local ops
# ---------------------------------------------------------------------------

def _collective_ops() -> Dict[Any, str]:
    """Collective ops, by their overload packet, to the reference's
    kinds."""
    fc = torch.ops._c10d_functional
    c10d = torch.ops.c10d
    table = {fc.all_reduce: "all-reduce", fc.all_reduce_: "all-reduce",
             fc.all_gather_into_tensor: "all-gather",
             fc.reduce_scatter_tensor: "reduce-scatter",
             fc.all_to_all_single: "all-to-all",
             c10d.allreduce_: "all-reduce", c10d.allgather_: "all-gather",
             c10d.reduce_scatter_: "reduce-scatter",
             c10d.alltoall_base_: "all-to-all"}
    for name, kind in (("all_gather_into_tensor_out", "all-gather"),
                       ("_allgather_base_", "all-gather"),
                       ("_reduce_scatter_base_", "reduce-scatter")):
        for ns in (fc, c10d):
            if hasattr(ns, name):
                table[getattr(ns, name)] = kind
    return table


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for t in tree:
            yield from _tensors(t)
    elif isinstance(tree, dict):
        for t in tree.values():
            yield from _tensors(t)


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


def _is_view(func) -> bool:
    """Whether ``func`` returns an alias of an input without writing it:
    it moves no bytes."""
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


_REDUCTIONS = ("sum", "mean", "amax", "amin", "max", "min", "prod",
               "logsumexp", "_log_softmax", "_softmax", "norm",
               "linalg_vector_norm", "cumsum", "var_mean", "std", "var")


class _Recorder(TorchDispatchMode):
    """Counts what this rank's local tensors go through.  An op with a
    ``DTensor`` argument is left to ``DTensor`` (``NotImplemented``): the
    local ops it becomes, collectives included, come back here.

    flops: the flop counter's formulas where it has one (products,
    convolutions, attention), else one a result element for a pointwise op
    and one an input element for a reduction; bytes: every tensor an op
    reads and writes, views excepted; collectives: ``(kind, result
    bytes)``, with a separate tally while ``bucket`` is set (the grads'
    reduction)."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self.registry = flop_registry
        self.coll = _collective_ops()
        self.flops = 0
        self.bytes = 0
        self.records: list = []
        self.bucket: Optional[list] = None
        self.shadow = 0
        self._saved = None

    def __enter__(self):
        # DTensor runs each op once more on global fake tensors to learn its
        # output's shape: that run is no rank's work, so it is not counted
        from torch.distributed.tensor._sharding_prop import \
            ShardingPropagator as SP
        orig = self._saved = SP._propagate_tensor_meta_non_cached
        rec = self

        def shadowed(prop, op_schema):
            rec.shadow += 1
            try:
                return orig(prop, op_schema)
            finally:
                rec.shadow -= 1

        SP._propagate_tensor_meta_non_cached = shadowed
        return super().__enter__()

    def __exit__(self, *exc):
        from torch.distributed.tensor._sharding_prop import \
            ShardingPropagator as SP
        SP._propagate_tensor_meta_non_cached = self._saved
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self.shadow:
            return out
        packet = func._overloadpacket
        kind = self.coll.get(packet)
        if kind is not None:
            rec = (kind, _nbytes(out))
            self.records.append(rec)
            if self.bucket is not None:
                self.bucket.append(rec)
            return out
        if _is_view(func) or packet is torch.ops._c10d_functional.wait_tensor:
            return out
        self.bytes += _nbytes(args) + _nbytes(kwargs) + _nbytes(out)
        if packet in self.registry:
            self.flops += int(self.registry[packet](*args, **kwargs,
                                                    out_val=out))
        elif torch.Tag.pointwise in func.tags:
            self.flops += sum(t.numel() for t in _tensors(out))
        elif packet.__name__ in _REDUCTIONS:
            self.flops += sum(t.numel() for t in _tensors(args))
        return out


def _local_mem_tracker(rec: _Recorder):
    """A ``MemTracker`` of this rank's live tensors that ignores DTensor's
    global shape runs (``_Recorder.shadow``): their outputs are no rank's
    memory, and one global logits tensor would swamp the peak."""
    from torch.distributed._tools.mem_tracker import MemTracker

    class LocalMemTracker(MemTracker):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if rec.shadow:
                return func(*args, **(kwargs or {}))
            return super().__torch_dispatch__(func, types, args, kwargs)

    return LocalMemTracker()


# ---------------------------------------------------------------------------
# ops DTensor has no rule for, on the port's path
# ---------------------------------------------------------------------------

_RULES_ADDED = False


def _add_sharding_rules() -> None:
    """Rules for the ops of the port's plain versions that ``DTensor``
    lacks: ``fill_`` with a 0-dim value (the backward zeroes the dead
    lanes of a grad in place: the placement stays, a ``Partial`` grad
    included, since zero sums to zero)."""
    global _RULES_ADDED
    if _RULES_ADDED:
        return
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding

    @register_sharding(aten.fill_.Tensor)
    def _fill_tensor(self, value):
        out = [([Replicate()], [Replicate(), Replicate()]),
               ([Partial()], [Partial(), Replicate()])]
        out += [([Shard(d)], [Shard(d), Replicate()])
                for d in range(len(self.shape))]
        return out

    _RULES_ADDED = True


# ---------------------------------------------------------------------------
# placements of a cell
# ---------------------------------------------------------------------------

def _batch_shardings(mesh, batch_specs: dict, shape: ShapeSpec,
                     profile: str = "tp") -> Dict[str, tuple]:
    """The placements of each batch entry (the reference's rule): batch
    over the data axes; under ``spm_dp*`` for train and prefill over
    ``"model"`` too (full-mesh DP); a 500k decode's batch of one
    replicated; ``spm_dp_g2``'s token ids replicated over ``"model"``.
    Where the axes do not divide the batch (``prefill_32k``'s 32 rows over
    256 ranks) the trailing ones are dropped until they do, as
    ``_drop_indivisible`` drops a parameter's: the reference's ``jit``
    would refuse the uneven split, and ``DTensor`` cannot reshape one."""
    dp_base_all = SH.data_axes(mesh)
    dp_all = dp_base_all
    if profile.startswith("spm_dp") and shape.kind != "decode":
        dp_all = dp_all + ("model",)

    axes = SH.mesh_axes(mesh)

    def fit(ax: tuple, size: int) -> tuple:
        # the longest prefix of the batch axes that divides the batch
        while ax and size % math.prod(axes[a] for a in ax):
            ax = ax[:-1]
        return ax

    def one(name: str, x: torch.Tensor):
        nd = x.dim()
        b = x.shape[1] if name == "positions" else x.shape[0] if nd else 1
        dp, dp_base = fit(dp_all, b), fit(dp_base_all, b)
        if name == "index" or nd == 0:
            spec = ()
        elif name == "positions":                       # (3, B, S)
            spec = (None, dp, None)
        elif shape.kind == "decode" and shape.seq_sharded:
            spec = (None,) * nd                         # B == 1
        elif name == "tokens" and profile == "spm_dp_g2":
            spec = (dp_base,) + (None,) * (nd - 1)
        else:
            spec = (dp,) + (None,) * (nd - 1)
        return SH.placements(spec, mesh)

    return {k: one(k, v) for k, v in batch_specs.items()}


def _fake_like(t: torch.Tensor) -> torch.Tensor:
    """A fake CPU tensor of ``t``'s shape and dtype (call under the fake
    mode)."""
    return torch.empty(t.shape, dtype=t.dtype, device="cpu")


def _dtensor(t: torch.Tensor, mesh, placements) -> torch.Tensor:
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(_fake_like(t), mesh, list(placements),
                             src_data_rank=None)


def _local_bytes(tree) -> int:
    """Bytes of this rank's local shards of every tensor in ``tree``."""
    from torch.distributed.tensor import DTensor
    return sum(t.to_local().numel() * t.element_size()
               if isinstance(t, DTensor) else t.numel() * t.element_size()
               for t in _tensors(tree))


def _place_params(params: nn.Module, placements: Dict[str, tuple],
                  mesh) -> None:
    """Replace every parameter of ``params`` (meta) by a fake ``DTensor``
    parameter under its placements, in place."""
    for name, p in list(params.named_parameters()):
        *path, leaf = name.split(".")
        mod = params
        for part in path:
            mod = mod._modules[part]
        mod._parameters[leaf] = nn.Parameter(
            _dtensor(p, mesh, placements[name]), requires_grad=p.requires_grad)


class _GradReduction:
    """Redistributes each parameter's grad to its parameter's placements
    as it is accumulated, recording the grad's placements and the
    collectives that took (the reference's ``out_shardings``).
    ``skip`` leaves one grad as it came (a planted fault for the check)."""

    def __init__(self, params: nn.Module, rec: _Recorder,
                 skip: Optional[str] = None):
        self.rec = rec
        self.seen: Dict[str, dict] = {}
        self.handles = []
        for name, p in params.named_parameters():
            self.handles.append(p.register_post_accumulate_grad_hook(
                self._hook(name, skip == name)))

    def _hook(self, name: str, skip: bool):
        def hook(p):
            from torch.distributed.tensor import Partial
            g = p.grad
            partial = [i for i, pl in enumerate(g.placements)
                       if isinstance(pl, Partial)]
            bucket: list = []
            if not skip:
                self.rec.bucket = bucket
                try:
                    p.grad = g.redistribute(p.device_mesh, p.placements)
                finally:
                    self.rec.bucket = None
            self.seen[name] = {
                "partial_dims": partial,
                "local_bytes": g.to_local().numel() * g.element_size(),
                "collectives": bucket,
                "placements": [str(pl) for pl in p.grad.placements]}
        return hook

    def check(self, names) -> Optional[str]:
        """None when every parameter's grad arrived and left with its
        parameter's placements, each partial mesh dim reduced by a
        collective; else what is wrong."""
        missing = [n for n in names if n not in self.seen]
        if missing:
            return f"no grad for {missing[:3]}"
        for n, s in self.seen.items():
            if any("Partial" in pl for pl in s["placements"]):
                return f"grad of {n} left partial: {s['placements']}"
            if s["partial_dims"] and not s["collectives"]:
                return f"grad of {n} was partial and moved no bytes"
        return None

    def close(self) -> None:
        for h in self.handles:
            h.remove()


# ---------------------------------------------------------------------------
# the cell
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _fresh_tensor_caches():
    """Empty the port's per-device tensor caches (RoPE frequencies, the
    sharded executor's index tables) on entry and exit, so that no fake
    tensor made here outlives the cell or meets another cell's fake
    mode."""
    from repro_torch.layers import rope
    from repro_torch.parallel import spm_shard
    caches = (rope._freqs, spm_shard._cross_rows_on, spm_shard._low_on)
    for c in caches:
        c.cache_clear()
    try:
        yield
    finally:
        for c in caches:
            c.cache_clear()


def _feature_rank_mesh(mesh) -> FeatureMesh:
    """The rank form of ``FeatureMesh`` over ``mesh``'s ``"model"`` group:
    this rank's coordinate on it is its shard."""
    group = mesh.get_group("model")
    n = group.size()
    return FeatureMesh((torch.device("cpu"),) * n,
                       rank=dist.get_rank(group), group=group,
                       backend="fake")


def lower_cell(cfg: T.ModelConfig, shape: ShapeSpec, mesh,
               profile: str = "tp", *,
               skip_grad: Optional[str] = None) -> dict:
    """Build the cell's state, batch and cache as fake ``DTensor``s under
    its placements and run its step once; returns what this rank did
    (``"state_bytes"``, ``"peak_bytes"``, ``"flops"``, ``"bytes"``,
    ``"collectives"``, ``"comm_counts"``, ``"grads"``, ``"exchange"``,
    ``"check"``).  ``skip_grad`` leaves that parameter's grad unreduced."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.debug import CommDebugMode
    from torch.distributed.tensor.experimental import implicit_replication

    _add_sharding_rules()
    if profile == "spm_dp" and cfg.input_kind == "tokens":
        cfg = with_overrides(cfg, embed_onehot=True)
    features = None
    act = contextlib.nullcontext()
    if profile == "spm_dp_g2" and shape.kind != "decode":
        act = activation_sharding(mesh, shard_heads=False, full_batch=True)
    if profile == "spm_feat":
        features = _feature_rank_mesh(mesh)
        act = activation_sharding(mesh, shard_heads=False,
                                  shard_feature=True, features=features)
    fake_mode = FakeTensorMode()
    rec = _Recorder()
    comm = CommDebugMode()
    out: Dict[str, Any] = {}
    specs = input_specs(cfg, shape)
    with fake_mode:
        batch_pl = _batch_shardings(mesh, specs, shape, profile)
        batch = {k: _dtensor(v, mesh, batch_pl[k]) for k, v in specs.items()}
        state = abstract_state(cfg)
        params = state["params"]
        pl = SH.param_shardings(mesh, params, profile, cfg=cfg)
        _place_params(params, pl, mesh)
        grads = None
        if shape.kind == "train":
            for m in ("mu", "nu"):
                state["opt"][m] = {k: _dtensor(v, mesh, pl[k])
                                   for k, v in state["opt"][m].items()}
            rep = SH.placements((), mesh)
            state["opt"]["count"] = _dtensor(state["opt"]["count"], mesh, rep)
            state["step"] = _dtensor(state["step"], mesh, rep)
            resident = [params, state["opt"]["mu"], state["opt"]["nu"]]
            grads = _GradReduction(params, rec, skip_grad)
        elif shape.kind == "prefill":
            params.requires_grad_(False)
            resident = [params]
        else:
            params.requires_grad_(False)
            cache = abstract_cache(cfg, shape.global_batch, shape.seq_len)
            cache_pl = SH.cache_specs(mesh, cache,
                                      seq_sharded=shape.seq_sharded)

            def place(c, p):
                if isinstance(c, dict):
                    return {k: place(c[k], p[k]) for k in c}
                if isinstance(c, list):
                    return [place(a, b) for a, b in zip(c, p)]
                return _dtensor(c, mesh, p)

            cache = place(cache, cache_pl)
            resident = [params, cache]
        out["state_bytes"] = sum(
            _local_bytes(dict(r.named_parameters()) if isinstance(
                r, nn.Module) else r) for r in resident)
        mem = _local_mem_tracker(rec)
        mem.track_external(params)
        with mem, comm, rec, act, implicit_replication():
            if shape.kind == "train":
                step = make_train_step(lambda p, b: LM.lm_loss(p, b, cfg),
                                       OptimizerConfig())
                step(state, batch)
            elif shape.kind == "prefill":
                with torch.no_grad():
                    T.forward(params, cfg, tokens=batch.get("tokens"),
                              embeds=batch.get("embeds"),
                              positions=batch.get("positions"))
            else:
                with torch.no_grad():
                    # the last slot: the whole cache is attended
                    LM.decode_step(params, cfg, batch["tokens"], cache,
                                   shape.seq_len - 1)
        peak = mem.get_tracker_snapshot("peak")
        out["peak_bytes"] = max((d.get("Total", 0) for d in peak.values()),
                                default=0)
        if shape.kind != "train":
            out["peak_bytes"] += _local_bytes(resident[1:])
    out["flops"] = rec.flops
    out["bytes"] = rec.bytes
    records = list(rec.records)
    if features is not None:
        st = features.stats
        out["exchange"] = {"calls": st.get("exchange_calls", 0),
                           "bytes": st.get("exchange_bytes", 0)}
        if st.get("exchange_bytes"):
            records.append(("collective-permute", st["exchange_bytes"]))
    out["collectives"] = H.collective_bytes(records)
    out["comm_counts"] = {str(k): v
                          for k, v in comm.get_comm_counts().items()}
    out["check"] = None
    if grads is not None:
        grads.close()
        out["check"] = grads.check(dict(params.named_parameters()))
        out["grads"] = grads.seen
        out["grad_collectives"] = H.collective_bytes(
            r for s in grads.seen.values() for r in s["collectives"])
    return out


def model_flops(cfg: T.ModelConfig, shape: ShapeSpec) -> dict:
    """MODEL_FLOPS = 6 N D (train) or 2 N D (forward only), N the
    non-embedding active params (an MoE counts its top_k experts)."""
    params = abstract_state(cfg)["params"]
    total = embed = expert = 0
    for name, p in params.named_parameters():
        path, _ = SH.reference_path(name, cfg)
        total += p.numel()
        embed += p.numel() if "embed" in path else 0
        expert += p.numel() if "/experts/" in path else 0
    n_active = total - embed
    if cfg.n_experts:
        n_active = n_active - expert + int(expert * cfg.top_k
                                           / cfg.n_experts)
    tokens = (shape.global_batch * shape.seq_len if shape.kind != "decode"
              else shape.global_batch)
    mf = (6 if shape.kind == "train" else 2) * n_active * tokens
    return {"params_total": total, "params_active_nonembed": n_active,
            "tokens": tokens, "model_flops": mf}


def _trace() -> str:
    """The current exception's traceback: the port's own frames, then the
    last 1500 characters."""
    text = traceback.format_exc()
    ours = [ln for ln in text.splitlines() if "repro_torch" in ln]
    return "\n".join(ours) + "\n...\n" + text[-1500:]


def _suffix(linear_impl, profile, remat, bf16_logits) -> str:
    s = f"__{linear_impl}" if linear_impl else ""
    if profile != "tp":
        s += f"__{profile}"
    if not remat:
        s += "__noremat"
    if bf16_logits:
        s += "__bf16logits"
    return s


@contextlib.contextmanager
def _time_limit(seconds: Optional[float]):
    """Raise ``TimeoutError`` in the block after ``seconds`` (none: no
    limit), so that a cell past its limit is recorded as failed."""
    if not seconds:
        yield
        return
    import signal

    def expire(signum, frame):
        raise TimeoutError(f"the cell took more than {seconds:.0f} s")

    prev = signal.signal(signal.SIGALRM, expire)
    signal.setitimer(signal.ITIMER_REAL, seconds)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, prev)


def run_cell(arch: str, shape_name: str, mesh_kind: str,
             linear_impl: Optional[str] = None, save: bool = True,
             profile: str = "tp", remat: bool = True,
             bf16_logits: bool = False, *, cfg: Optional[T.ModelConfig] = None,
             mesh_shape: Optional[tuple] = None,
             shape: Optional[ShapeSpec] = None,
             skip_grad: Optional[str] = None,
             limit_s: Optional[float] = None) -> dict:
    """One cell in a fake process group of its own; returns (and with
    ``save`` writes) its record.  ``cfg``, ``mesh_shape`` (a smaller
    ``("data", "model")`` mesh) and ``shape`` replace the arch's config,
    the production mesh and the named shape, for tests; past ``limit_s``
    seconds the cell fails with a ``TimeoutError``."""
    shape = shape or SHAPES[shape_name]
    cfg = cfg or get_config(arch)
    if linear_impl:
        cfg = with_overrides(cfg, linear_impl=linear_impl)
    if not remat:
        cfg = with_overrides(cfg, remat=False)
    if bf16_logits:
        cfg = with_overrides(cfg, logits_dtype="bfloat16")
    dims, axes = PRODUCTION_MESHES[mesh_kind == "multi"]
    if mesh_shape is not None:
        dims, axes = tuple(mesh_shape), ("data", "model")
    n_ranks = math.prod(dims)
    if profile == "spm_feat":
        if cfg.linear_impl == "dense":
            cfg = with_overrides(cfg, linear_impl="spm_general")
        cfg = with_feature_sharding(cfg, dims[axes.index("model")])
    rec: Dict[str, Any] = {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind,
        "mesh_shape": list(dims), "linear_impl": cfg.linear_impl,
        "n_chips": n_ranks, "profile": profile, "remat": remat,
        "rank": 0, "hw": {k: v for k, v in H.HW.items()}}
    t0 = time.time()
    try:
        with _time_limit(limit_s), fake_process_group(n_ranks), \
                _fresh_tensor_caches():
            if mesh_shape is None:
                mesh = make_production_mesh(multi_pod=mesh_kind == "multi")
            else:
                from torch.distributed.device_mesh import init_device_mesh
                mesh = init_device_mesh("cpu", dims, mesh_dim_names=axes)
            got = lower_cell(cfg, shape, mesh, profile, skip_grad=skip_grad)
        t_step = time.time() - t0
        if got["check"] is not None:
            raise AssertionError(got["check"])
        mf = model_flops(cfg, shape)
        coll = got["collectives"]
        terms = H.roofline_terms(got["flops"], got["bytes"], coll["total"])
        rec.update({
            "ok": True, "t_step_s": round(t_step, 1),
            "memory": H.memory_terms(got["state_bytes"], got["peak_bytes"]),
            "cost": H.cost_terms(got["flops"], got["bytes"]),
            "collectives": coll, "comm_counts": got["comm_counts"],
            "grad_collectives": got.get("grad_collectives"),
            "grads": {k: {"partial_dims": v["partial_dims"],
                          "collectives": v["collectives"]}
                      for k, v in got.get("grads", {}).items()},
            "exchange": got.get("exchange"),
            "model": mf, "roofline": terms,
            "useful_flops_ratio": (mf["model_flops"] / n_ranks / got["flops"]
                                   if got["flops"] else None)})
        print(f"[OK] {arch} x {shape_name} x {mesh_kind} x {profile} "
              f"({t_step:.0f}s) flops/rank={got['flops']:.3g} "
              f"bytes/rank={got['bytes']:.3g} coll/rank={coll['total']:.3g} "
              f"state={got['state_bytes'] / 2**30:.2f}GiB "
              f"peak={got['peak_bytes'] / 2**30:.2f}GiB "
              f"dom={terms['dominant']}", flush=True)
    except Exception as e:   # noqa: BLE001 — record the failure, keep going
        rec.update({"ok": False, "t_step_s": round(time.time() - t0, 1),
                    "error": f"{type(e).__name__}: {e}",
                    "traceback": _trace()})
        print(f"[FAIL] {arch} x {shape_name} x {mesh_kind} x {profile}: "
              f"{type(e).__name__}: {str(e)[:300]}", flush=True)
    if save:
        d = os.path.join(RESULTS_DIR, mesh_kind)
        os.makedirs(d, exist_ok=True)
        name = (f"{arch}__{shape_name}"
                f"{_suffix(linear_impl, profile, remat, bf16_logits)}.json")
        with open(os.path.join(d, name), "w") as f:
            json.dump(rec, f, indent=1, default=str)
    return rec


_KIND_ABBREV = {"all-reduce": "AR", "all-gather": "AG",
                "reduce-scatter": "RS", "all-to-all": "A2A",
                "collective-permute": "CP"}


def _cell_summary(rec: Optional[dict]) -> str:
    """One profile's record of a cell in a few words: state/peak GiB,
    TFLOP, collective GB by kind, the dominant term, seconds; or the
    error's first line."""
    if rec is None:
        return "not run"
    if not rec["ok"]:
        return "FAIL: " + rec["error"].splitlines()[0][:90].replace("|", "/")
    gib = 2 ** 30
    coll = rec["collectives"]
    kinds = ", ".join(f"{_KIND_ABBREV[k]} {coll[k] / 1e9:.3g}"
                      for k in _KIND_ABBREV if coll[k])
    dom = rec["roofline"]["dominant"].replace("_s", "")
    return (f"{rec['memory']['state_bytes'] / gib:.3g} / "
            f"{rec['memory']['peak_bytes'] / gib:.4g}; "
            f"{rec['cost']['flops'] / 1e12:.3g}; {kinds or '0'}; {dom}; "
            f"{rec['t_step_s']:.0f}")


def report(mesh_kind: str = "single", profiles=("spm_dp", "tp")) -> str:
    """A markdown table of the saved records of ``mesh_kind``: one row a
    cell, one column a profile (``_cell_summary``); then a line for each
    record of another profile."""
    d = os.path.join(RESULTS_DIR, mesh_kind)
    head = ("| cell | " + " | ".join(profiles) + " |\n|---|"
            + "---|" * len(profiles))
    rows, extra = [head], []
    for arch in ARCH_IDS:
        for sp in arch_shapes(arch):
            cols = []
            for prof in profiles:
                fp = os.path.join(d, f"{arch}__{sp.name}"
                                  f"{_suffix(None, prof, True, False)}.json")
                rec = None
                if os.path.exists(fp):
                    with open(fp) as f:
                        rec = json.load(f)
                cols.append(_cell_summary(rec))
            rows.append(f"| {arch} × {sp.name} | " + " | ".join(cols) + " |")
            for prof in SH.PROFILES:
                fp = os.path.join(d, f"{arch}__{sp.name}"
                                  f"{_suffix(None, prof, True, False)}.json")
                if prof not in profiles and os.path.exists(fp):
                    with open(fp) as f:
                        extra.append(f"- {prof}, {arch} × {sp.name}: "
                                     f"{_cell_summary(json.load(f))}")
    return "\n".join(rows + [""] + extra)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=tuple(SHAPES))
    ap.add_argument("--mesh", choices=("single", "multi", "both"),
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--linear-impl", default=None,
                    choices=(None, "dense", "spm_general", "spm_rotation"))
    ap.add_argument("--profile", default="tp", choices=SH.PROFILES)
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--bf16-logits", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--cell-limit", type=float, default=None,
                    help="seconds a cell may take before it is recorded as "
                         "failed (default: no limit)")
    ap.add_argument("--report", action="store_true",
                    help="print the saved records of --mesh as a table")
    args = ap.parse_args(argv)
    if args.report:
        for mesh_kind in (("single", "multi") if args.mesh == "both"
                          else (args.mesh,)):
            print(report(mesh_kind))
        return

    meshes = ("single", "multi") if args.mesh == "both" else (args.mesh,)
    if args.all:
        cells = [(a, sp.name) for a in ARCH_IDS for sp in arch_shapes(a)]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        cells = [(args.arch, args.shape)]
    suffix = _suffix(args.linear_impl, args.profile, not args.no_remat,
                     args.bf16_logits)
    n_fail = 0
    for mesh_kind in meshes:
        for arch, shape_name in cells:
            if args.skip_existing:
                fp = os.path.join(RESULTS_DIR, mesh_kind,
                                  f"{arch}__{shape_name}{suffix}.json")
                if os.path.exists(fp):
                    with open(fp) as f:
                        if json.load(f).get("ok"):
                            continue
            rec = run_cell(arch, shape_name, mesh_kind, args.linear_impl,
                           profile=args.profile, remat=not args.no_remat,
                           bf16_logits=args.bf16_logits,
                           limit_s=args.cell_limit)
            n_fail += 0 if rec["ok"] else 1
    print(f"done; {n_fail} failures")
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()

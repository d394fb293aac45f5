"""Config construction helpers (port of ``repro/configs/base.py``)."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from repro_torch.models.transformer import LayerSpec, ModelConfig

__all__ = ["dense_layers", "local_global_layers", "moe_layers",
           "mamba_layers", "hybrid_layers", "with_overrides",
           "with_compressed_pod_grads",
           "with_fused_linears", "with_feature_sharding",
           "with_overlap_executor", "with_quantized_io"]


def dense_layers(n: int) -> Tuple[LayerSpec, ...]:
    """``n`` identical full-attention + dense-FFN layers."""
    return tuple([LayerSpec()] * n)


def local_global_layers(n: int, local_per_global: int,
                        window: int) -> Tuple[LayerSpec, ...]:
    """Gemma3's pattern: ``local_per_global`` sliding-window layers with
    the local RoPE table, then one global layer, repeated."""
    group = ([LayerSpec(window=window, rope="local")] * local_per_global
             + [LayerSpec()])
    reps = n // len(group)
    if reps * len(group) != n:
        raise ValueError(f"{n} layers are not whole groups of "
                         f"{len(group)}")
    return tuple(group * reps)


def moe_layers(n: int) -> Tuple[LayerSpec, ...]:
    """``n`` attention + MoE-FFN layers (the Qwen3-MoE / Llama4 pattern)."""
    return tuple([LayerSpec(mlp="moe")] * n)


def mamba_layers(n: int) -> Tuple[LayerSpec, ...]:
    """``n`` Mamba2 mixer layers without an FFN (the Mamba2 backbone)."""
    return tuple([LayerSpec(mixer="mamba", mlp="none")] * n)


def hybrid_layers(n: int, attn_every: int) -> Tuple[LayerSpec, ...]:
    """Zamba2's pattern: a Mamba2 backbone with the shared attention + FFN
    block applied before every ``attn_every``-th layer (layer 0 first)."""
    return tuple(LayerSpec(mixer="mamba", mlp="none",
                           shared_block=(i % attn_every == 0))
                 for i in range(n))


def with_overrides(cfg: ModelConfig, **kw) -> ModelConfig:
    """Frozen-dataclass field override."""
    return dataclasses.replace(cfg, **kw)


def with_fused_linears(cfg: ModelConfig,
                       on: Optional[bool] = True) -> ModelConfig:
    """Set the fused-kernel knob ``spm_use_kernel`` on every SPM linear
    (None = auto, the kernel path; True = the same, forced; False = the
    composition)."""
    return dataclasses.replace(cfg, spm_use_kernel=on)


def with_feature_sharding(cfg: ModelConfig, n_shards: int) -> ModelConfig:
    """Switch every SPM linear to the two_level schedule with its feature
    axis distributable over ``n_shards`` shards.  The sharded executor
    (``parallel/spm_shard.py``) engages inside
    ``parallel.ctx.activation_sharding(mesh, shard_feature=True)`` with a
    mesh of that many shards; elsewhere the schedule runs unsharded.
    Sharded linears never block-fuse."""
    return dataclasses.replace(cfg, spm_schedule="two_level",
                               spm_n_shards=n_shards)


def with_overlap_executor(cfg: ModelConfig,
                          on: Optional[bool] = True) -> ModelConfig:
    """Set the sharded executor's overlap knob ``spm_overlap`` on every SPM
    linear (True: the overlap schedule, each ``{local run -> cross}`` pair
    one K5 launch forward and one K6 backward on the card; None = auto and
    False: the step-serial schedule).  Consulted only where the sharded
    executor engages (``with_feature_sharding`` and a matching
    ``activation_sharding`` context)."""
    return dataclasses.replace(cfg, spm_overlap=on)


def with_quantized_io(cfg: ModelConfig) -> ModelConfig:
    """Set the int8 knobs on every SPM linear: ``spm_quant_acts`` (int8
    activation I/O between the kernel runs, for plans whose runs share one
    tile; the others keep f32/bf16 I/O) and ``spm_quant_coeffs`` (int8
    coefficient tables with one scale a stage).  Quantized linears are
    never block-fused."""
    return dataclasses.replace(cfg, spm_quant_acts=True,
                               spm_quant_coeffs=True)


def with_compressed_pod_grads(cfg: ModelConfig, on: bool = True
                              ) -> ModelConfig:
    """Set ``compress_pod_grads``: a pod's gradient reduction runs through
    the int8 error-feedback all-reduce (``optim.compression.
    psum_compressed_ef``) with each member's residual in
    ``state["opt"]["ef"]``.  Read by ``launch.train`` under ``--pod-dp``,
    which builds ``train/step.make_pod_train_step`` with it; alone it
    changes nothing, as in the reference."""
    return dataclasses.replace(cfg, compress_pod_grads=on)

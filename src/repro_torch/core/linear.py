"""Drop-in linear layer: dense baseline or SPM (port of
``repro/core/linear.py``).

SPM linears operate over ``n = even_ceil(max(d_in, d_out))`` and tell
``spm_apply`` the true widths, so the kernel zero-fills the input to n on
chip and stores only the ``d_out`` outputs.

``schedule="two_level"`` with ``n_shards > 1`` makes the feature axis
distributable: under ``parallel/ctx.activation_sharding(mesh,
shard_feature=True)`` with ``n_shards`` shards, ``spm_apply`` runs the
linear in ``parallel/spm_shard.py``; outside such a block the same config
runs unsharded (two_level is a reordered butterfly).  Model configs carry
these as ``spm_schedule`` / ``spm_n_shards``
(``configs.base.with_feature_sharding``).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import torch

from repro_torch.core import spm as spm_mod
from repro_torch.core.eligibility import block_fusion_eligible, kernel_eligible
from repro_torch.core.pairings import default_n_stages
from repro_torch.core.spm import SPMConfig
from repro_torch.params import Params

__all__ = ["LinearConfig", "init_linear", "linear_apply",
           "linear_param_count", "spm_block_operands"]

SPM_IMPLS = ("spm_general", "spm_rotation")
LINEAR_IMPLS = ("dense",) + SPM_IMPLS


@dataclasses.dataclass(frozen=True)
class LinearConfig:
    """One linear's static configuration (the reference's forward fields)."""

    d_in: int
    d_out: int
    impl: str = "dense"
    use_bias: bool = True
    n_stages: Optional[int] = None       # None -> min(ceil(log2 n), 12)
    schedule: str = "butterfly"
    backward: str = "autodiff"
    init_scale: float = 0.05
    n_shards: int = 1                    # two_level feature shards
    param_dtype: torch.dtype = torch.float32
    use_kernel: Optional[bool] = None    # None/True: kernel path; False: off
    overlap: Optional[bool] = None       # sharded overlap schedule (True:
                                         # on; None/False: step-serial)
    quant_acts: bool = False             # int8 activation I/O (kernel path;
                                         # see SPMConfig.quant_acts)
    quant_coeffs: bool = False           # int8 per-stage coefficient tables

    def __post_init__(self):
        if self.impl not in LINEAR_IMPLS:
            raise ValueError(f"unknown linear impl {self.impl!r}")

    @property
    def is_spm(self) -> bool:
        """Whether this linear is SPM-parameterized."""
        return self.impl in SPM_IMPLS

    @property
    def n(self) -> int:
        """Internal SPM operator width."""
        m = max(self.d_in, self.d_out)
        return m + (m % 2)

    def spm_config(self) -> SPMConfig:
        """The SPMConfig realizing this linear (diag always on;
        ``custom_inverse`` becomes ``custom`` for the general variant).
        Memoized by value, so its schedule is built once per distinct
        linear rather than on every call of a decode step."""
        return _spm_config(self)


@functools.lru_cache(maxsize=None)
def _spm_config(cfg: LinearConfig) -> SPMConfig:
    variant = "rotation" if cfg.impl == "spm_rotation" else "general"
    n_stages = (cfg.n_stages if cfg.n_stages is not None
                else default_n_stages(cfg.n))
    backward = cfg.backward
    if backward == "custom_inverse" and variant != "rotation":
        backward = "custom"
    return SPMConfig(
        n=cfg.n, n_stages=n_stages, variant=variant,
        schedule=cfg.schedule, use_diag=True, use_bias=cfg.use_bias,
        backward=backward, init_scale=cfg.init_scale,
        n_shards=cfg.n_shards, param_dtype=cfg.param_dtype,
        use_kernel=cfg.use_kernel, overlap=cfg.overlap,
        quant_acts=cfg.quant_acts,
        quant_coeffs=cfg.quant_coeffs)


def init_linear(cfg: LinearConfig, generator: torch.Generator,
                device: torch.device) -> Params:
    """Dense: 1/sqrt(d_in) normal ``w`` (d_in, d_out) (+ zero ``b``); SPM:
    ``init_spm`` of the embedded square operator."""
    if cfg.impl == "dense":
        p = {"w": torch.randn(cfg.d_in, cfg.d_out, generator=generator,
                              device=device, dtype=cfg.param_dtype)
             / math.sqrt(cfg.d_in)}
        if cfg.use_bias:
            p["b"] = torch.zeros(cfg.d_out, dtype=cfg.param_dtype,
                                 device=device)
        return Params(p)
    return spm_mod.init_spm(cfg.spm_config(), generator, device)


def linear_apply(params, x: torch.Tensor, cfg: LinearConfig) -> torch.Tensor:
    """(..., d_in) -> (..., d_out)."""
    if cfg.impl == "dense":
        y = x @ params["w"].to(x.dtype)
        if cfg.use_bias:
            y = y + params["b"].to(x.dtype)
        return y
    if x.shape[-1] != cfg.d_in:
        raise ValueError(f"expected (..., {cfg.d_in}), got {tuple(x.shape)}")
    return spm_mod.spm_apply(params, x, cfg.spm_config(),
                             in_width=cfg.d_in, out_width=cfg.d_out)


def spm_block_operands(params, cfg: LinearConfig) -> Optional[dict]:
    """One stack's operands for the block kernel (``coeffs``, ``d_in``,
    ``d_out``, ``bias`` or None, ``strides``, ``n``), or None when this
    linear cannot be a stack of a fused block: dense, sharded (its feature
    axis is split over a mesh), quantized (the block kernel moves f32
    tiles), kernel-ineligible, or not a single full-width run."""
    if not cfg.is_spm or cfg.n_shards > 1:
        return None
    if cfg.quant_acts or cfg.quant_coeffs:
        return None
    scfg = cfg.spm_config()
    sched = scfg.pairing
    if not kernel_eligible(scfg, sched):
        return None
    strides = sched.strides()
    if not block_fusion_eligible(scfg.n, strides):
        return None
    return {
        "coeffs": spm_mod.stage_coeffs(params, scfg),
        "d_in": params["d_in"],
        "d_out": params["d_out"],
        "bias": params["bias"] if scfg.use_bias else None,
        "strides": strides,
        "n": scfg.n,
    }


def linear_param_count(cfg: LinearConfig) -> int:
    """Learnable parameters of this linear: O(nL) for SPM against
    d_in * d_out for dense."""
    if cfg.impl == "dense":
        return cfg.d_in * cfg.d_out + (cfg.d_out if cfg.use_bias else 0)
    scfg = cfg.spm_config()
    per_stage = scfg.n_pairs * (1 if scfg.variant == "rotation" else 4)
    total = scfg.n_stages * per_stage
    if scfg.odd:
        total += scfg.n_stages
    total += 2 * scfg.n
    if scfg.use_bias:
        total += scfg.n
    return total

"""MLP classifier students of the paper's §9.1–§9.2 (port of
``repro/models/mlp.py``).

Student: ``logits = W2 · φ(mix(x))`` where ``mix`` is dense or SPM via the
linear factory — the two students compared in Tables 1–2.  An SPM mix takes
the kernel path (K1 forward, K2 backward on the card).  The head stays a
dense ``torch.matmul``; entry points keep TF32 off, so it is f32.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.core.linear import LinearConfig, init_linear, linear_apply
from repro_torch.device import resolve_device
from repro_torch.params import Params

__all__ = ["MLPConfig", "init_mlp", "mlp_apply", "mlp_loss"]


@dataclasses.dataclass(frozen=True)
class MLPConfig:
    """A one-hidden-layer classifier; ``linear_impl`` is the swept knob."""

    n_features: int
    n_classes: int
    width: Optional[int] = None        # None -> square (width = n_features)
    linear_impl: str = "dense"
    spm_stages: Optional[int] = None
    spm_backward: str = "custom"
    spm_use_kernel: Optional[bool] = None
    param_dtype: torch.dtype = torch.float32

    @property
    def d_hidden(self) -> int:
        """The hidden width."""
        return self.width or self.n_features

    @property
    def mix(self) -> LinearConfig:
        """The swept linear: features -> hidden."""
        return LinearConfig(
            d_in=self.n_features, d_out=self.d_hidden,
            impl=self.linear_impl, n_stages=self.spm_stages,
            backward=self.spm_backward, use_kernel=self.spm_use_kernel,
            param_dtype=self.param_dtype)

    @property
    def head(self) -> LinearConfig:
        """The classification head, dense in both students (not a square
        mixer)."""
        return LinearConfig(d_in=self.d_hidden, d_out=self.n_classes,
                            impl="dense", param_dtype=self.param_dtype)


def init_mlp(generator: torch.Generator, cfg: MLPConfig,
             device=None) -> Params:
    """``{"mix", "head"}`` drawn from ``generator`` on its own device, then
    moved to ``device`` (``cuda`` unless the caller asks for the CPU), so
    one CPU generator gives the same weights on either device."""
    dev = resolve_device(device)
    at = generator.device
    return Params({"mix": init_linear(cfg.mix, generator, at),
                   "head": init_linear(cfg.head, generator, at)}).to(dev)


def mlp_apply(params, x: torch.Tensor, cfg: MLPConfig) -> torch.Tensor:
    """(B, n_features) -> (B, n_classes) logits."""
    h = torch.relu(linear_apply(params["mix"], x, cfg.mix))
    return linear_apply(params["head"], h, cfg.head)


def mlp_loss(params, batch: dict, cfg: MLPConfig
             ) -> Tuple[torch.Tensor, dict]:
    """Mean cross-entropy of the f32 log-softmax, and argmax accuracy."""
    logits = mlp_apply(params, batch["x"], cfg)
    logp = torch.log_softmax(logits.float(), dim=-1)
    y = batch["y"].long()
    loss = -logp.gather(-1, y[:, None])[:, 0].mean()
    acc = (logits.argmax(-1) == y).float().mean()
    return loss, {"loss": loss, "acc": acc}

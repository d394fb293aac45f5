"""Synthetic compositional teacher of the paper's §9.1 (port of
``repro/data/teacher.py``).

Labels come from a frozen teacher ``argmax(W2 · ReLU(SPM(x)))``: the
data-generating process is itself a structured mixing stage followed by a
nonlinearity, the regime where the paper predicts SPM students beat dense
ones at equal width.  The teacher's SPM takes the kernel path, so on the
card every batch's labels launch K1.

x is drawn with the numpy generator ``DeterministicLoader`` hands over, so
the port's batches cannot equal the reference's ``jax.random`` draws; the
tests feed the reference's x to ``teacher_labels`` instead.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core.pairings import default_n_stages
from repro_torch.core.spm import SPMConfig, init_spm, spm_apply
from repro_torch.device import resolve_device

__all__ = ["TeacherConfig", "make_teacher", "teacher_logits",
           "teacher_labels", "teacher_batch"]


@dataclasses.dataclass(frozen=True)
class TeacherConfig:
    """The teacher's width, classes, SPM depth and seed."""

    width: int
    n_classes: int = 10
    n_stages: Optional[int] = None
    seed: int = 0

    def spm_cfg(self) -> SPMConfig:
        """General 2x2 blocks on the butterfly, random rotations plus 0.3
        noise."""
        L = self.n_stages or default_n_stages(self.width)
        return SPMConfig(n=self.width, n_stages=L, variant="general",
                         schedule="butterfly", init_mode="orthogonal",
                         init_scale=0.3)


def make_teacher(cfg: TeacherConfig, device=None) -> dict:
    """``{"spm", "w2"}`` drawn on the CPU from ``cfg.seed`` (the same
    weights whatever the device), then moved to ``device`` (``cuda``
    unless the caller asks for the CPU)."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(cfg.seed)
    spm = init_spm(cfg.spm_cfg(), gen, torch.device("cpu"))
    w2 = torch.randn(cfg.width, cfg.n_classes, generator=gen) \
        / cfg.width ** 0.5
    return {"spm": spm.to(dev), "w2": w2.to(dev)}


def teacher_logits(teacher: dict, x: torch.Tensor,
                   cfg: TeacherConfig) -> torch.Tensor:
    """``relu(SPM(x)) @ w2``, without gradients, on x's device."""
    with torch.no_grad():
        h = torch.relu(spm_apply(teacher["spm"], x, cfg.spm_cfg()))
        return h @ teacher["w2"]


def teacher_labels(teacher: dict, x: torch.Tensor,
                   cfg: TeacherConfig) -> torch.Tensor:
    """The hard labels ``argmax(relu(SPM(x)) @ w2)`` (int64, torch's index
    type)."""
    return teacher_logits(teacher, x, cfg).argmax(-1)


def teacher_batch(teacher: dict, cfg: TeacherConfig,
                  rng: np.random.Generator, batch: int) -> dict:
    """Draw x ~ N(0, I) with ``rng`` on the host and label it on the
    teacher's device: ``{"x": (batch, width) f32, "y": (batch,)}``."""
    dev = teacher["w2"].device
    x = torch.from_numpy(rng.standard_normal(
        (batch, cfg.width), dtype=np.float32)).to(dev)
    return {"x": x, "y": teacher_labels(teacher, x, cfg)}


"""The paper's own experiment configurations, §9 (port of
``repro/configs/paper.py``).

Table 1 — synthetic compositional teacher, widths {256,512,1024,2048},
steps=1200, batch=256, classes=10.
Table 2 — AG News proxy (hashed sparse features), widths {2048,4096}, L=12.
Tables 3–4 — char-LM, d=4096, T=128, B=32, lr=1e-3, L=12 butterfly.
"""

from __future__ import annotations

from typing import Optional

from repro_torch.models.mlp import MLPConfig

__all__ = ["TEACHER_WIDTHS", "T1_STEPS", "T1_BATCH", "T1_CLASSES",
           "AGNEWS_WIDTHS", "AGNEWS_L", "AGNEWS_CLASSES", "CHARLM_D",
           "CHARLM_T", "CHARLM_B", "CHARLM_LR", "CHARLM_L", "student_cfg"]

TEACHER_WIDTHS = (256, 512, 1024, 2048)
T1_STEPS = 1200
T1_BATCH = 256
T1_CLASSES = 10

AGNEWS_WIDTHS = (2048, 4096)
AGNEWS_L = 12          # paper: ceil((log2 2048 + log2 4096)/2) = 12
AGNEWS_CLASSES = 4

CHARLM_D = 4096
CHARLM_T = 128
CHARLM_B = 32
CHARLM_LR = 1e-3
CHARLM_L = 12          # butterfly-style schedule, paper §9.3


def student_cfg(width: int, n_classes: int, impl: str,
                n_stages: Optional[int] = None) -> MLPConfig:
    """The square student of Tables 1–2: ``impl`` mix, dense head, the
    closed-form SPM backward."""
    return MLPConfig(n_features=width, n_classes=n_classes,
                     linear_impl=impl, spm_stages=n_stages,
                     spm_backward="custom")

"""fp32 policy for the port.

Counterpart of ``mvil_fusion_tpu/utils/precision.py``: the reference pins
full fp32 for its solver paths (``scan_to_map`` runs under
``full_precision``).  On a CUDA card PyTorch may route fp32 matmuls and
convolutions through TF32, which keeps about three decimal digits; the
LOAM distance matrix and Gauss-Newton normal equations need all of fp32.
"""

from __future__ import annotations

import torch


def set_fp32_policy() -> None:
    """Turn TF32 off for matmul and cuDNN and pin matmul precision to
    "highest" (process-wide)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")

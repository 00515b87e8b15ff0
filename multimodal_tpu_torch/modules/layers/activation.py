"""Activations. Counterpart of ``multimodal_tpu/modules/layers/activation.py``."""

from __future__ import annotations

import torch


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """CLIP's SiLU variant: ``x * sigmoid(1.702 * x)`` (close to GELU)."""
    return x * torch.sigmoid(1.702 * x)

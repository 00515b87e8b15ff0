"""Activations. Counterpart of ``multimodal_tpu/modules/layers/activation.py``."""

from __future__ import annotations

from typing import Callable, Union

import torch
from torch.nn import functional as F


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """CLIP's SiLU variant: ``x * sigmoid(1.702 * x)`` (close to GELU)."""
    return x * torch.sigmoid(1.702 * x)


# The library's names: "gelu" is the exact (erf) form, "gelu_tanh" the
# tanh approximation.
ACT2FN = {
    "relu": F.relu,
    "gelu": lambda x: F.gelu(x, approximate="none"),
    "gelu_tanh": lambda x: F.gelu(x, approximate="tanh"),
    "quick_gelu": quick_gelu,
    "silu": F.silu,
    "swish": F.silu,
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
}


def get_activation(name_or_fn: Union[str, Callable]) -> Callable:
    if callable(name_or_fn):
        return name_or_fn
    try:
        return ACT2FN[name_or_fn]
    except KeyError:
        raise ValueError(f"unknown activation {name_or_fn!r}; known: {sorted(ACT2FN)}") from None

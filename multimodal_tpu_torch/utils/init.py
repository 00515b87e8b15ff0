"""Random weights at flax's default scales, for the models whose JAX
counterparts initialise with flax's defaults (MUGEN's VideoCLIP, MDETR)."""

from __future__ import annotations

import torch
from torch import nn


@torch.no_grad()
def init_parameters_(model: nn.Module, generator: torch.Generator) -> None:
    """Draw ``model``'s weights on the CPU from ``generator``: convolution
    and dense kernels normal with std ``fan_in ** -0.5``, embeddings std
    0.02, biases 0; LayerNorms and BatchNorms (any module with
    ``running_var``) scale 1 and bias 0, running statistics 0 and 1."""
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.Conv3d, nn.Linear)):
            m.weight.copy_(torch.randn(m.weight.shape, generator=generator)
                           * m.weight[0].numel() ** -0.5)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.Embedding):
            m.weight.copy_(torch.randn(m.weight.shape, generator=generator) * 0.02)
        elif isinstance(m, nn.LayerNorm) or hasattr(m, "running_var"):
            m.weight.fill_(1.0)
            m.bias.zero_()
            if hasattr(m, "running_var"):
                m.running_mean.zero_()
                m.running_var.fill_(1.0)

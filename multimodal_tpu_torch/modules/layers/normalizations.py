"""Normalization layers. Counterpart of
``multimodal_tpu/modules/layers/normalizations.py``."""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F


class Fp32LayerNorm(nn.LayerNorm):
    """LayerNorm computed in fp32, output cast back to the input dtype.

    Its parameters stay in fp32 whatever the model's compute dtype.
    """

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(
            x.float(), self.normalized_shape,
            None if self.weight is None else self.weight.float(),
            None if self.bias is None else self.bias.float(),
            self.eps,
        )
        return y.to(x.dtype)

"""MLP. Counterpart of ``multimodal_tpu/modules/layers/mlp.py``: a linear
stack with optional per-hidden-layer normalization and dropout.

The single-hidden, no-normalization case (every transformer block's
feed-forward) goes through the fused MLP kernel (``ops/fused_encoder.py:
fused_mlp``, kernel #3) whenever dropout is inactive, the activation has a
kernel counterpart (``FUSED_ACT_FOR``) and the widths suit the kernel;
otherwise through ``F.linear``. Parameter names (``hidden_0`` ... and
``out``) follow the JAX module's. Weights are held in their parameter dtype
and cast at use to the compute dtype, the dtype of ``x``.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Union

import torch
from torch import nn
from torch.nn import functional as F

from multimodal_tpu_torch.modules.layers.activation import get_activation
from multimodal_tpu_torch.ops.fused_encoder import FUSED_ACT_FOR, fused_mlp, fused_mlp_available


class MLP(nn.Module):
    """in_dim -> hidden_dims* -> out_dim with activation, dropout and an
    optional normalization (``normalization(width)`` builds it) per hidden
    layer."""

    def __init__(
        self,
        in_dim: int,
        out_dim: int,
        hidden_dims: Optional[Union[int, Sequence[int]]] = None,
        dropout: float = 0.5,
        activation: Union[str, Callable] = "relu",
        normalization: Optional[Callable[[int], nn.Module]] = None,
    ):
        super().__init__()
        if hidden_dims is None:
            hidden_dims = []
        if isinstance(hidden_dims, int):
            hidden_dims = [hidden_dims]
        self.in_dim = in_dim
        self.hidden_dims = list(hidden_dims)
        self.dropout = dropout
        self.activation = activation
        self.has_norm = normalization is not None
        width = in_dim
        for i, h in enumerate(self.hidden_dims):
            self.add_module(f"hidden_{i}", nn.Linear(width, h))
            if normalization is not None:
                self.add_module(f"norm_{i}", normalization(h))
            width = h
        self.out = nn.Linear(width, out_dim)

    def forward(self, x: torch.Tensor, deterministic: bool = True) -> torch.Tensor:
        dt = x.dtype
        act = get_activation(self.activation)
        drop_on = self.dropout > 0 and not deterministic
        if len(self.hidden_dims) == 1 and not self.has_norm and x.shape[-1] == self.in_dim:
            w1, b1 = self.hidden_0.weight.to(dt), self.hidden_0.bias.to(dt)
            w2, b2 = self.out.weight.to(dt), self.out.bias.to(dt)
            fused_act = (FUSED_ACT_FOR.get(self.activation)
                         if isinstance(self.activation, str) else None)
            if (fused_act is not None and not drop_on
                    and fused_mlp_available(self.in_dim, self.hidden_dims[0], w2.shape[0])):
                # .t(): the column-major (in, out) views the kernel reads
                return fused_mlp(x.contiguous(), w1.t(), b1, w2.t(), b2, fused_act)
            y = F.dropout(act(F.linear(x, w1, b1)), self.dropout, training=drop_on)
            return F.linear(y, w2, b2)
        for i in range(len(self.hidden_dims)):
            lin = getattr(self, f"hidden_{i}")
            x = F.linear(x.to(dt), lin.weight.to(dt), lin.bias.to(dt))
            if self.has_norm:
                x = getattr(self, f"norm_{i}")(x)
            x = F.dropout(act(x), self.dropout, training=drop_on)
        return F.linear(x.to(dt), self.out.weight.to(dt), self.out.bias.to(dt))

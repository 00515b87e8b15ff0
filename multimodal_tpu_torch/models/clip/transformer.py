"""CLIP's pre-norm transformer stack.

Counterpart of ``multimodal_tpu/models/clip/transformer.py``. Parameter
names follow the ``nn.TransformerEncoderLayer`` that TorchMultimodal's CLIP
encoders instantiate (``self_attn.in_proj_weight``, ``self_attn.out_proj``,
``linear1``, ``linear2``, ``norm1``, ``norm2``), so a TorchMultimodal state
dict loads as it is. Attention and the MLP go through the fused kernels of
``ops/fused_encoder.py``; ``nn.MultiheadAttention``'s forward is never used.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from multimodal_tpu_torch.modules.layers.normalizations import Fp32LayerNorm
from multimodal_tpu_torch.ops.fused_encoder import (
    fused_attention_supported,
    fused_mlp,
    fused_qkv_attention,
)


class SelfAttentionProjections(nn.Module):
    """The input and output projections of ``nn.MultiheadAttention``, under
    its parameter names, without its forward."""

    def __init__(self, width: int):
        super().__init__()
        self.in_proj_weight = nn.Parameter(torch.empty(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * width))
        self.out_proj = nn.Linear(width, width)


class CLIPEncoderLayer(nn.Module):
    """Pre-norm encoder layer: fp32 LayerNorms (eps 1e-5), fused QKV
    attention, quick-GELU MLP. The residual stream stays in the compute
    dtype, the dtype of ``x``; every weight but the LayerNorms' is cast to
    it at use, a no-op when the weights are held in it already.

    On CUDA tensors attention and MLP always run the hand-written kernels;
    on CPU tensors, their plain PyTorch versions.
    """

    def __init__(self, width: int, heads: int, dim_feedforward: int):
        super().__init__()
        self.heads = heads
        self.self_attn = SelfAttentionProjections(width)
        self.linear1 = nn.Linear(width, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, width)
        self.norm1 = Fp32LayerNorm(width, eps=1e-5)
        self.norm2 = Fp32LayerNorm(width, eps=1e-5)

    def forward(self, x: torch.Tensor, is_causal: bool = False) -> torch.Tensor:
        b, s, e = x.shape
        if x.is_cuda and not fused_attention_supported(s, e, self.heads):
            raise NotImplementedError(
                f"no attention kernel for seq={s}, width={e}, heads={self.heads}: "
                "longer sequences need the flash-attention kernels, still to be "
                "ported (ROADMAP.md, queue B, flash attention)"
            )
        dt = x.dtype
        attn, out_proj = self.self_attn, self.self_attn.out_proj
        qkv = F.linear(self.norm1(x), attn.in_proj_weight.to(dt), attn.in_proj_bias.to(dt))
        x = x + F.linear(fused_qkv_attention(qkv, self.heads, is_causal),
                         out_proj.weight.to(dt), out_proj.bias.to(dt))
        y = self.norm2(x)
        # .to(dt).t(): the column-major (in, out) view the MLP kernels read
        return x + fused_mlp(
            y, self.linear1.weight.to(dt).t(), self.linear1.bias.to(dt),
            self.linear2.weight.to(dt).t(), self.linear2.bias.to(dt), "quick_gelu",
        )


class CLIPTransformer(nn.Module):
    def __init__(self, width: int, heads: int, layers: int,
                 dim_feedforward: Optional[int] = None):
        super().__init__()
        ff = dim_feedforward or 4 * width
        self.layers = nn.ModuleList(
            CLIPEncoderLayer(width, heads, ff) for _ in range(layers)
        )

    def forward(self, x: torch.Tensor, is_causal: bool = False) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x, is_causal=is_causal)
        return x

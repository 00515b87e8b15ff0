"""CLIP's pre-norm transformer stack.

Counterpart of ``multimodal_tpu/models/clip/transformer.py``. Parameter
names follow the ``nn.TransformerEncoderLayer`` that TorchMultimodal's CLIP
encoders instantiate (``self_attn.in_proj_weight``, ``self_attn.out_proj``,
``linear1``, ``linear2``, ``norm1``, ``norm2``), so a TorchMultimodal state
dict loads as it is. Where the fused encoder kernels take the shape,
attention and the MLP go through them (``ops/fused_encoder.py``); otherwise
attention goes through ``ops/attention.py`` (the flash kernel from its
threshold up, plain math below) and the MLP through ``F.linear``, the JAX
layer's own dispatch. ``nn.MultiheadAttention``'s forward is never used.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from multimodal_tpu_torch.modules.layers.activation import quick_gelu
from multimodal_tpu_torch.modules.layers.normalizations import Fp32LayerNorm
from multimodal_tpu_torch.ops.attention import scaled_dot_product_attention
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

    When ``fused_attention_supported`` holds for the shape (S <= 256, a
    clean head split), attention and the MLP run the fused encoder kernels
    on CUDA tensors and their plain versions on CPU tensors; otherwise, as
    the JAX layer does when its ``fused`` flag is False, attention runs on
    split heads through ``scaled_dot_product_attention`` and the MLP through
    ``F.linear``. This is a dispatch by shape, not a fallback on failure.
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
        h = self.heads
        fused = fused_attention_supported(s, e, h)
        dt = x.dtype
        attn, out_proj = self.self_attn, self.self_attn.out_proj
        qkv = F.linear(self.norm1(x), attn.in_proj_weight.to(dt), attn.in_proj_bias.to(dt))
        if fused:
            a = fused_qkv_attention(qkv, h, is_causal)
        else:
            q, k, v = (t.reshape(b, s, h, e // h).transpose(1, 2) for t in qkv.split(e, dim=-1))
            a = scaled_dot_product_attention(q, k, v, is_causal=is_causal)
            a = a.transpose(1, 2).reshape(b, s, e)
        x = x + F.linear(a, out_proj.weight.to(dt), out_proj.bias.to(dt))
        y = self.norm2(x)
        w1, b1 = self.linear1.weight.to(dt), self.linear1.bias.to(dt)
        w2, b2 = self.linear2.weight.to(dt), self.linear2.bias.to(dt)
        if fused:
            # .t(): the column-major (in, out) views the MLP kernels read
            return x + fused_mlp(y, w1.t(), b1, w2.t(), b2, "quick_gelu")
        return x + F.linear(quick_gelu(F.linear(y, w1, b1)), w2, b2)


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

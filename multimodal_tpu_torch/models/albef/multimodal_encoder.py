"""ALBEF multimodal encoder: text states attending to the image. Counterpart
of ``multimodal_tpu/models/albef/multimodal_encoder.py``
(``TransformerCrossAttentionLayer``, ``ALBEFMultimodalEncoder``).

Self-attention and cross-attention go through ``MultiHeadAttentionWithCache``
and so ``ops/attention.py``'s dispatch: with ALBEF's 30 text queries, below
``FLASH_MIN_SEQ``, both take the plain path, as the JAX package takes XLA's.
The MLP is the fused MLP kernel's (#3).
"""

from __future__ import annotations

from typing import Callable, Optional, Union

import torch
from torch import nn
from torch.nn import functional as F

from multimodal_tpu_torch.modules.layers.mlp import MLP
from multimodal_tpu_torch.modules.layers.multi_head_attention import MultiHeadAttentionWithCache
from multimodal_tpu_torch.modules.layers.normalizations import Fp32LayerNorm


class TransformerCrossAttentionLayer(nn.Module):
    """Self-attention + cross-attention + MLP, pre- or post-norm."""

    def __init__(self, d_model: int, n_head: int, dim_feedforward: int, dropout: float = 0.0,
                 activation: Union[str, Callable] = "relu", layer_norm_eps: float = 1e-12,
                 norm_first: bool = False):
        super().__init__()
        self.norm_first = norm_first
        self.dropout = dropout
        self.attention = MultiHeadAttentionWithCache(d_model, d_model, n_head, dropout=dropout)
        self.cross_attention = MultiHeadAttentionWithCache(d_model, d_model, n_head,
                                                           dropout=dropout)
        self.feedforward = MLP(d_model, d_model, dim_feedforward, dropout=dropout,
                               activation=activation)
        self.attention_layernorm = Fp32LayerNorm(d_model, eps=layer_norm_eps)
        self.cross_attention_layernorm = Fp32LayerNorm(d_model, eps=layer_norm_eps)
        self.feedforward_layernorm = Fp32LayerNorm(d_model, eps=layer_norm_eps)

    def forward(self, hidden_states: torch.Tensor, encoder_hidden_states: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None,
                cross_attention_mask: Optional[torch.Tensor] = None,
                deterministic: bool = True) -> torch.Tensor:
        def drop(t):
            return F.dropout(t, self.dropout, training=not deterministic and self.dropout > 0)

        def attn(q):
            return self.attention(q, q, q, attn_mask=attention_mask, deterministic=deterministic)

        def cross(q):
            return self.cross_attention(q, encoder_hidden_states, encoder_hidden_states,
                                        attn_mask=cross_attention_mask,
                                        deterministic=deterministic)

        x = hidden_states
        if self.norm_first:
            x = x + drop(attn(self.attention_layernorm(x)))
            x = x + drop(cross(self.cross_attention_layernorm(x)))
            return x + drop(self.feedforward(self.feedforward_layernorm(x), deterministic))
        x = self.attention_layernorm(x + drop(attn(x)))
        x = self.cross_attention_layernorm(x + drop(cross(x)))
        return self.feedforward_layernorm(x + drop(self.feedforward(x, deterministic)))


class ALBEFMultimodalEncoder(nn.Module):
    """A stack of cross-attention layers (post-norm, exact GELU): text
    hidden states attend to the image's."""

    def __init__(self, hidden_size: int = 768, num_hidden_layers: int = 6,
                 num_attention_heads: int = 12, intermediate_size: int = 3072,
                 layer_norm_eps: float = 1e-12,
                 transform_act_fn: Union[str, Callable] = "gelu"):
        super().__init__()
        self.layers = nn.ModuleList(
            TransformerCrossAttentionLayer(hidden_size, num_attention_heads, intermediate_size,
                                           activation=transform_act_fn,
                                           layer_norm_eps=layer_norm_eps)
            for _ in range(num_hidden_layers))

    def forward(self, hidden_states: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None,
                encoder_hidden_states: Optional[torch.Tensor] = None,
                deterministic: bool = True) -> torch.Tensor:
        """``attention_mask``: the text's ``(b, s)`` padding mask (nonzero =
        attend)."""
        if attention_mask is not None:
            attention_mask = attention_mask.bool()[:, None, None, :]
        for layer in self.layers:
            hidden_states = layer(hidden_states, encoder_hidden_states,
                                  attention_mask=attention_mask, deterministic=deterministic)
        return hidden_states

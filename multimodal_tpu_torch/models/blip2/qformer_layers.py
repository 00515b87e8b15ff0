"""Q-Former layers. Counterpart of
``multimodal_tpu/models/blip2/qformer_layers.py`` (``QformerLayer``,
``QformerEncoder``, ``QformerEmbedding``): post-norm residuals, and separate
feed-forward stacks for the query slice (which alone cross-attends the
image) and the text slice, concatenated again after each layer.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple, Union

import torch
from torch import nn
from torch.nn import functional as F

from multimodal_tpu_torch.modules.layers.mlp import MLP
from multimodal_tpu_torch.modules.layers.multi_head_attention import MultiHeadAttentionWithCache
from multimodal_tpu_torch.modules.layers.normalizations import Fp32LayerNorm


class QformerLayer(nn.Module):
    def __init__(
        self,
        dim_q: int,
        dim_feedforward: int,
        num_heads: int,
        attn_dropout: float = 0.0,
        dropout: float = 0.0,
        layer_norm_eps: float = 1e-12,
        activation: Union[str, Callable] = "relu",
        has_cross_attention: bool = False,
        dim_kv: Optional[int] = None,
    ):
        super().__init__()
        self.dropout = dropout
        self.has_cross_attention = has_cross_attention
        self.self_attention = MultiHeadAttentionWithCache(dim_q, dim_q, num_heads, attn_dropout)
        self.self_attn_layernorm = Fp32LayerNorm(dim_q, eps=layer_norm_eps)
        if has_cross_attention:
            if dim_kv is None:
                raise ValueError("key and value dim should be provided for cross attention.")
            self.cross_attention = MultiHeadAttentionWithCache(dim_q, dim_kv, num_heads,
                                                               attn_dropout)
            self.cross_attn_layernorm = Fp32LayerNorm(dim_q, eps=layer_norm_eps)
        self.feedforward = MLP(dim_q, dim_q, dim_feedforward, dropout=0.0, activation=activation)
        self.feedforward_layernorm = Fp32LayerNorm(dim_q, eps=layer_norm_eps)
        self.feedforward_query = MLP(dim_q, dim_q, dim_feedforward, dropout=0.0,
                                     activation=activation)
        self.feedforward_layernorm_query = Fp32LayerNorm(dim_q, eps=layer_norm_eps)

    def forward(
        self,
        hidden_states: torch.Tensor,
        encoder_hidden_states: Optional[torch.Tensor] = None,
        attention_mask: Optional[torch.Tensor] = None,
        past_key_value: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
        query_length: int = 0,
        use_cache: bool = False,
        deterministic: bool = True,
    ) -> Tuple[torch.Tensor, Optional[Tuple[torch.Tensor, torch.Tensor]]]:
        def drop(t):
            return F.dropout(t, self.dropout, training=not deterministic and self.dropout > 0)

        x = hidden_states
        attn = self.self_attention(x, x, x, attn_mask=attention_mask,
                                   past_key_value=past_key_value, use_cache=use_cache,
                                   deterministic=deterministic)
        present_kv = None
        if use_cache:
            attn, present_kv = attn.attn_output, attn.past_key_value
        attn_residual = self.self_attn_layernorm(drop(attn) + x)

        if query_length > 0:
            query_out = attn_residual[:, :query_length]
            if self.has_cross_attention:
                if encoder_hidden_states is None:
                    raise ValueError(
                        "encoder_hidden_states must be given for cross-attention layers")
                ca = self.cross_attention(query_out, encoder_hidden_states,
                                          encoder_hidden_states, deterministic=deterministic)
                query_out = self.cross_attn_layernorm(drop(ca) + query_out)
            layer_out = self.feedforward_layernorm_query(
                drop(self.feedforward_query(query_out, deterministic)) + query_out)
            if attn_residual.shape[1] > query_length:
                text = attn_residual[:, query_length:]
                text_out = self.feedforward_layernorm(
                    drop(self.feedforward(text, deterministic)) + text)
                layer_out = torch.cat([layer_out, text_out], dim=1)
        else:
            layer_out = self.feedforward_layernorm(
                drop(self.feedforward(attn_residual, deterministic)) + attn_residual)
        return layer_out, present_kv


class QformerEncoder(nn.Module):
    """``num_hidden_layers`` Q-Former layers, cross-attention in every
    ``cross_attention_freq``-th from the first."""

    def __init__(
        self,
        num_hidden_layers: int,
        dim_q: int,
        dim_feedforward: int,
        num_heads: int,
        attn_dropout: float = 0.0,
        dropout: float = 0.0,
        layer_norm_eps: float = 1e-12,
        activation: Union[str, Callable] = "relu",
        cross_attention_freq: int = 2,
        dim_kv: Optional[int] = None,
    ):
        super().__init__()
        self.layers = nn.ModuleList(
            QformerLayer(dim_q, dim_feedforward, num_heads, attn_dropout, dropout,
                         layer_norm_eps, activation, i % cross_attention_freq == 0, dim_kv)
            for i in range(num_hidden_layers))

    def forward(
        self,
        hidden_states: torch.Tensor,
        encoder_hidden_states: Optional[torch.Tensor] = None,
        attention_mask: Optional[torch.Tensor] = None,
        past_key_values: Optional[List] = None,
        query_length: int = 0,
        use_cache: bool = False,
        deterministic: bool = True,
    ) -> Tuple[torch.Tensor, List]:
        current_key_values = []
        for i, layer in enumerate(self.layers):
            pkv = past_key_values[i] if past_key_values is not None else None
            hidden_states, present = layer(hidden_states, encoder_hidden_states, attention_mask,
                                           pkv, query_length, use_cache, deterministic)
            if use_cache:
                current_key_values.append(present)
        return hidden_states, current_key_values


class QformerEmbedding(nn.Module):
    """Word and position embeddings of the text (positions from
    ``past_seq_length`` unless given), after the query embeddings when both
    come, then an fp32 LayerNorm and dropout. ``dtype`` is the compute
    dtype (None: the weights')."""

    def __init__(
        self,
        embedding_dim: int,
        max_position_embeddings: int,
        vocab_size: int,
        pad_token_id: int = 0,
        layer_norm_eps: float = 1e-12,
        dropout: float = 0.0,
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        self.dropout = dropout
        self.dtype = dtype
        self.token_embeddings = nn.Embedding(vocab_size, embedding_dim)
        self.position_embeddings = nn.Embedding(max_position_embeddings, embedding_dim)
        self.layernorm = Fp32LayerNorm(embedding_dim, eps=layer_norm_eps)

    def forward(
        self,
        input_ids: Optional[torch.Tensor] = None,
        position_ids: Optional[torch.Tensor] = None,
        query_embeddings: Optional[torch.Tensor] = None,
        past_seq_length: int = 0,
        deterministic: bool = True,
    ) -> torch.Tensor:
        if input_ids is None and query_embeddings is None:
            raise ValueError("Either input_ids or query_embeddings must be passed.")
        embeddings = query_embeddings
        if input_ids is not None:
            dt = self.dtype or self.token_embeddings.weight.dtype
            if position_ids is None:
                position_ids = torch.arange(past_seq_length, past_seq_length + input_ids.shape[1],
                                            device=input_ids.device)[None]
            embeddings = (self.token_embeddings.weight.to(dt)[input_ids]
                          + self.position_embeddings.weight.to(dt)[position_ids])
            if query_embeddings is not None:
                embeddings = torch.cat([query_embeddings.to(dt), embeddings], dim=1)
        embeddings = self.layernorm(embeddings)
        return F.dropout(embeddings, self.dropout,
                         training=not deterministic and self.dropout > 0)

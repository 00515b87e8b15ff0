"""Q-Former model and its causal-LM wrapper. Counterpart of
``multimodal_tpu/models/blip2/qformer_model.py`` (``QformerModel``,
``QformerPredictionHead``, ``QformerForCLM``).

The padding and causal masks become the JAX module's additive fp32 bias,
``(1 - mask) * -10000``, so from ``FLASH_MIN_SEQ`` queries and keys up the
masked self-attention takes the flash kernel's bias route.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple, Union

import torch
from torch import nn

from multimodal_tpu_torch.models.blip2.qformer_layers import QformerEmbedding, QformerEncoder
from multimodal_tpu_torch.models.blip2.qformer_utils import get_causal_mask
from multimodal_tpu_torch.modules.layers.activation import get_activation
from multimodal_tpu_torch.modules.layers.multi_head_attention import dense
from multimodal_tpu_torch.modules.layers.normalizations import Fp32LayerNorm


class QformerModel(nn.Module):
    """Embeddings and the encoder. With ``past_key_values`` (the query
    tokens' cached keys and values, ``query_length`` rows) the text
    positions start after the cache's text part; ``use_cache`` returns each
    layer's keys and values. Returns ``(hidden, current_key_values)``."""

    def __init__(
        self,
        num_hidden_layers: int,
        dim_q: int,
        dim_feedforward: int,
        num_heads: int,
        max_position_embeddings: int,
        vocab_size: int,
        pad_token_id: int = 0,
        query_length: int = 32,
        dim_kv: Optional[int] = None,
        layer_norm_eps: float = 1e-12,
        activation: Union[str, Callable] = "relu",
        attn_dropout: float = 0.0,
        dropout: float = 0.0,
        cross_attention_freq: int = 2,
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        self.query_length = query_length
        self.embeddings = QformerEmbedding(dim_q, max_position_embeddings, vocab_size,
                                           pad_token_id, layer_norm_eps, dropout, dtype)
        self.encoder = QformerEncoder(num_hidden_layers, dim_q, dim_feedforward, num_heads,
                                      attn_dropout, dropout, layer_norm_eps, activation,
                                      cross_attention_freq, dim_kv)

    def forward(
        self,
        input_ids: Optional[torch.Tensor] = None,
        attention_mask: Optional[torch.Tensor] = None,
        position_ids: Optional[torch.Tensor] = None,
        query_embeds: Optional[torch.Tensor] = None,
        encoder_hidden_states: Optional[torch.Tensor] = None,
        past_key_values: Optional[List] = None,
        use_cache: bool = False,
        use_causal_mask: bool = False,
        deterministic: bool = True,
    ) -> Tuple[torch.Tensor, List]:
        past_seq_length = (past_key_values[0][0].shape[2] - self.query_length
                           if past_key_values is not None else 0)
        query_length = query_embeds.shape[1] if query_embeds is not None else 0
        embedding_output = self.embeddings(input_ids, position_ids, query_embeds,
                                           past_seq_length, deterministic)
        bsz, seq_len = embedding_output.shape[:2]
        mask_bias = None
        if attention_mask is not None:
            attention_mask = attention_mask.float()
            if use_causal_mask:
                causal = get_causal_mask(attention_mask, (bsz, seq_len),
                                         has_query=query_embeds is not None)
                extended = causal[:, None] * attention_mask[:, None, None, :]
            else:
                extended = attention_mask[:, None, None, :]
            mask_bias = (1.0 - extended) * -10000.0
        return self.encoder(embedding_output, encoder_hidden_states, mask_bias, past_key_values,
                            query_length, use_cache, deterministic)


class QformerPredictionHead(nn.Module):
    """Dense, activation, fp32 LayerNorm, vocabulary projection."""

    def __init__(self, dim_q: int, vocab_size: int, layer_norm_eps: float = 1e-12,
                 activation: Union[str, Callable] = "gelu"):
        super().__init__()
        self.activation = activation
        self.linear_1 = nn.Linear(dim_q, dim_q)
        self.layernorm = Fp32LayerNorm(dim_q, eps=layer_norm_eps)
        self.linear_2 = nn.Linear(dim_q, vocab_size)

    def forward(self, sequence_output: torch.Tensor) -> torch.Tensor:
        dt = sequence_output.dtype
        h = get_activation(self.activation)(dense(self.linear_1, sequence_output, dt))
        return dense(self.linear_2, self.layernorm(h), dt)


class QformerForCLM(nn.Module):
    """The Q-Former for causal language modelling: ``QformerModel`` under
    the causal mask and the prediction head over the text positions."""

    def __init__(
        self,
        num_hidden_layers: int,
        dim_q: int,
        dim_feedforward: int,
        num_heads: int,
        max_position_embeddings: int,
        vocab_size: int,
        pad_token_id: int = 0,
        query_length: int = 32,
        dim_kv: Optional[int] = None,
        layer_norm_eps: float = 1e-12,
        activation: Union[str, Callable] = "gelu",
        attn_dropout: float = 0.0,
        dropout: float = 0.0,
        cross_attention_freq: int = 2,
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        self.num_hidden_layers = num_hidden_layers
        self.dim_q = dim_q
        self.num_heads = num_heads
        self.vocab_size = vocab_size
        self.max_position_embeddings = max_position_embeddings
        self.head = QformerPredictionHead(dim_q, vocab_size, layer_norm_eps, activation)
        self.model = QformerModel(num_hidden_layers, dim_q, dim_feedforward, num_heads,
                                  max_position_embeddings, vocab_size, pad_token_id,
                                  query_length, dim_kv, layer_norm_eps, activation,
                                  attn_dropout, dropout, cross_attention_freq, dtype)

    def forward(
        self,
        input_ids: Optional[torch.Tensor] = None,
        attention_mask: Optional[torch.Tensor] = None,
        position_ids: Optional[torch.Tensor] = None,
        query_embeds: Optional[torch.Tensor] = None,
        encoder_hidden_states: Optional[torch.Tensor] = None,
        past_key_values: Optional[List] = None,
        use_cache: bool = False,
        deterministic: bool = True,
    ) -> torch.Tensor:
        if past_key_values is not None and query_embeds is not None:
            raise ValueError("cannot pass both past_key_values and query_embeds")
        sequence_output, _ = self.model(input_ids, attention_mask, position_ids, query_embeds,
                                        encoder_hidden_states, past_key_values, use_cache,
                                        use_causal_mask=True, deterministic=deterministic)
        if query_embeds is not None:
            sequence_output = sequence_output[:, query_embeds.shape[1]:]
        return self.head(sequence_output)

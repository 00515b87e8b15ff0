"""BERT-style composable text encoder. Counterpart of
``multimodal_tpu/modules/encoders/bert_text_encoder.py``: embeddings, the
encoder stack, an optional final LayerNorm and pooler. A padding mask
(from ``attention_mask``, else from the pad token) reaches every layer as a
boolean ``(b, 1, 1, s)`` key mask (True = attend)."""

from __future__ import annotations

from typing import Callable, Optional, Union

import torch
from torch import nn

from multimodal_tpu_torch.modules.layers.text_embedding import BERTTextEmbeddings
from multimodal_tpu_torch.modules.layers.transformer import TransformerEncoder, TransformerOutput


class BERTTextEncoder(nn.Module):
    def __init__(self, embeddings: nn.Module, encoder: nn.Module,
                 layernorm: Optional[nn.Module] = None, pooler: Optional[nn.Module] = None):
        super().__init__()
        self.embeddings = embeddings
        self.encoder = encoder
        self.layernorm = layernorm
        self.pooler = pooler

    def forward(
        self,
        input_ids: Optional[torch.Tensor] = None,
        attention_mask: Optional[torch.Tensor] = None,
        token_type_ids: Optional[torch.Tensor] = None,
        position_ids: Optional[torch.Tensor] = None,
        inputs_embeds: Optional[torch.Tensor] = None,
        return_hidden_states: bool = False,
        return_attn_weights: bool = False,
        deterministic: bool = True,
    ) -> TransformerOutput:
        if input_ids is None and inputs_embeds is None:
            raise ValueError("input_ids or inputs_embeds must not be None")
        if attention_mask is None and input_ids is not None:
            pad_id = getattr(self.embeddings, "pad_token_id", None)
            if pad_id is not None:
                attention_mask = input_ids != pad_id
        if attention_mask is not None:
            attention_mask = attention_mask.bool()[:, None, None, :]
        embedding_output = self.embeddings(
            input_ids=input_ids, position_ids=position_ids, token_type_ids=token_type_ids,
            inputs_embeds=inputs_embeds, deterministic=deterministic)
        encoder_output = self.encoder(
            embedding_output, attention_mask=attention_mask,
            return_hidden_states=return_hidden_states,
            return_attn_weights=return_attn_weights, deterministic=deterministic)
        last_hidden_state = encoder_output.last_hidden_state
        pooled = encoder_output.pooler_output
        if self.layernorm is not None:
            last_hidden_state = self.layernorm(last_hidden_state)
        if self.pooler is not None:
            pooled = self.pooler(last_hidden_state)
        return TransformerOutput(
            last_hidden_state=last_hidden_state,
            pooler_output=pooled,
            hidden_states=encoder_output.hidden_states,
            attentions=encoder_output.attentions,
        )


def bert_text_encoder(
    hidden_size: int = 768,
    num_hidden_layers: int = 6,
    num_attention_heads: int = 12,
    intermediate_size: int = 3072,
    dropout: float = 0.1,
    transform_act_fn: Union[str, Callable] = "gelu",
    layer_norm_eps: float = 1e-12,
    norm_first: bool = False,
    vocab_size: int = 30522,
    max_position_embeddings: int = 512,
    type_vocab_size: int = 2,
    pad_token_id: int = 0,
    offset_pos_ids: bool = False,
    layernorm: Optional[nn.Module] = None,
    pooler: Optional[nn.Module] = None,
    dtype: Optional[torch.dtype] = None,
) -> BERTTextEncoder:
    """Defaults match HuggingFace bert-base-uncased; ``dtype`` is the
    compute dtype."""
    embeddings = BERTTextEmbeddings(
        hidden_size=hidden_size, vocab_size=vocab_size, pad_token_id=pad_token_id,
        max_position_embeddings=max_position_embeddings, type_vocab_size=type_vocab_size,
        layer_norm_eps=layer_norm_eps, dropout=dropout, offset_pos_ids=offset_pos_ids,
        dtype=dtype)
    encoder = TransformerEncoder(
        n_layer=num_hidden_layers, d_model=hidden_size, n_head=num_attention_heads,
        dim_feedforward=intermediate_size, dropout=dropout, activation=transform_act_fn,
        layer_norm_eps=layer_norm_eps, norm_first=norm_first)
    return BERTTextEncoder(embeddings=embeddings, encoder=encoder, layernorm=layernorm,
                           pooler=pooler)

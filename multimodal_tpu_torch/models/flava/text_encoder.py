"""FLAVA text encoder builder. Counterpart of
``multimodal_tpu/models/flava/text_encoder.py``: BERT embeddings, the
pre-norm encoder, a final fp32 LayerNorm and the CLS pooler."""

from __future__ import annotations

from typing import Callable, Optional, Union

import torch

from multimodal_tpu_torch.modules.encoders.bert_text_encoder import BERTTextEncoder
from multimodal_tpu_torch.modules.layers.normalizations import Fp32LayerNorm
from multimodal_tpu_torch.modules.layers.text_embedding import BERTTextEmbeddings
from multimodal_tpu_torch.modules.layers.transformer import TransformerEncoder
from multimodal_tpu_torch.modules.losses.flava import Pooler


def flava_text_encoder(
    num_hidden_layers: int = 12,
    hidden_size: int = 768,
    num_attention_heads: int = 12,
    intermediate_size: int = 3072,
    intermediate_activation: Union[str, Callable] = "gelu",
    layer_norm_eps: float = 1e-12,
    dropout: float = 0.0,
    vocab_size: int = 30522,
    pad_token_id: int = 0,
    type_vocab_size: int = 2,
    max_position_embeddings: int = 512,
    dtype: Optional[torch.dtype] = None,
    remat: bool = False,
    moe_num_experts: Optional[int] = None,
) -> BERTTextEncoder:
    embeddings = BERTTextEmbeddings(
        hidden_size=hidden_size, vocab_size=vocab_size, pad_token_id=pad_token_id,
        type_vocab_size=type_vocab_size, max_position_embeddings=max_position_embeddings,
        layer_norm_eps=layer_norm_eps, dropout=dropout, dtype=dtype)
    encoder = TransformerEncoder(
        n_layer=num_hidden_layers, d_model=hidden_size, n_head=num_attention_heads,
        dim_feedforward=intermediate_size, activation=intermediate_activation,
        layer_norm_eps=layer_norm_eps, dropout=dropout, norm_first=True, remat=remat,
        moe_num_experts=moe_num_experts)
    return BERTTextEncoder(embeddings=embeddings, encoder=encoder,
                           layernorm=Fp32LayerNorm(hidden_size, eps=layer_norm_eps),
                           pooler=Pooler(hidden_size))

"""MDETR text encoder (RoBERTa-base config) and feature resizer.
Counterpart of ``multimodal_tpu/models/mdetr/text_encoder.py``: the port's
BERT encoder with padding-aware position ids, vocab 50265, pad id 1, one
token type and LayerNorm eps 1e-5."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from multimodal_tpu_torch.modules.encoders.bert_text_encoder import (
    BERTTextEncoder,
    bert_text_encoder,
)
from multimodal_tpu_torch.modules.layers.normalizations import Fp32LayerNorm


class FeatureResizer(nn.Module):
    """Linear + LayerNorm (eps 1e-12, fp32) + dropout; weights cast at use
    to the input's dtype."""

    def __init__(self, input_feat_size: int, output_feat_size: int, dropout: float = 0.1,
                 do_ln: bool = True):
        super().__init__()
        self.dropout = dropout
        self.fc = nn.Linear(input_feat_size, output_feat_size)
        self.layer_norm = Fp32LayerNorm(output_feat_size, eps=1e-12) if do_ln else None

    def forward(self, encoder_features: torch.Tensor, deterministic: bool = True) -> torch.Tensor:
        dt = encoder_features.dtype
        x = F.linear(encoder_features, self.fc.weight.to(dt), self.fc.bias.to(dt))
        if self.layer_norm is not None:
            x = self.layer_norm(x)
        return F.dropout(x, self.dropout, training=not deterministic and self.dropout > 0)


def mdetr_roberta_text_encoder(
    hidden_size: int = 768,
    num_hidden_layers: int = 12,
    num_attention_heads: int = 12,
    intermediate_size: int = 3072,
    vocab_size: int = 50265,
    max_position_embeddings: int = 514,
    pad_token_id: int = 1,
    type_vocab_size: int = 1,
    dtype: Optional[torch.dtype] = None,
) -> BERTTextEncoder:
    """roberta-base-config text encoder; ``dtype`` is the compute dtype."""
    return bert_text_encoder(
        hidden_size=hidden_size,
        num_hidden_layers=num_hidden_layers,
        num_attention_heads=num_attention_heads,
        intermediate_size=intermediate_size,
        vocab_size=vocab_size,
        max_position_embeddings=max_position_embeddings,
        pad_token_id=pad_token_id,
        type_vocab_size=type_vocab_size,
        offset_pos_ids=True,
        layer_norm_eps=1e-5,
        dropout=0.1,
        dtype=dtype,
    )

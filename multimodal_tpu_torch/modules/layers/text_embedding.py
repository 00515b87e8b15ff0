"""BERT-style text embeddings. Counterpart of
``multimodal_tpu/modules/layers/text_embedding.py``: word, absolute
position and token-type embeddings summed in the compute dtype, an fp32
LayerNorm and dropout, with RoBERTa-style padding-aware position ids as an
option."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from multimodal_tpu_torch.modules.layers.normalizations import Fp32LayerNorm


class BERTTextEmbeddings(nn.Module):
    """``dtype`` is the compute dtype (None: the weights' dtype); each
    embedding table is cast to it at use."""

    def __init__(
        self,
        hidden_size: int = 768,
        vocab_size: int = 30522,
        pad_token_id: int = 0,
        max_position_embeddings: int = 512,
        type_vocab_size: int = 2,
        layer_norm_eps: float = 1e-12,
        dropout: float = 0.0,
        offset_pos_ids: bool = False,
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        self.pad_token_id = pad_token_id
        self.dropout = dropout
        self.offset_pos_ids = offset_pos_ids
        self.dtype = dtype
        self.word_embeddings = nn.Embedding(vocab_size, hidden_size)
        self.position_embeddings = nn.Embedding(max_position_embeddings, hidden_size)
        self.token_type_embeddings = nn.Embedding(type_vocab_size, hidden_size)
        self.layer_norm = Fp32LayerNorm(hidden_size, eps=layer_norm_eps)

    def create_position_ids_from_input_ids(self, input_ids: torch.Tensor) -> torch.Tensor:
        """RoBERTa positions: count non-pad tokens, offset by ``pad_token_id``."""
        mask = (input_ids != self.pad_token_id).long()
        return torch.cumsum(mask, dim=1) * mask + self.pad_token_id

    def forward(
        self,
        input_ids: Optional[torch.Tensor] = None,
        token_type_ids: Optional[torch.Tensor] = None,
        position_ids: Optional[torch.Tensor] = None,
        inputs_embeds: Optional[torch.Tensor] = None,
        deterministic: bool = True,
    ) -> torch.Tensor:
        if input_ids is not None:
            shape, device = input_ids.shape, input_ids.device
        elif inputs_embeds is not None:
            shape, device = inputs_embeds.shape[:-1], inputs_embeds.device
        else:
            raise ValueError("input_ids or inputs_embeds must not be None")
        dt = self.dtype or self.word_embeddings.weight.dtype
        if position_ids is None:
            if self.offset_pos_ids:
                position_ids = self.create_position_ids_from_input_ids(input_ids)
            else:
                position_ids = torch.arange(shape[1], device=device).expand(shape)
        if token_type_ids is None:
            token_type_ids = torch.zeros(shape, dtype=torch.long, device=device)
        if inputs_embeds is None:
            inputs_embeds = self.word_embeddings.weight.to(dt)[input_ids]
        emb = (inputs_embeds.to(dt) + self.position_embeddings.weight.to(dt)[position_ids]
               + self.token_type_embeddings.weight.to(dt)[token_type_ids])
        emb = self.layer_norm(emb)
        return F.dropout(emb, self.dropout, training=not deterministic and self.dropout > 0)

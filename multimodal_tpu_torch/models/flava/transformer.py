"""FLAVA multimodal transformer wrapper. Counterpart of
``multimodal_tpu/models/flava/transformer.py``: the encoder over
pre-embedded inputs with a fresh CLS token in front, the final LayerNorm
outside the stack, and a pooler."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from multimodal_tpu_torch.modules.layers.transformer import TransformerOutput


class FLAVATransformerWithoutEmbeddings(nn.Module):
    def __init__(self, encoder: nn.Module, layernorm: nn.Module,
                 pooler: Optional[nn.Module] = None, hidden_size: int = 768,
                 use_cls_token: bool = True):
        super().__init__()
        self.encoder = encoder
        self.layernorm = layernorm
        self.pooler = pooler
        self.cls_token = (nn.Parameter(torch.zeros(1, 1, hidden_size))
                          if use_cls_token else None)

    def forward(self, hidden_states: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None,
                deterministic: bool = True) -> TransformerOutput:
        if self.cls_token is not None:
            cls = self.cls_token.to(hidden_states.dtype).expand(hidden_states.shape[0], 1, -1)
            hidden_states = torch.cat([cls, hidden_states], dim=1)
        encoder_output = self.encoder(hidden_states, attention_mask=attention_mask,
                                      return_hidden_states=True, return_attn_weights=True,
                                      deterministic=deterministic)
        sequence_output = self.layernorm(encoder_output.last_hidden_state)
        pooled = self.pooler(sequence_output) if self.pooler is not None else None
        return TransformerOutput(last_hidden_state=sequence_output, pooler_output=pooled,
                                 hidden_states=encoder_output.hidden_states,
                                 attentions=encoder_output.attentions)

"""CLIP text encoder. Counterpart of
``multimodal_tpu/models/clip/text_encoder.py``.

Token and position embedding, the causal pre-norm stack, fp32
``ln_final``, pooling at the EOT token (the argmax of the token ids) and a
bias-free projection. ``dtype`` is the compute dtype (None: the weights'
dtype); every weight but the LayerNorm's is cast to it at use.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from multimodal_tpu_torch.models.clip.transformer import CLIPTransformer
from multimodal_tpu_torch.modules.layers.normalizations import Fp32LayerNorm


class CLIPTextEncoder(nn.Module):
    TOKEN_EMBEDDING_INIT_STD = 0.02
    POS_EMBEDDING_INIT_STD = 0.01

    def __init__(self, embedding_dim: int = 512, context_length: int = 77,
                 vocab_size: int = 49408, width: int = 512,
                 dim_feedforward: int = 2048, heads: int = 8, layers: int = 12,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.context_length = context_length
        self.token_embedding = nn.Embedding(vocab_size, width)
        self.positional_embedding = nn.Parameter(torch.empty(context_length, width))
        self.encoder = CLIPTransformer(width, heads, layers, dim_feedforward)
        self.ln_final = Fp32LayerNorm(width, eps=1e-5)
        self.projection = nn.Linear(width, embedding_dim, bias=False)

    def forward(self, text: torch.Tensor) -> torch.Tensor:
        """text: (b, context_length) token ids; the EOT token has the
        highest id of each row."""
        if text.shape[1] != self.context_length:
            raise ValueError(
                f"length of input should be {self.context_length} but found {text.shape[1]}"
            )
        dtype = self.dtype or self.token_embedding.weight.dtype
        # gather, then cast: the same values as casting the table first
        h = self.token_embedding(text).to(dtype) + self.positional_embedding.to(dtype)
        hidden = self.ln_final(self.encoder(h, is_causal=True))
        eot = text.argmax(dim=-1)
        pooled = hidden[torch.arange(text.shape[0], device=text.device), eot]
        return F.linear(pooled, self.projection.weight.to(dtype))

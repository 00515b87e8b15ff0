"""Learned-query attention pooling (CoCa). Counterpart of
``multimodal_tpu/modules/layers/attention_pooler.py`` (``AttentionPooler``,
``CascadedAttentionPooler``).

The pooler's cross-attention is the port's ``MultiHeadAttentionWithCache``:
with ``n_queries`` and the sequence both from ``FLASH_MIN_SEQ`` up it takes
the flash kernel (#6), CoCa-L's 256 queries over 256 tokens at head width 96
among them; the 1-query contrastive stage takes the plain path. The compute
dtype is the input's; the LayerNorms run in fp32.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
from torch import nn

from multimodal_tpu_torch.modules.layers.multi_head_attention import MultiHeadAttentionWithCache
from multimodal_tpu_torch.modules.layers.normalizations import Fp32LayerNorm


class AttentionPooler(nn.Module):
    """Pool a sequence to ``n_queries`` tokens by cross-attending learned
    queries (``query``, ``(n_queries, output_embed_dim)``)."""

    def __init__(self, input_embed_dim: int, output_embed_dim: int, n_head: int,
                 n_queries: int = 256, layer_norm_eps: float = 1e-5):
        super().__init__()
        self.n_queries = n_queries
        self.output_embed_dim = output_embed_dim
        self.query = nn.Parameter(torch.randn(n_queries, output_embed_dim))
        self.ln_k = Fp32LayerNorm(input_embed_dim, eps=layer_norm_eps)
        self.ln_q = Fp32LayerNorm(output_embed_dim, eps=layer_norm_eps)
        self.attn = MultiHeadAttentionWithCache(output_embed_dim, input_embed_dim, n_head)
        self.ln_post = Fp32LayerNorm(output_embed_dim, eps=layer_norm_eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.ln_k(x)
        q = self.ln_q(self.query).to(x.dtype)
        q = q[None].expand(x.shape[0], -1, -1)
        return self.ln_post(self.attn(q, x, x))


class CascadedAttentionPooler(nn.Module):
    """Poolers in sequence, each stage's output returned. The stages are
    the submodules ``poolers_0``, ``poolers_1``, ..., the JAX module's
    parameter names."""

    def __init__(self, poolers: Sequence[AttentionPooler]):
        super().__init__()
        for i, pooler in enumerate(poolers):
            self.add_module(f"poolers_{i}", pooler)
        self.n_poolers = len(poolers)

    @property
    def poolers(self) -> List[AttentionPooler]:
        return [getattr(self, f"poolers_{i}") for i in range(self.n_poolers)]

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        outs = []
        for pooler in self.poolers:
            x = pooler(x)
            outs.append(x)
        return outs

"""CoCa text decoder. Counterpart of
``multimodal_tpu/models/coca/text_decoder.py`` (``CoCaTextEmbeddings``,
``CoCaTextDecoder``): the CLS token appended at the sequence's end (the last
input token dropped to make room when the input fills the position table),
the causal-and-key-padding mask of :meth:`CoCaTextDecoder.build_mask`, and
the pooled output the last position through ``ln_final`` and the projection
(or, without ``embed_cls``, the EOT-argmax position).

The mask is a dense ``(b, 1, s+1, s+1)`` bool, as the JAX module builds it,
so each layer's self-attention takes the flash kernel's bias route (#6 and
its backward) from ``FLASH_MIN_SEQ`` tokens up.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple, Union

import torch
from torch import nn

from multimodal_tpu_torch.modules.layers.multi_head_attention import dense
from multimodal_tpu_torch.modules.layers.normalizations import Fp32LayerNorm
from multimodal_tpu_torch.modules.layers.transformer import TransformerDecoder


class CoCaTextEmbeddings(nn.Module):
    """Token embeddings, the appended CLS embedding and learned positions,
    summed in the compute ``dtype`` (None: the weights')."""

    def __init__(self, vocab_size: int, num_positions: int, embedding_dim: int,
                 pad_idx: Optional[int] = 0, embed_cls: bool = True,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.num_positions = num_positions
        self.embed_cls = embed_cls
        self.dtype = dtype
        self.token_embeddings = nn.Embedding(vocab_size, embedding_dim)
        self.cls_embedding = (nn.Parameter(torch.full((embedding_dim,), 0.01))
                              if embed_cls else None)
        self.position_embeddings = nn.Parameter(torch.randn(num_positions, embedding_dim) * 0.01)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        expected = self.num_positions - 1 if self.embed_cls else self.num_positions
        if input_ids.shape[1] != expected:
            raise ValueError(f"expected seq len {expected}, got {input_ids.shape[1]}")
        dt = self.dtype or self.token_embeddings.weight.dtype
        emb = self.token_embeddings.weight.to(dt)[input_ids]
        if self.embed_cls:
            cls = self.cls_embedding.to(dt)[None, None].expand(input_ids.shape[0], 1, -1)
            emb = torch.cat([emb, cls], dim=1)
        return emb + self.position_embeddings.to(dt)


class CoCaTextDecoder(nn.Module):
    """Embeddings, a causal pre-norm ``TransformerDecoder`` without
    cross-attention, ``ln_final`` and ``text_projection``. Returns
    ``(pooled, tokens)``."""

    def __init__(
        self,
        vocab_size: int,
        num_positions: int,
        embedding_dim: int,
        n_layer: int,
        n_head: int,
        dim_feedforward: int,
        output_dim: int,
        pad_idx: Optional[int] = 0,
        embed_cls: bool = True,
        dropout: float = 0.0,
        activation: Union[str, Callable] = "gelu",
        layer_norm_eps: float = 1e-5,
        norm_first: bool = True,
        final_layer_norm_eps: Optional[float] = 1e-5,
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        self.vocab_size = vocab_size
        self.num_positions = num_positions
        self.embedding_dim = embedding_dim
        self.n_layer = n_layer
        self.n_head = n_head
        self.pad_idx = pad_idx
        self.embed_cls = embed_cls
        self.final_layer_norm_eps = final_layer_norm_eps
        self.embeddings = CoCaTextEmbeddings(vocab_size, num_positions, embedding_dim, pad_idx,
                                             embed_cls, dtype)
        self.transformer_decoder = TransformerDecoder(
            n_layer=n_layer, d_model=embedding_dim, n_head=n_head,
            dim_feedforward=dim_feedforward, dropout=dropout, activation=activation,
            layer_norm_eps=layer_norm_eps, norm_first=norm_first, use_cross_attention=False)
        self.ln_final = (Fp32LayerNorm(embedding_dim, eps=final_layer_norm_eps)
                         if final_layer_norm_eps is not None else None)
        self.text_projection = nn.Linear(embedding_dim, output_dim, bias=False)

    def build_mask(self, input_ids: torch.Tensor,
                   padding_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Bool, True = attend: causal ``(1, 1, s', s')`` without a CLS or a
        pad id, else causal AND key padding ``(b, 1, s+1, s+1)`` with the
        CLS position always attendable."""
        seq_len = input_ids.shape[1] + (1 if self.embed_cls else 0)
        causal = torch.ones(seq_len, seq_len, dtype=torch.bool,
                            device=input_ids.device).tril()
        if not self.embed_cls or self.pad_idx is None:
            return causal[None, None]
        if padding_mask is None:
            padding_mask = input_ids != self.pad_idx
        pm = torch.nn.functional.pad(padding_mask.bool()[:, None, :], (0, 1), value=True)
        return (pm & causal[None])[:, None]

    def forward(self, input_ids: torch.Tensor, padding_mask: Optional[torch.Tensor] = None,
                deterministic: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
        if self.embed_cls:
            if input_ids.shape[1] == self.num_positions:
                input_ids = input_ids[:, :-1]
            if padding_mask is not None and padding_mask.shape[1] == self.num_positions:
                padding_mask = padding_mask[:, :-1]
        embeddings = self.embeddings(input_ids)
        mask = self.build_mask(input_ids, padding_mask)
        hidden = self.transformer_decoder(embeddings, attention_mask=mask,
                                          deterministic=deterministic).last_hidden_state
        if self.embed_cls:
            pooled, tokens = hidden[:, -1], hidden[:, :-1]
            if self.ln_final is not None:
                pooled = self.ln_final(pooled)
        else:
            hidden = self.ln_final(hidden)
            eot = input_ids.argmax(dim=-1)
            pooled = hidden[torch.arange(hidden.shape[0], device=hidden.device), eot]
            tokens = hidden
        return dense(self.text_projection, pooled, pooled.dtype), tokens

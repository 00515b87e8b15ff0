"""CoCa multimodal decoder. Counterpart of
``multimodal_tpu/models/coca/multimodal_decoder.py``
(``CoCaMultimodalDecoder``): a causal pre-norm ``TransformerDecoder`` over
the text tokens that cross-attends the pooled image tokens, with an optional
output projection (the vocabulary logits).

Its self-attention is causal: the JAX module's dense ``(1, 1, s, s)`` causal
bool, handed to the kernels as ``is_causal`` with no mask (the same
function: no row is masked wholly and Sq = Sk), so from ``FLASH_MIN_SEQ``
tokens up it takes #6's causal loop and the backward's causal walk, which
beat the mask on the bias lane on the card (PERF.md); the cross-attention
takes #6 without a bias.
"""

from __future__ import annotations

from typing import Callable, Optional, Union

import torch
from torch import nn

from multimodal_tpu_torch.modules.layers.multi_head_attention import dense
from multimodal_tpu_torch.modules.layers.transformer import TransformerDecoder


class CoCaMultimodalDecoder(nn.Module):
    def __init__(
        self,
        input_seq_len: int,
        text_embedding_dim: int,
        n_layer: int,
        n_head: int,
        dim_feedforward: int,
        output_dim: Optional[int] = None,
        dropout: float = 0.0,
        activation: Union[str, Callable] = "gelu",
        layer_norm_eps: float = 1e-5,
        norm_first: bool = True,
        final_layer_norm_eps: Optional[float] = 1e-5,
        visual_embedding_dim: Optional[int] = None,
    ):
        super().__init__()
        self.input_seq_len = input_seq_len
        self.text_embedding_dim = text_embedding_dim
        self.n_layer = n_layer
        self.n_head = n_head
        self.output_dim = output_dim
        self.transformer_decoder = TransformerDecoder(
            n_layer=n_layer, d_model=text_embedding_dim, n_head=n_head,
            dim_feedforward=dim_feedforward, dropout=dropout, activation=activation,
            layer_norm_eps=layer_norm_eps, norm_first=norm_first, use_cross_attention=True,
            dim_kv=visual_embedding_dim, final_layer_norm_eps=final_layer_norm_eps)
        self.output_projection = (nn.Linear(text_embedding_dim, output_dim, bias=False)
                                  if output_dim is not None else None)

    def forward(self, texts: torch.Tensor, images: torch.Tensor,
                deterministic: bool = True) -> torch.Tensor:
        seq_len = texts.shape[1]
        if seq_len != self.input_seq_len:
            raise ValueError(f"expected text seq len {self.input_seq_len}, got {seq_len}")
        hidden = self.transformer_decoder(texts, encoder_hidden_states=images, is_causal=True,
                                          deterministic=deterministic).last_hidden_state
        if self.output_projection is not None:
            hidden = dense(self.output_projection, hidden, hidden.dtype)
        return hidden

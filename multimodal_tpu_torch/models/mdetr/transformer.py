"""MDETR multimodal transformer. Counterpart of
``multimodal_tpu/models/mdetr/transformer.py``.

DETR-style layers: the position embeddings are added to the queries and
keys at every layer; the encoder runs over ``[image tokens; text tokens]``
with a zero position embedding for the text; the decoder starts from zero
targets with the learned query embeddings added at each layer and returns
every layer's state through one shared final LayerNorm. Post-norm by
default. Attention takes each key-padding mask as a boolean ``(b, 1, 1,
k)`` mask, which ``ops/attention.py`` turns into segment ids (queries 1,
keys by the mask) for the flash kernel, as the JAX dispatch does: a padded
query row attends to the real keys like any other. A position embedding
held in fp32 is added in fp32 and the sum rounded to the tokens' dtype, as
the JAX layers' projections round their inputs.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Union

import torch
from torch import nn
from torch.nn import functional as F

from multimodal_tpu_torch.modules.layers.mlp import MLP
from multimodal_tpu_torch.modules.layers.multi_head_attention import MultiHeadAttentionWithCache
from multimodal_tpu_torch.modules.layers.normalizations import Fp32LayerNorm


class MDETRTransformerOutput(NamedTuple):
    decoder_hidden_states: torch.Tensor  # (n_layers, b, num_queries, d)
    text_memory: torch.Tensor


def _key_padding_mask(key_padding_mask: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """(b, k) True = PADDED -> boolean attend-mask (b, 1, 1, k)."""
    if key_padding_mask is None:
        return None
    return (~key_padding_mask)[:, None, None, :]


def _with(t: torch.Tensor, pos: Optional[torch.Tensor]) -> torch.Tensor:
    return t if pos is None else (t + pos).to(t.dtype)


class MDETREncoderLayer(nn.Module):
    def __init__(self, d_model: int, num_heads: int, dim_feedforward: int = 2048,
                 dropout: float = 0.1, activation: Union[str, Callable] = "relu",
                 normalize_before: bool = False):
        super().__init__()
        self.dropout = dropout
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttentionWithCache(d_model, d_model, num_heads, dropout)
        self.mlp = MLP(d_model, d_model, [dim_feedforward], dropout, activation)
        self.norm1 = Fp32LayerNorm(d_model, eps=1e-5)
        self.norm2 = Fp32LayerNorm(d_model, eps=1e-5)

    def forward(self, src, src_key_padding_mask=None, pos=None, deterministic: bool = True):
        drop = lambda t: F.dropout(t, self.dropout,  # noqa: E731
                                   training=not deterministic and self.dropout > 0)
        mask = _key_padding_mask(src_key_padding_mask)
        x = src
        if self.normalize_before:
            h = self.norm1(x)
            q = _with(h, pos)
            x = x + drop(self.self_attn(q, q, h, attn_mask=mask, deterministic=deterministic))
            x = x + drop(self.mlp(self.norm2(x), deterministic=deterministic))
            return x
        q = _with(x, pos)
        x = x + drop(self.self_attn(q, q, x, attn_mask=mask, deterministic=deterministic))
        x = self.norm1(x)
        x = x + drop(self.mlp(x, deterministic=deterministic))
        return self.norm2(x)


class MDETRDecoderLayer(nn.Module):
    def __init__(self, d_model: int, num_heads: int, dim_feedforward: int = 2048,
                 dropout: float = 0.1, activation: Union[str, Callable] = "relu"):
        super().__init__()
        self.dropout = dropout
        self.self_attn = MultiHeadAttentionWithCache(d_model, d_model, num_heads, dropout)
        self.cross_attn_image = MultiHeadAttentionWithCache(d_model, d_model, num_heads, dropout)
        self.mlp = MLP(d_model, d_model, [dim_feedforward], dropout, activation)
        self.norm1 = Fp32LayerNorm(d_model, eps=1e-5)
        self.norm3 = Fp32LayerNorm(d_model, eps=1e-5)
        self.norm4 = Fp32LayerNorm(d_model, eps=1e-5)

    def forward(self, tgt, memory, memory_key_padding_mask=None, pos=None, query_pos=None,
                deterministic: bool = True):
        drop = lambda t: F.dropout(t, self.dropout,  # noqa: E731
                                   training=not deterministic and self.dropout > 0)
        x = tgt
        q = _with(x, query_pos)
        x = self.norm1(x + drop(self.self_attn(q, q, x, deterministic=deterministic)))
        x = x + drop(self.cross_attn_image(
            _with(x, query_pos), _with(memory, pos), memory,
            attn_mask=_key_padding_mask(memory_key_padding_mask), deterministic=deterministic))
        x = self.norm3(x)
        x = x + drop(self.mlp(x, deterministic=deterministic))
        return self.norm4(x)


class MDETRTransformer(nn.Module):
    def __init__(self, d_model: int = 256, num_heads: int = 8, num_encoder_layers: int = 6,
                 num_decoder_layers: int = 6, dim_feedforward: int = 2048, dropout: float = 0.1,
                 activation: Union[str, Callable] = "relu", normalize_before: bool = False,
                 return_intermediate_dec: bool = True):
        super().__init__()
        self.d_model = d_model
        self.num_encoder_layers = num_encoder_layers
        self.num_decoder_layers = num_decoder_layers
        self.normalize_before = normalize_before
        self.return_intermediate_dec = return_intermediate_dec
        for i in range(num_encoder_layers):
            self.add_module(f"encoder_{i}", MDETREncoderLayer(
                d_model, num_heads, dim_feedforward, dropout, activation, normalize_before))
        self.encoder_norm = Fp32LayerNorm(d_model, eps=1e-5) if normalize_before else None
        for i in range(num_decoder_layers):
            self.add_module(f"decoder_{i}", MDETRDecoderLayer(
                d_model, num_heads, dim_feedforward, dropout, activation))
        # one final norm shared by every intermediate state
        self.decoder_norm = Fp32LayerNorm(d_model, eps=1e-5)

    def forward(
        self,
        image_embeddings: torch.Tensor,    # (b, fh, fw, d)
        image_mask: torch.Tensor,          # (b, fh, fw) True = padded
        query_embed: torch.Tensor,         # (num_queries, d)
        pos_embed: torch.Tensor,           # (b, fh, fw, d)
        text_memory: torch.Tensor,         # (b, text_len, d)
        text_attention_mask: torch.Tensor,  # (b, text_len) True = padded
        deterministic: bool = True,
    ) -> MDETRTransformerOutput:
        b = image_embeddings.shape[0]
        img_tokens = image_embeddings.reshape(b, -1, self.d_model)
        pos = pos_embed.reshape(b, -1, self.d_model)
        mm = torch.cat([img_tokens, text_memory.to(img_tokens.dtype)], dim=1)
        mm_mask = torch.cat([image_mask.reshape(b, -1), text_attention_mask], dim=1)
        # a zero position embedding for the text: adding it is a no-op
        pos = torch.cat([pos, torch.zeros_like(text_memory, dtype=pos.dtype)], dim=1)

        for i in range(self.num_encoder_layers):
            mm = getattr(self, f"encoder_{i}")(mm, mm_mask, pos, deterministic)
        if self.encoder_norm is not None:
            mm = self.encoder_norm(mm)
        text_out = mm[:, -text_memory.shape[1]:]

        queries = query_embed.to(mm.dtype)[None].expand(b, -1, -1)
        tgt = torch.zeros_like(queries)
        intermediates = []
        for i in range(self.num_decoder_layers):
            tgt = getattr(self, f"decoder_{i}")(tgt, mm, mm_mask, pos, queries, deterministic)
            if self.return_intermediate_dec:
                intermediates.append(self.decoder_norm(tgt))
        hs = torch.stack(intermediates) if self.return_intermediate_dec \
            else self.decoder_norm(tgt)[None]
        return MDETRTransformerOutput(decoder_hidden_states=hs, text_memory=text_out)

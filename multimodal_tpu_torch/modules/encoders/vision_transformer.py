"""Composable Vision Transformer encoder. Counterpart of
``multimodal_tpu/modules/encoders/vision_transformer.py``
(``VisionTransformer``, ``GlobalAveragePooler``, ``vision_transformer``,
``vit_b_16`` ... ``vit_h_14``). Images are NHWC.

The stack is the port's ``TransformerEncoder``: each layer's attention takes
the fused kernel (#1) up to 256 tokens and the flash kernel (#6) past it
(ViT-B/16 at 384: 577 tokens), and its MLP the fused MLP kernel (#3).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple, Union

import torch
from torch import nn
from torch.nn import functional as F

from multimodal_tpu_torch.modules.layers.normalizations import Fp32LayerNorm
from multimodal_tpu_torch.modules.layers.patch_embedding import PatchEmbeddings
from multimodal_tpu_torch.modules.layers.transformer import TransformerEncoder, TransformerOutput


class VisionTransformer(nn.Module):
    """embeddings -> encoder -> optional pooler, returning TransformerOutput."""

    def __init__(self, embeddings: nn.Module, encoder: nn.Module,
                 pooler: Optional[nn.Module] = None):
        super().__init__()
        self.embeddings = embeddings
        self.encoder = encoder
        self.pooler = pooler

    def forward(
        self,
        images: torch.Tensor,
        image_patches_mask: Optional[torch.Tensor] = None,
        attention_mask: Optional[torch.Tensor] = None,
        deterministic: bool = True,
        generator: Optional[torch.Generator] = None,
    ) -> TransformerOutput:
        embedding_output = self.embeddings(images, image_patches_mask=image_patches_mask,
                                           deterministic=deterministic,
                                           generator=generator).embeddings
        encoder_output = self.encoder(embedding_output, attention_mask=attention_mask,
                                      return_hidden_states=True, deterministic=deterministic)
        last_hidden_state = encoder_output.last_hidden_state
        pooled = self.pooler(last_hidden_state) if self.pooler is not None else None
        return TransformerOutput(last_hidden_state=last_hidden_state, pooler_output=pooled,
                                 hidden_states=encoder_output.hidden_states,
                                 attentions=encoder_output.attentions)


class GlobalAveragePooler(nn.Module):
    """Mean over the non-CLS tokens, an fp32 LayerNorm (``norm``) and an
    optional linear ``head``."""

    def __init__(self, input_dim: int, output_dim: Optional[int] = None, ln_eps: float = 1e-6):
        super().__init__()
        self.norm = Fp32LayerNorm(input_dim, eps=ln_eps)
        self.head = nn.Linear(input_dim, output_dim) if output_dim else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.norm(x[:, 1:, :].mean(dim=1))
        if self.head is not None:
            dt = x.dtype
            out = F.linear(out, self.head.weight.to(dt), self.head.bias.to(dt))
        return out


def vision_transformer(
    *,
    patch_size: int,
    hidden_dim: int,
    dim_feedforward: int,
    n_layer: int,
    n_head: int,
    image_size: Union[int, Tuple[int, int]] = 224,
    num_channels: int = 3,
    activation: Union[str, Callable] = "gelu",
    transformer_dropout: float = 0.0,
    patch_embed_dropout_prob: float = 0.0,
    layer_norm_eps: float = 1e-6,
    final_layer_norm_eps: Optional[float] = 1e-6,
    norm_first: bool = True,
    include_cls_embed: bool = True,
    drop_path_rate: Optional[float] = None,
    patch_drop_rate: Optional[Union[float, Tuple[float, float]]] = None,
    pooler: Optional[nn.Module] = None,
    dtype: Optional[torch.dtype] = None,
    remat: bool = False,
) -> VisionTransformer:
    """``dtype`` is the compute dtype (None: the weights')."""
    embeddings = PatchEmbeddings(
        image_size=image_size, patch_size=patch_size, hidden_size=hidden_dim,
        hidden_dropout_prob=patch_embed_dropout_prob, patch_drop_rate=patch_drop_rate,
        num_channels=num_channels, include_cls_embed=include_cls_embed, dtype=dtype)
    encoder = TransformerEncoder(
        n_layer=n_layer, d_model=hidden_dim, n_head=n_head, dim_feedforward=dim_feedforward,
        dropout=transformer_dropout, activation=activation, layer_norm_eps=layer_norm_eps,
        norm_first=norm_first, final_layer_norm_eps=final_layer_norm_eps,
        drop_path_rate=drop_path_rate, remat=remat)
    return VisionTransformer(embeddings=embeddings, encoder=encoder, pooler=pooler)


def vit_b_16(pooler: Optional[nn.Module] = None, **kwargs) -> VisionTransformer:
    return vision_transformer(patch_size=16, n_layer=12, n_head=12, hidden_dim=768,
                              dim_feedforward=3072, pooler=pooler, **kwargs)


def vit_b_32(pooler: Optional[nn.Module] = None, **kwargs) -> VisionTransformer:
    return vision_transformer(patch_size=32, n_layer=12, n_head=12, hidden_dim=768,
                              dim_feedforward=3072, pooler=pooler, **kwargs)


def vit_l_16(pooler: Optional[nn.Module] = None, **kwargs) -> VisionTransformer:
    return vision_transformer(patch_size=16, n_layer=24, n_head=16, hidden_dim=1024,
                              dim_feedforward=4096, pooler=pooler, **kwargs)


def vit_l_32(pooler: Optional[nn.Module] = None, **kwargs) -> VisionTransformer:
    return vision_transformer(patch_size=32, n_layer=24, n_head=16, hidden_dim=1024,
                              dim_feedforward=4096, pooler=pooler, **kwargs)


def vit_h_14(pooler: Optional[nn.Module] = None, **kwargs) -> VisionTransformer:
    return vision_transformer(patch_size=14, n_layer=32, n_head=16, hidden_dim=1280,
                              dim_feedforward=5120, pooler=pooler, **kwargs)

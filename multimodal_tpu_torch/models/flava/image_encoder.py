"""FLAVA image encoder: a ViT with BEiT-style mask tokens. Counterpart of
``multimodal_tpu/models/flava/image_encoder.py`` (``ImageEmbeddings``,
``ImageTransformer``, ``flava_image_encoder``, ``ImageTransformerWithVAE``).
Images are NHWC, as in the JAX package; the patch conv permutes to NCHW
internally. With ``interpolate_pos_encoding`` an image of another size
takes the patch position embeddings resampled to its grid by an
antialiased bicubic resize (``F.interpolate``, which follows
``jax.image.resize(method="cubic")``).
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Union

import torch
from torch import nn
from torch.nn import functional as F

from multimodal_tpu_torch.modules.layers.normalizations import Fp32LayerNorm
from multimodal_tpu_torch.modules.layers.transformer import TransformerEncoder, TransformerOutput
from multimodal_tpu_torch.modules.losses.flava import Pooler


class ImageEmbeddings(nn.Module):
    """CLS + conv patchify + learned position embeddings + mask token.
    ``dtype`` is the compute dtype (None: the weights' dtype)."""

    def __init__(self, image_size: int = 224, patch_size: int = 16, num_channels: int = 3,
                 hidden_size: int = 768, hidden_dropout_prob: float = 0.0,
                 use_image_masking: bool = True, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.image_size = image_size
        self.patch_size = patch_size
        self.hidden_dropout_prob = hidden_dropout_prob
        self.dtype = dtype
        n = (image_size // patch_size) ** 2
        self.patch_projection = nn.Conv2d(num_channels, hidden_size, patch_size,
                                          stride=patch_size)
        self.position_embeddings = nn.Parameter(torch.zeros(1, n + 1, hidden_size))
        self.cls_token = nn.Parameter(torch.zeros(1, 1, hidden_size))
        self.mask_token = (nn.Parameter(torch.zeros(1, 1, hidden_size))
                           if use_image_masking else None)

    def forward(self, pixel_values: torch.Tensor,
                image_patches_mask: Optional[torch.Tensor] = None,
                interpolate_pos_encoding: bool = False,
                deterministic: bool = True) -> torch.Tensor:
        b, h, w, _ = pixel_values.shape
        if not interpolate_pos_encoding and (h != self.image_size or w != self.image_size):
            raise ValueError(
                f"Input image size ({h}*{w}) doesn't match model ({self.image_size}).")
        dt = self.dtype or self.patch_projection.weight.dtype
        conv = self.patch_projection
        patches = F.conv2d(pixel_values.to(dt).permute(0, 3, 1, 2), conv.weight.to(dt),
                           conv.bias.to(dt), stride=self.patch_size)
        emb = patches.flatten(2).transpose(1, 2)  # (b, n_patches, hidden), row-major grid
        if image_patches_mask is not None and self.mask_token is not None:
            # the mask arrives flat (b, n) or as the transform's (b, gh, gw) grid
            m = image_patches_mask.reshape(b, -1)[..., None].to(dt)
            emb = emb * (1 - m) + self.mask_token.to(dt) * m
        cls = self.cls_token.to(dt).expand(b, 1, -1)
        emb = torch.cat([cls, emb], dim=1)
        pos = self.position_embeddings
        if interpolate_pos_encoding and emb.shape[1] != pos.shape[1]:
            pos = self._interpolate(pos, h // self.patch_size, w // self.patch_size)
        emb = emb + pos.to(dt)
        return F.dropout(emb, self.hidden_dropout_prob,
                         training=not deterministic and self.hidden_dropout_prob > 0)

    @staticmethod
    def _interpolate(position_embeddings: torch.Tensor, n_h: int, n_w: int) -> torch.Tensor:
        """The patch position embeddings resampled to an ``n_h`` x ``n_w``
        grid (bicubic, antialiased); the CLS position stays."""
        cls_pos, patch_pos = position_embeddings[:, :1], position_embeddings[:, 1:]
        d = patch_pos.shape[-1]
        side = int(math.sqrt(patch_pos.shape[1]))
        grid = patch_pos.reshape(1, side, side, d).permute(0, 3, 1, 2).float()
        resized = F.interpolate(grid, size=(n_h, n_w), mode="bicubic", align_corners=False,
                                antialias=True)
        resized = resized.permute(0, 2, 3, 1).reshape(1, n_h * n_w, d)
        return torch.cat([cls_pos, resized.to(cls_pos.dtype)], dim=1)


class ImageTransformer(nn.Module):
    """embeddings -> encoder (hidden-state and attention taps on) -> final
    LayerNorm -> pooler."""

    def __init__(self, embeddings: nn.Module, encoder: nn.Module, layernorm: nn.Module,
                 pooler: Optional[nn.Module] = None):
        super().__init__()
        self.embeddings = embeddings
        self.encoder = encoder
        self.layernorm = layernorm
        self.pooler = pooler

    def forward(self, pixel_values: torch.Tensor,
                image_patches_mask: Optional[torch.Tensor] = None,
                attention_mask: Optional[torch.Tensor] = None,
                deterministic: bool = True) -> TransformerOutput:
        embedding_output = self.embeddings(pixel_values, image_patches_mask=image_patches_mask,
                                           deterministic=deterministic)
        encoder_output = self.encoder(embedding_output, attention_mask=attention_mask,
                                      return_hidden_states=True, return_attn_weights=True,
                                      deterministic=deterministic)
        sequence_output = self.layernorm(encoder_output.last_hidden_state)
        pooled = self.pooler(sequence_output) if self.pooler is not None else None
        return TransformerOutput(last_hidden_state=sequence_output, pooler_output=pooled,
                                 hidden_states=encoder_output.hidden_states,
                                 attentions=encoder_output.attentions)


def flava_image_encoder(
    hidden_size: int = 768,
    num_attention_heads: int = 12,
    num_hidden_layers: int = 12,
    use_image_masking: bool = False,
    dropout: float = 0.0,
    intermediate_size: int = 3072,
    intermediate_activation: Union[str, Callable] = "gelu",
    layer_norm_eps: float = 1e-12,
    image_size: int = 224,
    patch_size: int = 16,
    num_channels: int = 3,
    dtype: Optional[torch.dtype] = None,
    remat: bool = False,
    moe_num_experts: Optional[int] = None,
) -> ImageTransformer:
    embeddings = ImageEmbeddings(image_size=image_size, patch_size=patch_size,
                                 num_channels=num_channels, hidden_size=hidden_size,
                                 hidden_dropout_prob=dropout,
                                 use_image_masking=use_image_masking, dtype=dtype)
    encoder = TransformerEncoder(
        n_layer=num_hidden_layers, d_model=hidden_size, n_head=num_attention_heads,
        dim_feedforward=intermediate_size, activation=intermediate_activation,
        layer_norm_eps=layer_norm_eps, dropout=dropout, norm_first=True, remat=remat,
        moe_num_experts=moe_num_experts)
    return ImageTransformer(embeddings=embeddings, encoder=encoder,
                            layernorm=Fp32LayerNorm(hidden_size, eps=layer_norm_eps),
                            pooler=Pooler(hidden_size))


class ImageTransformerWithVAE(nn.Module):
    """An image transformer and the dVAE that gives its MIM labels: the
    codebook index of each patch where ``image_patches_mask`` is set, -1
    elsewhere."""

    def __init__(self, image_transformer: nn.Module, vae: nn.Module):
        super().__init__()
        self.image_transformer = image_transformer
        self.vae = vae

    def forward(self, pixel_values: torch.Tensor,
                image_patches_mask: Optional[torch.Tensor] = None,
                attention_mask: Optional[torch.Tensor] = None,
                deterministic: bool = True) -> TransformerOutput:
        b = pixel_values.shape[0]
        labels = self.vae(pixel_values).reshape(b, -1)
        mask = image_patches_mask.reshape(b, -1).bool()
        labels = torch.where(mask, labels, -1)
        out = self.image_transformer(pixel_values, image_patches_mask=image_patches_mask,
                                     attention_mask=attention_mask,
                                     deterministic=deterministic)
        return out._replace(image_labels=labels)

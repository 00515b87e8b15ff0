"""Patch embeddings for vision transformers. Counterpart of
``multimodal_tpu/modules/layers/patch_embedding.py`` (``PatchEmbeddings``):
conv patchify, CLS token, learned position embeddings, BEiT-style
mask-token substitution and MAE-style patch dropping (1-d and 2-d).

Images are NHWC, as in the JAX package; the patch conv permutes to NCHW
internally. ``dtype`` is the compute dtype (None: the weights' dtype); every
weight is cast to it at use. The patch drop draws its noise from the
caller's ``generator`` (or takes ``noise``; see
``modules/masking/random_masking.py``). The fixed sin-cos position
embeddings (``use_fixed_sincos_pos``) come from the MAE module, which is not
ported yet (ROADMAP.md, queue A6.5).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple, Union

import torch
from torch import nn
from torch.nn import functional as F

from multimodal_tpu_torch.modules.masking.random_masking import (
    random_masking,
    random_masking_2d,
)


class PatchEmbeddingsOutput(NamedTuple):
    embeddings: torch.Tensor
    random_mask: Optional[torch.Tensor] = None
    ids_restore: Optional[torch.Tensor] = None


class PatchEmbeddings(nn.Module):
    """Conv patchify + CLS + learned position embeddings (+ masking).
    Parameter names follow the JAX module's: ``conv_projection``,
    ``position_embeddings``, ``mask_token``, ``cls_token``."""

    def __init__(
        self,
        image_size: Union[int, Tuple[int, int]] = 224,
        patch_size: int = 16,
        num_channels: int = 3,
        hidden_size: int = 768,
        hidden_dropout_prob: float = 0.0,
        use_image_masking: bool = False,
        patch_drop_rate: Optional[Union[float, Tuple[float, float]]] = None,
        include_cls_embed: bool = True,
        use_fixed_sincos_pos: bool = False,
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        if use_fixed_sincos_pos:
            raise NotImplementedError(
                "fixed sin-cos position embeddings come from the MAE module, which is not "
                "ported yet (ROADMAP.md, queue A6.5)")
        self.image_size = (image_size, image_size) if isinstance(image_size, int) \
            else tuple(image_size)
        img_h, img_w = self.image_size
        if img_h % patch_size or img_w % patch_size:
            raise ValueError("Image size needs to be divisible by patch size")
        self.patch_size = patch_size
        self.grid = (img_h // patch_size, img_w // patch_size)
        self.hidden_size = hidden_size
        self.hidden_dropout_prob = hidden_dropout_prob
        self.patch_drop_rate = patch_drop_rate
        self.include_cls_embed = include_cls_embed
        self.dtype = dtype
        num_patches = self.grid[0] * self.grid[1]
        self.conv_projection = nn.Conv2d(num_channels, hidden_size, patch_size,
                                         stride=patch_size)
        fan_in = num_channels * patch_size ** 2
        nn.init.trunc_normal_(self.conv_projection.weight, std=math.sqrt(1 / fan_in),
                              a=-2 * math.sqrt(1 / fan_in), b=2 * math.sqrt(1 / fan_in))
        nn.init.zeros_(self.conv_projection.bias)
        pos_seq = num_patches + 1 if include_cls_embed else num_patches
        self.position_embeddings = nn.Parameter(torch.zeros(1, pos_seq, hidden_size))
        self.mask_token = (nn.Parameter(torch.zeros(1, 1, hidden_size))
                           if use_image_masking else None)
        self.cls_token = (nn.Parameter(torch.zeros(1, 1, hidden_size))
                          if include_cls_embed else None)

    def forward(
        self,
        pixel_values: torch.Tensor,
        image_patches_mask: Optional[torch.Tensor] = None,
        deterministic: bool = True,
        generator: Optional[torch.Generator] = None,
        noise=None,
    ) -> PatchEmbeddingsOutput:
        """``noise``: the patch drop's noise, ``(b, n_patches)`` for a rate,
        a pair of ``(b, h)`` and ``(b, w)`` for a pair of rates; drawn from
        ``generator`` when None."""
        b, height, width, _ = pixel_values.shape
        if (height, width) != self.image_size:
            raise ValueError(f"Input image size ({height}x{width}) doesn't match configured "
                             f"({self.image_size[0]}x{self.image_size[1]})")
        dt = self.dtype or self.conv_projection.weight.dtype
        conv = self.conv_projection
        emb = F.conv2d(pixel_values.to(dt).permute(0, 3, 1, 2), conv.weight.to(dt),
                       conv.bias.to(dt), stride=self.patch_size)
        emb = emb.flatten(2).transpose(1, 2)  # (b, n_patches, hidden), row-major grid
        pos = self.position_embeddings.to(dt)
        if image_patches_mask is not None and self.mask_token is not None:
            # without a mask token the mask is ignored, as in the JAX module
            w = image_patches_mask.reshape(b, -1)[..., None].to(dt)
            emb = emb * (1 - w) + self.mask_token.to(dt) * w
        emb = emb + (pos[:, 1:] if self.include_cls_embed else pos)

        random_mask = ids_restore = None
        if not deterministic and self.patch_drop_rate is not None:
            if isinstance(self.patch_drop_rate, (tuple, list)):
                emb = random_masking_2d(emb, self.patch_drop_rate[0], self.patch_drop_rate[1],
                                        self.grid[0], self.grid[1], generator, noise)
            else:
                emb, random_mask, ids_restore, _ = random_masking(
                    emb, self.patch_drop_rate, generator, noise)

        if self.include_cls_embed:
            cls = (self.cls_token + self.position_embeddings[:, :1]).to(dt).expand(b, 1, -1)
            emb = torch.cat([cls, emb], dim=1)
        emb = F.dropout(emb, self.hidden_dropout_prob,
                        training=not deterministic and self.hidden_dropout_prob > 0)
        return PatchEmbeddingsOutput(emb, random_mask, ids_restore)

"""CLIP ViT image encoder. Counterpart of
``multimodal_tpu/models/clip/image_encoder.py``.

Bias-free conv patchify, CLS token, learned position embedding, fp32
``ln_pre`` / ``ln_post``, the pre-norm stack, CLS pooling and
``x @ projection``. The input is NHWC, as in the JAX package; the conv
permutes to NCHW internally. ``dtype`` is the compute dtype (None: the
weights' dtype); every weight but the LayerNorms' is cast to it at use.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from multimodal_tpu_torch.models.clip.transformer import CLIPTransformer
from multimodal_tpu_torch.modules.layers.normalizations import Fp32LayerNorm


class CLIPViTEncoder(nn.Module):
    def __init__(self, embedding_dim: int, patch_size: int, image_size: int,
                 width: int, heads: int, layers: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.image_size = image_size
        self.patch_size = patch_size
        n_patches = (image_size // patch_size) ** 2
        self.conv = nn.Conv2d(3, width, patch_size, stride=patch_size, bias=False)
        self.cls_token_embedding = nn.Parameter(torch.empty(width))
        self.positional_embedding = nn.Parameter(torch.empty(n_patches + 1, width))
        self.ln_pre = Fp32LayerNorm(width, eps=1e-5)
        self.encoder = CLIPTransformer(width, heads, layers)
        self.ln_post = Fp32LayerNorm(width, eps=1e-5)
        self.projection = nn.Parameter(torch.empty(width, embedding_dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (b, image_size, image_size, 3) NHWC."""
        b, hgt, wdt, c = x.shape
        if hgt != self.image_size or wdt != self.image_size:
            raise ValueError(
                f"Expected input height/width {self.image_size}, found {hgt}x{wdt}"
            )
        if c != 3:
            raise ValueError(f"Expected 3 channels, found {c}")
        dtype = self.dtype or self.conv.weight.dtype
        patches = F.conv2d(x.to(dtype).permute(0, 3, 1, 2), self.conv.weight.to(dtype),
                           stride=self.patch_size)
        patches = patches.flatten(2).transpose(1, 2)  # (b, n_patches, width)
        cls = self.cls_token_embedding.to(dtype).expand(b, 1, -1)
        h = torch.cat([cls, patches], dim=1) + self.positional_embedding.to(dtype)
        h = self.encoder(self.ln_pre(h))
        pooled = self.ln_post(h[:, 0, :])
        return pooled @ self.projection.to(dtype)

"""ALBEF vision encoder. Counterpart of
``multimodal_tpu/models/albef/image_encoder.py`` (``ALBEFVisionEncoder``):
the composable ViT (pre-norm blocks, exact GELU, a final LayerNorm), whose
last hidden state, after that LayerNorm, is the output."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from multimodal_tpu_torch.modules.encoders.vision_transformer import vision_transformer


class ALBEFVisionEncoder(nn.Module):
    """``dtype`` is the compute dtype (None: the weights')."""

    def __init__(self, image_size: int = 256, patch_size: int = 16,
                 num_hidden_layers: int = 12, num_attention_heads: int = 12,
                 hidden_size: int = 768, mlp_dim: int = 3072, dropout: float = 0.0,
                 attention_dropout: float = 0.0, layer_norm_eps: float = 1e-6,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.vit = vision_transformer(
            image_size=image_size, patch_size=patch_size, n_layer=num_hidden_layers,
            n_head=num_attention_heads, hidden_dim=hidden_size, dim_feedforward=mlp_dim,
            transformer_dropout=dropout, layer_norm_eps=layer_norm_eps,
            final_layer_norm_eps=layer_norm_eps, norm_first=True, dtype=dtype)

    def forward(self, x: torch.Tensor, deterministic: bool = True) -> torch.Tensor:
        """x: NHWC image -> (b, n_patches + 1, hidden) after the final LN."""
        return self.vit(x, deterministic=deterministic).last_hidden_state

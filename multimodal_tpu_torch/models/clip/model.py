"""CLIP: the two-encoder contrastive model and its ViT builders.

Counterpart of ``multimodal_tpu/models/clip/model.py``. The builders make a
model with random weights from a seed; weights from the JAX package load
through ``utils/checkpoint.py:clip_state_dict_from_jax``.

Numerics under a low-precision compute dtype ``dtype``: the LayerNorm
parameters stay in fp32; every other weight is held in ``param_dtype`` and
cast to ``dtype`` at each use, as the JAX layers do with their
``param_dtype`` and ``dtype``. ``param_dtype`` defaults to ``dtype``, which
is right for serving: the weights are cast once when built or loaded and
the casts at use are no-ops. Training keeps fp32 master weights with
``param_dtype=torch.float32, dtype=torch.bfloat16``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Union

import torch
from torch import nn

from multimodal_tpu_torch.models.clip.image_encoder import CLIPViTEncoder
from multimodal_tpu_torch.models.clip.text_encoder import CLIPTextEncoder
from multimodal_tpu_torch.models.clip.transformer import SelfAttentionProjections
from multimodal_tpu_torch.modules.layers.normalizations import Fp32LayerNorm
from multimodal_tpu_torch.utils.device import resolve_device


class CLIPOutput(NamedTuple):
    embeddings_a: torch.Tensor
    embeddings_b: torch.Tensor


def _l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    x32 = x.float()
    return (x32 / x32.norm(dim=-1, keepdim=True).clamp_min(eps)).to(x.dtype)


class CLIP(nn.Module):
    """Two-encoder contrastive wrapper: encode both, L2-normalize both."""

    def __init__(self, encoder_a: nn.Module, encoder_b: nn.Module):
        super().__init__()
        self.encoder_a = encoder_a
        self.encoder_b = encoder_b

    def forward(self, features_a: torch.Tensor, features_b: torch.Tensor) -> CLIPOutput:
        return CLIPOutput(self.encode_image(features_a), self.encode_text(features_b))

    def encode_image(self, images: torch.Tensor) -> torch.Tensor:
        return _l2_normalize(self.encoder_a(images))

    def encode_text(self, text: torch.Tensor) -> torch.Tensor:
        return _l2_normalize(self.encoder_b(text))


@torch.no_grad()
def init_parameters_(model: nn.Module, generator: torch.Generator) -> None:
    """Random weights with the JAX package's initial scales: fan-in scaled
    normal kernels, zero biases, unit LayerNorms, CLIP's embedding stds.
    Drawn on the CPU from ``generator``, so every device gets the same
    weights from one seed."""

    def normal_(p: torch.Tensor, std: float) -> None:
        p.copy_(torch.randn(p.shape, generator=generator) * std)

    for m in model.modules():
        if isinstance(m, Fp32LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, nn.Linear):
            normal_(m.weight, m.in_features ** -0.5)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, SelfAttentionProjections):
            normal_(m.in_proj_weight, m.in_proj_weight.shape[1] ** -0.5)
            m.in_proj_bias.zero_()
        elif isinstance(m, CLIPViTEncoder):
            normal_(m.conv.weight, m.conv.weight[0].numel() ** -0.5)
            std = m.projection.shape[0] ** -0.5
            normal_(m.cls_token_embedding, std)
            normal_(m.positional_embedding, std)
            normal_(m.projection, std)
        elif isinstance(m, CLIPTextEncoder):
            normal_(m.token_embedding.weight, m.TOKEN_EMBEDDING_INIT_STD)
            normal_(m.positional_embedding, m.POS_EMBEDDING_INIT_STD)


def to_param_dtype(model: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Cast every weight to ``dtype`` except the fp32 LayerNorms'."""
    model.to(dtype)
    for m in model.modules():
        if isinstance(m, Fp32LayerNorm):
            m.float()
    return model


Device = Optional[Union[str, torch.device]]
DType = Optional[torch.dtype]


def _clip_vit(vision: dict, text: dict, device: Device, dtype: torch.dtype, seed: int,
              param_dtype: DType) -> CLIP:
    dev = resolve_device(device)
    with torch.device(dev):
        model = CLIP(CLIPViTEncoder(**vision, dtype=dtype),
                     CLIPTextEncoder(**text, dtype=dtype))
    if dev.type != "meta":
        init_parameters_(model, torch.Generator().manual_seed(seed))
    return to_param_dtype(model, param_dtype or dtype).eval()


def clip_vit_b16(device: Device = None, dtype: torch.dtype = torch.bfloat16, seed: int = 0,
                 param_dtype: DType = None) -> CLIP:
    return _clip_vit(dict(image_size=224, patch_size=16, layers=12, heads=12, width=768, embedding_dim=512), dict(embedding_dim=512), device, dtype, seed, param_dtype)


def clip_vit_b32(device: Device = None, dtype: torch.dtype = torch.bfloat16, seed: int = 0,
                 param_dtype: DType = None) -> CLIP:
    return _clip_vit(dict(image_size=224, patch_size=32, layers=12, heads=12, width=768, embedding_dim=512), dict(embedding_dim=512), device, dtype, seed, param_dtype)


def clip_vit_l14(device: Device = None, dtype: torch.dtype = torch.bfloat16, seed: int = 0,
                 param_dtype: DType = None) -> CLIP:
    return _clip_vit(dict(image_size=224, patch_size=14, layers=24, heads=16, width=1024, embedding_dim=768), dict(embedding_dim=768, width=768, dim_feedforward=3072, heads=12), device, dtype, seed, param_dtype)

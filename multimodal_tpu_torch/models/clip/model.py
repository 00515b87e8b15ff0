"""CLIP: the two-encoder contrastive model and its ViT builders.

Counterpart of ``multimodal_tpu/models/clip/model.py``: the ViT builders
and the ResNet ones (``clip_rn50`` ... ``clip_rn50x64``, image tower in
``resnet_encoder.py``). The builders make a model with random weights from a
seed; weights from the JAX package load through
``utils/checkpoint.py:clip_state_dict_from_jax`` (ViT) and
``clip_resnet_state_dict_from_jax`` (ResNet).

Numerics under a low-precision compute dtype ``dtype``: the LayerNorm
parameters stay in fp32; every other weight is held in ``param_dtype`` and
cast to ``dtype`` at each use, as the JAX layers do with their
``param_dtype`` and ``dtype``. ``param_dtype`` defaults to ``dtype``, which
is right for serving: the weights are cast once when built or loaded and
the casts at use are no-ops. Training keeps fp32 master weights with
``param_dtype=torch.float32, dtype=torch.bfloat16``. BatchNorm's running
statistics stay fp32, as flax keeps its ``batch_stats``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Union

import torch
from torch import nn

from multimodal_tpu_torch.models.clip.image_encoder import CLIPViTEncoder
from multimodal_tpu_torch.models.clip.resnet_encoder import (
    AttentionPool2d,
    Fp32BatchNorm2d,
    ResNetForCLIP,
    ResNetForCLIPBottleneck,
)
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
    normal kernels, zero biases, unit LayerNorms, CLIP's embedding stds;
    in the ResNet tower unit BatchNorms (running mean 0, variance 1) but for
    each bottleneck's bn3, whose scale starts at 0, and the attention pool's
    position embedding at std ``embed_dim ** -0.5`` and projections at
    ``(output_dim or embed_dim) ** -0.5``. Drawn on the CPU from
    ``generator``, so every device gets the same weights from one seed."""

    def normal_(p: torch.Tensor, std: float) -> None:
        p.copy_(torch.randn(p.shape, generator=generator) * std)

    pool_std = {proj: pool.c_proj.out_features ** -0.5 for pool in model.modules()
                if isinstance(pool, AttentionPool2d)
                for proj in (pool.q_proj, pool.k_proj, pool.v_proj, pool.c_proj)}
    for m in model.modules():
        if isinstance(m, (Fp32LayerNorm, Fp32BatchNorm2d)):
            m.weight.fill_(1.0)
            m.bias.zero_()
            if isinstance(m, Fp32BatchNorm2d):
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
        elif isinstance(m, nn.Linear):
            normal_(m.weight, pool_std.get(m, m.in_features ** -0.5))
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
    # the ResNet tower's convolutions, zero bn3 scales and position embedding
    resnets = [m for m in model.modules() if isinstance(m, ResNetForCLIP)]
    for m in (sub for r in resnets for sub in r.modules()):
        if isinstance(m, nn.Conv2d):
            normal_(m.weight, m.weight[0].numel() ** -0.5)
        elif isinstance(m, ResNetForCLIPBottleneck):
            m.bn3.weight.zero_()
        elif isinstance(m, AttentionPool2d):
            normal_(m.positional_embedding, m.positional_embedding.shape[1] ** -0.5)


def to_param_dtype(model: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Cast every weight to ``dtype`` except the fp32 LayerNorms' and the
    BatchNorms' running statistics."""
    model.to(dtype)
    for m in model.modules():
        if isinstance(m, Fp32LayerNorm):
            m.float()
        elif isinstance(m, Fp32BatchNorm2d):
            m.running_mean.data = m.running_mean.float()
            m.running_var.data = m.running_var.float()
    return model


Device = Optional[Union[str, torch.device]]
DType = Optional[torch.dtype]


def _build(image_encoder, text: dict, device: Device, dtype: torch.dtype, seed: int,
           param_dtype: DType) -> CLIP:
    """``image_encoder(dtype)`` and a ``CLIPTextEncoder(**text)`` on
    ``device``, random weights from ``seed`` (none on ``meta``)."""
    dev = resolve_device(device)
    with torch.device(dev):
        model = CLIP(image_encoder(dtype), CLIPTextEncoder(**text, dtype=dtype))
    if dev.type != "meta":
        init_parameters_(model, torch.Generator().manual_seed(seed))
    return to_param_dtype(model, param_dtype or dtype).eval()


def _clip_vit(vision: dict, text: dict, device: Device, dtype: torch.dtype, seed: int,
              param_dtype: DType) -> CLIP:
    return _build(lambda dt: CLIPViTEncoder(**vision, dtype=dt), text, device, dtype, seed,
                  param_dtype)


def _clip_resnet(layers, output_dim: int, heads: int, width: int, text: dict,
                 input_resolution: int, device: Device, dtype: torch.dtype, seed: int,
                 param_dtype: DType) -> CLIP:
    """A ResNet image tower (its convolution weights ``channels_last``, as
    its activations are) beside a CLIP text tower."""
    model = _build(lambda dt: ResNetForCLIP(layers, output_dim, heads, input_resolution,
                                            width, dtype=dt),
                   text, device, dtype, seed, param_dtype)
    model.encoder_a.to(memory_format=torch.channels_last)
    return model


def clip_vit_b16(device: Device = None, dtype: torch.dtype = torch.bfloat16, seed: int = 0,
                 param_dtype: DType = None) -> CLIP:
    return _clip_vit(dict(image_size=224, patch_size=16, layers=12, heads=12, width=768, embedding_dim=512), dict(embedding_dim=512), device, dtype, seed, param_dtype)


def clip_vit_b32(device: Device = None, dtype: torch.dtype = torch.bfloat16, seed: int = 0,
                 param_dtype: DType = None) -> CLIP:
    return _clip_vit(dict(image_size=224, patch_size=32, layers=12, heads=12, width=768, embedding_dim=512), dict(embedding_dim=512), device, dtype, seed, param_dtype)


def clip_vit_l14(device: Device = None, dtype: torch.dtype = torch.bfloat16, seed: int = 0,
                 param_dtype: DType = None) -> CLIP:
    return _clip_vit(dict(image_size=224, patch_size=14, layers=24, heads=16, width=1024, embedding_dim=768), dict(embedding_dim=768, width=768, dim_feedforward=3072, heads=12), device, dtype, seed, param_dtype)


def clip_rn50(device: Device = None, dtype: torch.dtype = torch.bfloat16, seed: int = 0,
              param_dtype: DType = None) -> CLIP:
    return _clip_resnet((3, 4, 6, 3), 1024, 32, 64, dict(embedding_dim=1024), 224, device, dtype, seed, param_dtype)


def clip_rn101(device: Device = None, dtype: torch.dtype = torch.bfloat16, seed: int = 0,
               param_dtype: DType = None) -> CLIP:
    return _clip_resnet((3, 4, 23, 3), 512, 32, 64, dict(embedding_dim=512), 224, device, dtype, seed, param_dtype)


def clip_rn50x4(device: Device = None, dtype: torch.dtype = torch.bfloat16, seed: int = 0,
                param_dtype: DType = None) -> CLIP:
    return _clip_resnet((4, 6, 10, 6), 640, 40, 80, dict(embedding_dim=640, width=640, dim_feedforward=2560, heads=10), 288, device, dtype, seed, param_dtype)


def clip_rn50x16(device: Device = None, dtype: torch.dtype = torch.bfloat16, seed: int = 0,
                 param_dtype: DType = None) -> CLIP:
    return _clip_resnet((6, 8, 18, 8), 768, 48, 96, dict(embedding_dim=768, width=768, dim_feedforward=3072, heads=12), 384, device, dtype, seed, param_dtype)


def clip_rn50x64(device: Device = None, dtype: torch.dtype = torch.bfloat16, seed: int = 0,
                 param_dtype: DType = None) -> CLIP:
    return _clip_resnet((3, 15, 36, 10), 1024, 64, 128, dict(embedding_dim=1024, width=1024, dim_feedforward=4096, heads=16), 448, device, dtype, seed, param_dtype)

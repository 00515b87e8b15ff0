"""MDETR image backbone: ResNet-101 with frozen BatchNorm, and the sine
position embedding. Counterpart of ``multimodal_tpu/models/mdetr/
image_encoder.py``.

Images come in NHWC, as in the JAX package; the trunk runs on their NCHW
view, which is ``channels_last`` in memory (cuDNN's convolutions read NHWC
as XLA's do). Each convolution casts its input to the compute dtype
``dtype``; the frozen BatchNorms compute in fp32 and, as in the JAX
modules, promote: the residual stream and the features are fp32. The
padding mask goes to the feature grid by ``jax.image.resize``'s
``nearest``, which samples at half-pixel centres: PyTorch's
``nearest-exact``. Names follow the JAX modules'.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn
from torch.nn import functional as F


class FrozenBatchNorm2d(nn.Module):
    """BatchNorm with fixed statistics and affine parameters, all buffers
    (never trained), over dim 1; fp32 arithmetic, promoting ``x``."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.register_buffer("weight", torch.ones(features))
        self.register_buffer("bias", torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        scale = self.weight * torch.rsqrt(self.running_var + self.eps)
        shift = self.bias - self.running_mean * scale
        return x * scale[:, None, None] + shift[:, None, None]


def _conv(conv: nn.Conv2d, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``conv`` on ``x`` in ``dtype``, its weights cast at use."""
    return F.conv2d(x.to(dtype), conv.weight.to(dtype),
                    None if conv.bias is None else conv.bias.to(dtype),
                    conv.stride, conv.padding)


class Bottleneck(nn.Module):
    def __init__(self, inplanes: int, planes: int, stride: int = 1, downsample: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        out_ch = planes * 4
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = FrozenBatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride, 1, bias=False)
        self.bn2 = FrozenBatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, out_ch, 1, bias=False)
        self.bn3 = FrozenBatchNorm2d(out_ch)
        self.downsample_conv = self.downsample_bn = None
        if downsample:
            self.downsample_conv = nn.Conv2d(inplanes, out_ch, 1, stride, bias=False)
            self.downsample_bn = FrozenBatchNorm2d(out_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        h = F.relu(self.bn1(_conv(self.conv1, x, dt)))
        h = F.relu(self.bn2(_conv(self.conv2, h, dt)))
        h = self.bn3(_conv(self.conv3, h, dt))
        if self.downsample_conv is not None:
            x = self.downsample_bn(_conv(self.downsample_conv, x, dt))
        return F.relu(x + h)


class ResNetBackbone(nn.Module):
    """The ResNet trunk up to layer4 (no pooling), frozen BatchNorm
    everywhere: ``(b, 3, H, W)`` -> ``(b, 2048, H/32, W/32)`` (for the
    default width), fp32."""

    def __init__(self, layers: Sequence[int] = (3, 4, 23, 3), width: int = 64,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv1 = nn.Conv2d(3, width, 7, 2, 3, bias=False)
        self.bn1 = FrozenBatchNorm2d(width)
        self.block_names = []
        planes, inplanes = width, width
        for li, blocks in enumerate(layers):
            stride = 1 if li == 0 else 2
            for bi in range(blocks):
                name = f"layer{li + 1}_{bi}"
                self.add_module(name, Bottleneck(inplanes, planes, stride if bi == 0 else 1,
                                                 bi == 0, dtype))
                self.block_names.append(name)
                inplanes = planes * 4
            planes *= 2
        self.out_channels = inplanes

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.bn1(_conv(self.conv1, x, self.dtype)))
        h = F.max_pool2d(h, 3, 2, 1)
        for name in self.block_names:
            h = getattr(self, name)(h)
        return h


def resize_mask_nearest(mask: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """A ``(b, H, W)`` boolean mask at ``size`` by ``jax.image.resize``'s
    ``nearest`` (half-pixel centres: source ``floor((i + 0.5) * H / h)``)."""
    return F.interpolate(mask[:, None].float(), size=size, mode="nearest-exact")[:, 0].bool()


class MaskedIntermediateLayer(nn.Module):
    """Backbone features and the padding mask resized to their grid."""

    def __init__(self, backbone: ResNetBackbone):
        super().__init__()
        self.backbone = backbone

    def forward(self, images: torch.Tensor, image_mask: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """images ``(b, H, W, 3)``, image_mask ``(b, H, W)`` (True = padded)
        -> features ``(b, h, w, C)`` (an NHWC view) and the mask ``(b, h,
        w)``."""
        x = images.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        feats = self.backbone(x)
        mask = resize_mask_nearest(image_mask, tuple(feats.shape[2:]))
        return feats.permute(0, 2, 3, 1), mask


def position_embedding_2d(mask: torch.Tensor, num_pos_feats: int = 128,
                          temperature: int = 10000, scale: Optional[float] = None
                          ) -> torch.Tensor:
    """Sine 2-D position embeddings of a padding mask ``(b, h, w)`` (True
    = padded) -> ``(b, h, w, 2 * num_pos_feats)``, fp32."""
    not_mask = (~mask).float()
    y_embed = torch.cumsum(not_mask, dim=1)
    x_embed = torch.cumsum(not_mask, dim=2)
    if scale is not None:
        eps = 1e-6
        y_embed = y_embed / (y_embed[:, -1:, :] + eps) * scale
        x_embed = x_embed / (x_embed[:, :, -1:] + eps) * scale
    dim_t = torch.arange(num_pos_feats, dtype=torch.float32, device=mask.device)
    dim_t = temperature ** (2 * torch.div(dim_t, 2, rounding_mode="floor") / num_pos_feats)
    pos_x = x_embed[..., None] / dim_t
    pos_y = y_embed[..., None] / dim_t
    pos_x = torch.stack([pos_x[..., 0::2].sin(), pos_x[..., 1::2].cos()], dim=-1).flatten(3)
    pos_y = torch.stack([pos_y[..., 0::2].sin(), pos_y[..., 1::2].cos()], dim=-1).flatten(3)
    return torch.cat([pos_y, pos_x], dim=-1)


def mdetr_resnet101_backbone(dtype: torch.dtype = torch.float32) -> MaskedIntermediateLayer:
    return MaskedIntermediateLayer(ResNetBackbone(layers=(3, 4, 23, 3), dtype=dtype))

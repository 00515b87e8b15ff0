"""CLIP's modified ResNet image encoder. Counterpart of
``multimodal_tpu/models/clip/resnet_encoder.py``.

A 3-conv stem with an average pool, bottlenecks whose stride is an average
pool before conv3 and on the identity path (anti-aliased), and an attention
pool whose query token is the mean of the positions. Input and output are
NHWC as in the JAX package; inside, the tensors are NCHW in the
``channels_last`` layout (NHWC in memory), where the convolutions and pools
run in PyTorch (XLA's in the JAX package: no TPU kernel). The attention
pool's attention goes through ``ops/attention.py``, which takes kernel #6
(``ops/flash_attention.py``) from ``FLASH_MIN_SEQ`` positions: every
``clip_rn*`` pools 50 to 197 of them at head width 64.

BatchNorm computes in fp32 and casts back to the compute dtype, as the JAX
blocks do. Eval uses the running statistics; train mode normalises with
the batch's (the biased variance, E[x^2] - E[x]^2, as flax's) and moves
the running ones by 0.1 (flax's momentum 0.9). ``dtype`` is the compute
dtype (None: the weights'); every weight is cast to it at use.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from multimodal_tpu_torch.ops.attention import scaled_dot_product_attention

EXPANSION = 4


class Fp32BatchNorm2d(nn.Module):
    """BatchNorm over dim 1 of an ``(N, C, ...)`` tensor (NCHW here), in
    fp32, with flax's numerics: in training the batch variance is ``E[x^2]
    - E[x]^2`` (biased), differentiated through, and the running statistics
    move toward it by ``momentum``. The running statistics stay fp32
    whatever the parameters' dtype."""

    def __init__(self, channels: int, eps: float = 1e-5, momentum: float = 0.1):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.normalize(x, batch_statistics=self.training)

    def normalize(self, x: torch.Tensor, batch_statistics: bool) -> torch.Tensor:
        w, b = self.weight.float(), self.bias.float()
        if not batch_statistics:
            # x in the compute dtype with fp32 statistics and parameters:
            # computed in fp32, rounded once to x's dtype, in one pass
            return F.batch_norm(x, self.running_mean, self.running_var, w, b,
                                training=False, eps=self.eps)
        x32 = x.float()
        dims = (0, *range(2, x.dim()))
        mean = x32.mean(dim=dims)
        var = ((x32 * x32).mean(dim=dims) - mean * mean).clamp_min(0.0)
        with torch.no_grad():
            self.running_mean.lerp_(mean.detach(), self.momentum)
            self.running_var.lerp_(var.detach(), self.momentum)
        shape = (-1,) + (1,) * (x.dim() - 2)
        mul = torch.rsqrt(var + self.eps) * w
        y = (x32 - mean.view(shape)) * mul.view(shape) + b.view(shape)
        return y.to(x.dtype)


def _conv(x: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
    return F.conv2d(x, conv.weight.to(x.dtype), None, conv.stride, conv.padding)


class ResNetForCLIPBottleneck(nn.Module):
    def __init__(self, inplanes: int, planes: int, stride: int = 1):
        super().__init__()
        self.stride = stride
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = Fp32BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1, bias=False)
        self.bn2 = Fp32BatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, planes * EXPANSION, 1, bias=False)
        self.bn3 = Fp32BatchNorm2d(planes * EXPANSION)
        self.downsample_conv = self.downsample_bn = None
        if stride > 1 or inplanes != planes * EXPANSION:
            self.downsample_conv = nn.Conv2d(inplanes, planes * EXPANSION, 1, bias=False)
            self.downsample_bn = Fp32BatchNorm2d(planes * EXPANSION)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(_conv(x, self.conv1)))
        out = F.relu(self.bn2(_conv(out, self.conv2)))
        if self.stride > 1:
            out = F.avg_pool2d(out, self.stride)
        out = self.bn3(_conv(out, self.conv3))
        identity = x
        if self.downsample_conv is not None:
            if self.stride > 1:
                identity = F.avg_pool2d(identity, self.stride)
            identity = self.downsample_bn(_conv(identity, self.downsample_conv))
        return F.relu(out + identity)


class AttentionPool2d(nn.Module):
    """QKV attention over the mean token and the ``h*w`` positions, plus a
    learned position embedding; the mean token's output, projected."""

    def __init__(self, spacial_dim: int, embed_dim: int, num_heads: int,
                 output_dim: Optional[int] = None):
        super().__init__()
        self.num_heads = num_heads
        self.positional_embedding = nn.Parameter(torch.empty(spacial_dim ** 2 + 1, embed_dim))
        self.q_proj = nn.Linear(embed_dim, embed_dim)
        self.k_proj = nn.Linear(embed_dim, embed_dim)
        self.v_proj = nn.Linear(embed_dim, embed_dim)
        self.c_proj = nn.Linear(embed_dim, output_dim or embed_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (b, c, h, w) -> (b, output_dim)."""
        b, c = x.shape[:2]
        tokens = x.permute(0, 2, 3, 1).reshape(b, -1, c)  # positions in (h, w) order
        tokens = torch.cat([tokens.mean(dim=1, keepdim=True), tokens], dim=1)
        tokens = tokens + self.positional_embedding.to(tokens.dtype)

        def heads(proj: nn.Linear) -> torch.Tensor:
            t = F.linear(tokens, proj.weight.to(tokens.dtype), proj.bias.to(tokens.dtype))
            return t.view(b, -1, self.num_heads, c // self.num_heads).transpose(1, 2)

        attn = scaled_dot_product_attention(heads(self.q_proj), heads(self.k_proj),
                                            heads(self.v_proj))
        attn = attn.transpose(1, 2).reshape(b, -1, c)
        out = F.linear(attn, self.c_proj.weight.to(attn.dtype), self.c_proj.bias.to(attn.dtype))
        return out[:, 0]


class ResNetForCLIP(nn.Module):
    def __init__(self, layers: Tuple[int, int, int, int] = (3, 4, 6, 3), output_dim: int = 512,
                 heads: int = 1024, input_resolution: int = 224, width: int = 64,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.input_resolution = input_resolution
        self.conv1 = nn.Conv2d(3, width // 2, 3, stride=2, padding=1, bias=False)
        self.bn1 = Fp32BatchNorm2d(width // 2)
        self.conv2 = nn.Conv2d(width // 2, width // 2, 3, padding=1, bias=False)
        self.bn2 = Fp32BatchNorm2d(width // 2)
        self.conv3 = nn.Conv2d(width // 2, width, 3, padding=1, bias=False)
        self.bn3 = Fp32BatchNorm2d(width)
        inplanes = width
        self.block_names = []  # the bottlenecks in order, named as in the JAX tree
        for li, n_blocks in enumerate(layers):
            planes = width * 2 ** li
            for bi in range(n_blocks):
                name = f"layer{li + 1}_{bi}"
                self.add_module(name, ResNetForCLIPBottleneck(
                    inplanes, planes, stride=2 if (bi == 0 and li > 0) else 1))
                self.block_names.append(name)
                inplanes = planes * EXPANSION
        self.attnpool = AttentionPool2d(input_resolution // 32, width * 32, heads, output_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (b, h, w, 3) NHWC -> (b, output_dim)."""
        dtype = self.dtype or self.conv1.weight.dtype
        h = x.to(dtype).permute(0, 3, 1, 2)  # NCHW view of NHWC memory: channels_last
        for conv, bn in ((self.conv1, self.bn1), (self.conv2, self.bn2), (self.conv3, self.bn3)):
            h = F.relu(bn(_conv(h, conv)))
        h = F.avg_pool2d(h, 2)
        for name in self.block_names:
            h = getattr(self, name)(h)
        return self.attnpool(h)

"""MUGEN retrieval: VideoCLIP (S3D video tower + BERT text tower).
Counterpart of ``multimodal_tpu/examples/mugen/video_clip.py``.

S3D with separable 3-D convolutions and inception blocks, a DistilBERT-
config text encoder, 256-d projection heads, in the CLIP wrapper. The
video comes in as ``(b, T, H, W, 3)``, as in the JAX package; the trunk
runs on its ``(b, 3, T, H, W)`` view, which is ``channels_last_3d`` in
memory, so cuDNN's convolutions read NDHWC as XLA's do. Module and
parameter names are the JAX modules' (``utils/checkpoint.py:
videoclip_state_dict_from_jax`` maps by path).

The numerics follow flax, not ``torch.nn``:

- ``BatchNorm`` (:class:`FlaxBatchNorm`, on the CLIP ResNet's
  ``Fp32BatchNorm2d``): flax's ``momentum=0.9`` is PyTorch's 0.1; flax's
  batch variance is ``E[x^2] - E[x]^2``, biased (``F.batch_norm`` moves
  the running variance toward the unbiased one, and centres before it
  squares), so the statistics are computed as flax computes them;
  statistics and normalization in fp32. Like the JAX modules, the
  ``deterministic`` argument, not ``module.training``, picks running or
  batch statistics.
- ``padding="SAME"`` max-pools pad asymmetrically at stride 2 (low side
  ``total // 2``), with -inf (:func:`same_max_pool3d`).
- ``jax.nn.gelu`` is the tanh form.

Convolution and dense weights are held in their parameter dtype and cast
at use to the compute dtype, the video's after ``VideoEncoder`` casts it
to ``dtype``.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from multimodal_tpu_torch.models.clip.model import CLIP
from multimodal_tpu_torch.models.clip.resnet_encoder import Fp32BatchNorm2d
from multimodal_tpu_torch.modules.encoders.bert_text_encoder import bert_text_encoder
from multimodal_tpu_torch.modules.layers.normalizations import Fp32LayerNorm


class FlaxBatchNorm(Fp32BatchNorm2d):
    """flax ``nn.BatchNorm`` at S3D's settings (eps 1e-3, flax's momentum
    0.9, which is PyTorch's 0.1) over an ``(N, C, T, H, W)`` tensor; the
    ``deterministic`` argument, not ``module.training``, picks the running
    or the batch statistics, as in the JAX modules."""

    def __init__(self, channels: int):
        super().__init__(channels, eps=1e-3, momentum=0.1)

    def forward(self, x: torch.Tensor, deterministic: bool = True) -> torch.Tensor:
        return self.normalize(x, batch_statistics=not deterministic)


def same_pads(size: int, window: int, stride: int) -> Tuple[int, int]:
    """``padding="SAME"``'s (low, high) padding of one axis, as
    ``lax.padtype_to_pads`` computes it."""
    out = -(-size // stride)
    total = max((out - 1) * stride + window - size, 0)
    return total // 2, total - total // 2


def same_max_pool3d(x: torch.Tensor, window: Sequence[int], strides: Sequence[int]
                    ) -> torch.Tensor:
    """flax ``nn.max_pool(padding="SAME")`` on an ``(N, C, T, H, W)``
    tensor: padded with -inf, at stride 2 more on the high side."""
    pads = [same_pads(s, k, st) for s, k, st in zip(x.shape[2:], window, strides)]
    if all(lo == hi and lo <= k // 2 for (lo, hi), k in zip(pads, window)):
        return F.max_pool3d(x, window, strides, padding=[lo for lo, _ in pads])
    flat = [p for lo_hi in reversed(pads) for p in lo_hi]  # F.pad: last dim first
    return F.max_pool3d(F.pad(x, flat, value=-math.inf), window, strides)


def _conv(x: torch.Tensor, conv: nn.Conv3d) -> torch.Tensor:
    return F.conv3d(x, conv.weight.to(x.dtype), None, conv.stride, conv.padding)


class SepConv3d(nn.Module):
    """Separable 3-D conv: spatial (1, k, k) then temporal (k, 1, 1)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 stride: Tuple[int, int, int] = (1, 1, 1)):
        super().__init__()
        k = kernel_size
        st, sh, sw = stride
        self.conv_s = nn.Conv3d(in_channels, out_channels, (1, k, k), (1, sh, sw),
                                (0, k // 2, k // 2), bias=False)
        self.bn_s = FlaxBatchNorm(out_channels)
        self.conv_t = nn.Conv3d(out_channels, out_channels, (k, 1, 1), (st, 1, 1),
                                (k // 2, 0, 0), bias=False)
        self.bn_t = FlaxBatchNorm(out_channels)

    def forward(self, x: torch.Tensor, deterministic: bool = True) -> torch.Tensor:
        h = F.relu(self.bn_s(_conv(x, self.conv_s), deterministic))
        return F.relu(self.bn_t(_conv(h, self.conv_t), deterministic))


class BasicConv3d(nn.Module):
    """A pointwise conv (every use in S3D is 1 x 1 x 1), BatchNorm, ReLU."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv = nn.Conv3d(in_channels, out_channels, 1, bias=False)
        self.bn = FlaxBatchNorm(out_channels)

    def forward(self, x: torch.Tensor, deterministic: bool = True) -> torch.Tensor:
        return F.relu(self.bn(_conv(x, self.conv), deterministic))


class InceptionBlock3d(nn.Module):
    """S3D inception block: 1x1 | 1x1 -> sep3 | 1x1 -> sep3 | pool -> 1x1."""

    def __init__(self, in_channels: int, b0: int, b1a: int, b1b: int, b2a: int, b2b: int,
                 b3: int):
        super().__init__()
        self.branch0 = BasicConv3d(in_channels, b0)
        self.branch1a = BasicConv3d(in_channels, b1a)
        self.branch1b = SepConv3d(b1a, b1b, 3)
        self.branch2a = BasicConv3d(in_channels, b2a)
        self.branch2b = SepConv3d(b2a, b2b, 3)
        self.branch3 = BasicConv3d(in_channels, b3)
        self.out_channels = b0 + b1b + b2b + b3

    def forward(self, x: torch.Tensor, deterministic: bool = True) -> torch.Tensor:
        p0 = self.branch0(x, deterministic)
        p1 = self.branch1b(self.branch1a(x, deterministic), deterministic)
        p2 = self.branch2b(self.branch2a(x, deterministic), deterministic)
        p3 = self.branch3(same_max_pool3d(x, (3, 3, 3), (1, 1, 1)), deterministic)
        return torch.cat([p0, p1, p2, p3], dim=1)


# (name, b0, b1a, b1b, b2a, b2b, b3) of the JAX S3D's inception blocks
_MIXED = (("mixed3b", 64, 96, 128, 16, 32, 32), ("mixed3c", 128, 128, 192, 32, 96, 64),
          ("mixed4b", 192, 96, 208, 16, 48, 64), ("mixed4c", 160, 112, 224, 24, 64, 64),
          ("mixed4d", 128, 128, 256, 24, 64, 64), ("mixed4e", 112, 144, 288, 32, 64, 64),
          ("mixed4f", 256, 160, 320, 32, 128, 128), ("mixed5b", 256, 160, 320, 32, 128, 128),
          ("mixed5c", 384, 192, 384, 48, 128, 128))
# the max-pools (window, strides) before these blocks
_POOL_BEFORE = {"mixed4b": ((3, 3, 3), (2, 2, 2)), "mixed5b": ((2, 2, 2), (2, 2, 2))}


class S3D(nn.Module):
    """The compact S3D trunk (Xie et al. 2018), global average pooled."""

    def __init__(self):
        super().__init__()
        self.stem = SepConv3d(3, 64, 7, stride=(2, 2, 2))
        self.conv2a = BasicConv3d(64, 64)
        self.conv2b = SepConv3d(64, 192, 3)
        width = 192
        for name, *branches in _MIXED:
            block = InceptionBlock3d(width, *branches)
            self.add_module(name, block)
            width = block.out_channels

    def forward(self, x: torch.Tensor, deterministic: bool = True) -> torch.Tensor:
        """x: (b, T, H, W, 3) -> (b, 1024)."""
        h = x.permute(0, 4, 1, 2, 3)  # channels_last_3d when x is contiguous
        h = self.stem(h, deterministic)
        h = same_max_pool3d(h, (1, 3, 3), (1, 2, 2))
        h = self.conv2b(self.conv2a(h, deterministic), deterministic)
        h = same_max_pool3d(h, (1, 3, 3), (1, 2, 2))
        for name, *_ in _MIXED:
            if name in _POOL_BEFORE:
                h = same_max_pool3d(h, *_POOL_BEFORE[name])
            h = getattr(self, name)(h, deterministic)
        return h.mean(dim=(2, 3, 4))


class Projection(nn.Module):
    """Two dense layers with a residual and a LayerNorm."""

    def __init__(self, in_dim: int, out_dim: int = 256, dropout: float = 0.1):
        super().__init__()
        self.dropout = dropout
        self.linear1 = nn.Linear(in_dim, out_dim, bias=False)
        self.linear2 = nn.Linear(out_dim, out_dim, bias=False)
        self.ln = Fp32LayerNorm(out_dim, eps=1e-5)

    def forward(self, x: torch.Tensor, deterministic: bool = True) -> torch.Tensor:
        dt = x.dtype
        projected = F.linear(x, self.linear1.weight.to(dt))
        h = F.linear(F.gelu(projected, approximate="tanh"), self.linear2.weight.to(dt))
        h = F.dropout(h, self.dropout, training=not deterministic and self.dropout > 0)
        return self.ln(h + projected)


class VideoEncoder(nn.Module):
    """S3D + projection; the video is cast to ``dtype`` (the compute dtype)
    on the way in."""

    def __init__(self, proj_out: int = 256, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.s3d = S3D()
        self.projection = Projection(1024, proj_out)

    def forward(self, video: torch.Tensor, deterministic: bool = True) -> torch.Tensor:
        if self.dtype is not None:
            video = video.to(self.dtype)
        return self.projection(self.s3d(video.contiguous(), deterministic), deterministic)


class TextEncoder(nn.Module):
    """DistilBERT-config text tower (6 x 768, 12 heads) + projection of the
    first token."""

    def __init__(self, proj_out: int = 256, vocab_size: int = 30522,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.encoder = bert_text_encoder(
            hidden_size=768, num_hidden_layers=6, num_attention_heads=12,
            intermediate_size=3072, vocab_size=vocab_size, dtype=dtype)
        self.projection = Projection(self.encoder.embeddings.word_embeddings.embedding_dim,
                                     proj_out)

    def forward(self, input_ids: torch.Tensor, deterministic: bool = True) -> torch.Tensor:
        out = self.encoder(input_ids=input_ids, deterministic=deterministic)
        return self.projection(out.last_hidden_state[:, 0], deterministic)


def videoclip(video_proj_out: int = 256, text_proj_out: int = 256, vocab_size: int = 30522,
              dtype: Optional[torch.dtype] = None) -> CLIP:
    """S3D-video x BERT-text CLIP (``encoder_a`` video, ``encoder_b``
    text), with PyTorch's initial weights; ``examples/mugen/
    retrieval_train.py`` builds the recipe's model from a seed
    (``utils/init.py``)."""
    return CLIP(VideoEncoder(video_proj_out, dtype),
                TextEncoder(text_proj_out, vocab_size, dtype))

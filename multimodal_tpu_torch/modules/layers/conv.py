"""TF-style "SAME" padded 3-D convolutions. Counterpart of
``multimodal_tpu/modules/layers/conv.py``.

The modules take and return channel-last ``(b, t, h, w, c)`` tensors, as
the JAX modules do; the convolution runs on the ``(b, c, t, h, w)`` view,
which is ``channels_last_3d`` in memory, so cuDNN reads NDHWC as XLA does.
``SamePadConv3d`` pads each axis as TF's SAME does (the odd cell on the
trailing side) and convolves VALID; ``SamePadConvTranspose3d`` runs the
VALID transposed convolution and crops its output to ``input * stride``,
the excess split with the odd cell at the end. Weights are held in their
parameter dtype and cast at use to the dtype of ``x``.

flax's ``ConvTranspose`` does not flip its kernel (``transpose_kernel=
False``) and its VALID output is ``d * s + max(k - s, 0)`` long:
``utils/checkpoint.py:conv_transpose3d_weight_from_jax`` flips the kernel
into ``nn.ConvTranspose3d``'s layout, and ``output_padding`` makes up the
``max(s - k, 0)`` rows where the kernel is shorter than the stride.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch
from torch import nn
from torch.nn import functional as F

from multimodal_tpu_torch.utils.common import to_tuple_tuple

__all__ = [
    "SamePadConv3d",
    "SamePadConvTranspose3d",
    "calculate_same_padding",
    "calculate_transpose_padding",
    "to_tuple_tuple",
]


def _to_tuple(v: Union[int, Tuple[int, ...]], n: int) -> Tuple[int, ...]:
    return (v,) * n if isinstance(v, int) else tuple(v)


def calculate_same_padding(
    kernel_size: Union[int, Tuple[int, ...]],
    stride: Union[int, Tuple[int, ...]],
    input_shape: Tuple[int, ...],
) -> Tuple[Tuple[int, int], ...]:
    """Per-axis (before, after) padding of TF's SAME over the spatial sizes
    ``input_shape``: ``max(k - (d % s or s), 0)`` in all, the odd cell
    after."""
    n = len(input_shape)
    kernel_size = _to_tuple(kernel_size, n)
    stride = _to_tuple(stride, n)
    pads = []
    for d, k, s in zip(input_shape, kernel_size, stride):
        total = max(k - s, 0) if d % s == 0 else max(k - d % s, 0)
        pads.append((total // 2, total - total // 2))
    return tuple(pads)


def calculate_transpose_padding(
    kernel_size: Union[int, Tuple[int, ...]],
    stride: Union[int, Tuple[int, ...]],
    input_shape: Tuple[int, ...],
    input_pad: Tuple[Tuple[int, int], ...],
) -> Tuple[Tuple[int, int], ...]:
    """Crop amounts of a transposed convolution whose output should be
    ``input * stride`` (SAME)."""
    n = len(input_shape)
    kernel_size = _to_tuple(kernel_size, n)
    stride = _to_tuple(stride, n)
    crops = []
    for d, k, s, (pb, pa) in zip(input_shape, kernel_size, stride, input_pad):
        total_crop = (d + pb + pa - 1) * s + k - d * s
        crop_before = pb * s + (k - s) // 2 if total_crop > 0 else 0
        crops.append((crop_before, total_crop - crop_before))
    return tuple(crops)


class SamePadConv3d(nn.Module):
    """Conv3d with SAME padding for any per-axis stride; the convolution is
    ``conv`` (the JAX module's child name)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: Union[int, Tuple[int, int, int]],
                 stride: Union[int, Tuple[int, int, int]] = 1, use_bias: bool = True):
        super().__init__()
        self.kernel_size = _to_tuple(kernel_size, 3)
        self.stride = _to_tuple(stride, 3)
        self.conv = nn.Conv3d(in_channels, out_channels, self.kernel_size, self.stride,
                              bias=use_bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pads = calculate_same_padding(self.kernel_size, self.stride, x.shape[1:-1])
        flat = [0, 0] + [p for lo_hi in reversed(pads) for p in lo_hi]  # F.pad: last dim first
        if any(flat):
            x = F.pad(x, flat)
        w = self.conv.weight.to(x.dtype)
        b = None if self.conv.bias is None else self.conv.bias.to(x.dtype)
        y = F.conv3d(x.permute(0, 4, 1, 2, 3), w, b, self.stride)
        return y.permute(0, 2, 3, 4, 1)


class SamePadConvTranspose3d(nn.Module):
    """ConvTranspose3d with SAME semantics: the output's spatial sizes are
    the input's times the stride; the convolution is ``convt``."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: Union[int, Tuple[int, int, int]],
                 stride: Union[int, Tuple[int, int, int]] = 1, use_bias: bool = True):
        super().__init__()
        self.kernel_size = _to_tuple(kernel_size, 3)
        self.stride = _to_tuple(stride, 3)
        self.output_padding = tuple(max(s - k, 0) for k, s in zip(self.kernel_size, self.stride))
        self.convt = nn.ConvTranspose3d(in_channels, out_channels, self.kernel_size, self.stride,
                                        output_padding=self.output_padding, bias=use_bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.convt.weight.to(x.dtype)
        b = None if self.convt.bias is None else self.convt.bias.to(x.dtype)
        y = F.conv_transpose3d(x.permute(0, 4, 1, 2, 3), w, b, self.stride,
                               output_padding=self.output_padding)
        y = y.permute(0, 2, 3, 4, 1)
        index = [slice(None)]
        for out_d, d, s in zip(y.shape[1:-1], x.shape[1:-1], self.stride):
            lo = (out_d - d * s) // 2
            index.append(slice(lo, lo + d * s))
        return y[tuple(index)]

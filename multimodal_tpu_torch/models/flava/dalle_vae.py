"""DALL-E dVAE encoder: the frozen image codebook that makes FLAVA's MIM
labels. Counterpart of ``multimodal_tpu/models/flava/dalle_vae.py``
(``DalleConv2d``, ``DalleEncoderBlock``, ``DalleEncoder``,
``DalleVAEEncoder``).

Images are NHWC at the interface, as in the JAX package; inside, the
tensors are NCHW in the ``channels_last`` layout (NHWC in memory), where
the convolutions and the 2x2 max pools run in PyTorch (cuDNN on the card;
XLA's convolutions in the JAX package, no TPU kernel). Module names follow
the JAX ones, so ``utils/checkpoint.py:dalle_state_dict_from_jax`` maps a
JAX tree by path. ``dtype`` is the compute dtype (None: the weights'); every
weight is cast to it at use. The codebook is frozen: its labels come out
under ``torch.no_grad()``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

_WIDTHS = (1, 2, 4, 8)  # each group's width in units of n_hid


class DalleConv2d(nn.Module):
    def __init__(self, n_in: int, n_out: int, kw: int):
        super().__init__()
        self.conv = nn.Conv2d(n_in, n_out, kw, padding=(kw - 1) // 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.conv
        return F.conv2d(x, c.weight.to(x.dtype), c.bias.to(x.dtype), padding=c.padding)


class DalleEncoderBlock(nn.Module):
    def __init__(self, n_in: int, n_out: int, n_layers: int):
        super().__init__()
        n_hid = n_out // 4
        self.post_gain = 1 / (n_layers ** 2)
        self.id_path = DalleConv2d(n_in, n_out, 1) if n_in != n_out else None
        self.conv_1 = DalleConv2d(n_in, n_hid, 3)
        self.conv_2 = DalleConv2d(n_hid, n_hid, 3)
        self.conv_3 = DalleConv2d(n_hid, n_hid, 3)
        self.conv_4 = DalleConv2d(n_hid, n_out, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = self.id_path(x) if self.id_path is not None else x
        h = self.conv_1(F.relu(x))
        h = self.conv_2(F.relu(h))
        h = self.conv_3(F.relu(h))
        h = self.conv_4(F.relu(h))
        return identity + self.post_gain * h


class DalleEncoder(nn.Module):
    """(b, h, w, 3) NHWC -> logits (b, h // 8, w // 8, vocab_size)."""

    def __init__(self, group_count: int = 4, n_hid: int = 256, n_blk_per_group: int = 2,
                 input_channels: int = 3, vocab_size: int = 8192,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.input_channels = input_channels
        self.n_blk_per_group = n_blk_per_group
        self.dtype = dtype
        # the JAX encoder runs these four groups whatever group_count is;
        # group_count sets only the blocks' post_gain
        n_layers = group_count * n_blk_per_group
        self.input_conv = DalleConv2d(input_channels, n_hid, 7)
        width = n_hid
        for gi, mult in enumerate(_WIDTHS):
            for bi in range(n_blk_per_group):
                self.add_module(f"group_{gi + 1}_block_{bi + 1}",
                                DalleEncoderBlock(width, mult * n_hid, n_layers))
                width = mult * n_hid
        self.output_conv = DalleConv2d(width, vocab_size, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[-1] != self.input_channels:
            raise ValueError(f"input has {x.shape[-1]} channels but model built for "
                             f"{self.input_channels}")
        dt = self.dtype or self.input_conv.conv.weight.dtype
        h = self.input_conv(x.to(dt).permute(0, 3, 1, 2))  # NHWC in memory: channels_last
        for gi in range(len(_WIDTHS)):
            for bi in range(self.n_blk_per_group):
                h = getattr(self, f"group_{gi + 1}_block_{bi + 1}")(h)
            if gi < len(_WIDTHS) - 1:
                h = F.max_pool2d(h, 2, 2)
        return self.output_conv(F.relu(h)).permute(0, 2, 3, 1)


class DalleVAEEncoder(nn.Module):
    """The frozen dVAE: codebook indices (or probabilities) of an image."""

    def __init__(self, image_size: int = 112, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.image_size = image_size
        self.encoder = DalleEncoder(dtype=dtype)
        self.requires_grad_(False)

    @torch.no_grad()
    def get_codebook_indices(self, images: torch.Tensor) -> torch.Tensor:
        return torch.argmax(self.encoder(images), dim=-1)

    @torch.no_grad()
    def get_codebook_probs(self, images: torch.Tensor) -> torch.Tensor:
        return torch.softmax(self.encoder(images), dim=-1)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        return self.get_codebook_indices(images)

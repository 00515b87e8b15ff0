"""Video VQ-VAE encoder and decoder: 3-D convolutions and axial attention.
Counterpart of ``multimodal_tpu/models/video_gpt/video_vqvae.py``.

Channel-last ``(b, t, h, w, c)`` as in the JAX modules; module and
parameter names are theirs (``utils/checkpoint.py:
video_vqvae_state_dict_from_jax`` maps by path). ``dtype`` is the compute
dtype: the input is cast to it on entry and every convolution and
projection casts its weights at use. The BatchNorms are flax's (momentum
0.9, eps 1e-5, statistics and normalization in fp32) on the port's N-d
fp32 BatchNorm; the ``deterministic`` argument, not ``module.training``,
picks running or batch statistics, as in the JAX modules.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
from torch import nn
from torch.nn import functional as F

from multimodal_tpu_torch.models.clip.resnet_encoder import Fp32BatchNorm2d
from multimodal_tpu_torch.models.vqvae import VQVAE
from multimodal_tpu_torch.modules.layers.attention import AxialAttention, MultiHeadAttention
from multimodal_tpu_torch.modules.layers.conv import SamePadConv3d, SamePadConvTranspose3d
from multimodal_tpu_torch.utils.common import to_tuple_tuple


class ChannelLastBatchNorm(Fp32BatchNorm2d):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` over the last axis
    of a channel-last tensor."""

    def __init__(self, channels: int):
        super().__init__(channels, eps=1e-5, momentum=0.1)

    def forward(self, x: torch.Tensor, deterministic: bool = True) -> torch.Tensor:
        return self.normalize(x.movedim(-1, 1), batch_statistics=not deterministic).movedim(1, -1)


class AxialAttentionBlock(nn.Module):
    """Sum of per-axis multi-head axial attentions (``mha_attn_<axis>``)."""

    def __init__(self, n_dims: int, qkv_dim: int, n_head: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.n_dims = n_dims
        self.qkv_dim = qkv_dim
        for d in range(n_dims):
            self.add_module(f"mha_attn_{d}", MultiHeadAttention(
                qkv_dim, qkv_dim, n_head, attn_module=AxialAttention(d), add_bias=False,
                dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: channel-last (b, d1..dn, c)."""
        if x.shape[-1] != self.qkv_dim:
            raise ValueError(f"Input channel dimension is {x.shape[-1]}, expected {self.qkv_dim}")
        out = torch.zeros_like(x)
        for d in range(self.n_dims):
            out = out + getattr(self, f"mha_attn_{d}")(x)
        return out


class AttentionResidualBlock(nn.Module):
    """BN / ReLU conv bottleneck and axial attention, with a residual."""

    def __init__(self, hidden_dim: int = 240, n_head: int = 2,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        if hidden_dim < 2:
            raise ValueError("hidden dim must be at least 2")
        self.bn_1 = ChannelLastBatchNorm(hidden_dim)
        self.conv_1 = SamePadConv3d(hidden_dim, hidden_dim // 2, 3, use_bias=False)
        self.bn_2 = ChannelLastBatchNorm(hidden_dim // 2)
        self.conv_2 = SamePadConv3d(hidden_dim // 2, hidden_dim, 1, use_bias=False)
        self.bn_3 = ChannelLastBatchNorm(hidden_dim)
        self.attn_block = AxialAttentionBlock(3, hidden_dim, n_head, dtype=dtype)

    def forward(self, x: torch.Tensor, deterministic: bool = True) -> torch.Tensor:
        h = self.conv_1(F.relu(self.bn_1(x, deterministic)))
        h = self.conv_2(F.relu(self.bn_2(h, deterministic)))
        h = self.attn_block(F.relu(self.bn_3(h, deterministic)))
        return x + h


class VideoEncoder(nn.Module):
    """Strided SAME 3-D conv stack, attention-residual stack, BN / ReLU and a
    1x1 conv to ``output_dim``."""

    def __init__(self, in_channel_dims: Tuple[int, ...],
                 kernel_sizes: Tuple[Tuple[int, int, int], ...],
                 strides: Tuple[Tuple[int, int, int], ...], output_dim: int,
                 n_res_layers: int = 4, attn_hidden_dim: int = 240,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.in_channel_dims = tuple(in_channel_dims)
        self.strides = tuple(tuple(s) for s in strides)
        self.n_res_layers = n_res_layers
        self.dtype = dtype
        n = len(in_channel_dims)
        for i in range(n):
            out_ch = in_channel_dims[i + 1] if i < n - 1 else attn_hidden_dim
            self.add_module(f"conv_{i}", SamePadConv3d(in_channel_dims[i], out_ch,
                                                       kernel_sizes[i], strides[i]))
        for i in range(n_res_layers):
            self.add_module(f"res_{i}", AttentionResidualBlock(attn_hidden_dim, dtype=dtype))
        self.bn_out = ChannelLastBatchNorm(attn_hidden_dim)
        self.conv_out = SamePadConv3d(attn_hidden_dim, output_dim, 1, 1)

    def get_latent_shape(self, input_shape: Tuple[int, ...]) -> Tuple[int, ...]:
        latent = list(input_shape)
        for stride in self.strides:
            latent = [d // s for d, s in zip(latent, stride)]
        return tuple(latent)

    def forward(self, x: torch.Tensor, deterministic: bool = True) -> torch.Tensor:
        if x.shape[-1] != self.in_channel_dims[0]:
            raise ValueError(f"expected input channel dim to be {self.in_channel_dims[0]}, got "
                             f"{x.shape[-1]}")
        h = x.to(self.dtype)
        n = len(self.in_channel_dims)
        for i in range(n):
            h = getattr(self, f"conv_{i}")(h)
            if i < n - 1:
                h = F.relu(h)
        for i in range(self.n_res_layers):
            h = getattr(self, f"res_{i}")(h, deterministic)
        return self.conv_out(F.relu(self.bn_out(h, deterministic)))


class VideoDecoder(nn.Module):
    """1x1 conv, attention-residual stack, BN / ReLU and a transposed-conv
    upsampling stack to ``out_channel_dims[-1]``."""

    def __init__(self, out_channel_dims: Tuple[int, ...],
                 kernel_sizes: Tuple[Tuple[int, int, int], ...],
                 strides: Tuple[Tuple[int, int, int], ...], input_dim: int,
                 n_res_layers: int = 4, attn_hidden_dim: int = 240,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.input_dim = input_dim
        self.n_res_layers = n_res_layers
        self.n_convt = len(out_channel_dims)
        self.dtype = dtype
        self.conv_in = SamePadConv3d(input_dim, attn_hidden_dim, 1, 1)
        for i in range(n_res_layers):
            self.add_module(f"res_{i}", AttentionResidualBlock(attn_hidden_dim, dtype=dtype))
        self.bn_out = ChannelLastBatchNorm(attn_hidden_dim)
        width = attn_hidden_dim
        for i, out_ch in enumerate(out_channel_dims):
            self.add_module(f"convt_{i}", SamePadConvTranspose3d(width, out_ch, kernel_sizes[i],
                                                                 strides[i]))
            width = out_ch

    def forward(self, x: torch.Tensor, deterministic: bool = True) -> torch.Tensor:
        if x.shape[-1] != self.input_dim:
            raise ValueError(f"expected input channel dim to be {self.input_dim}, got "
                             f"{x.shape[-1]}")
        h = self.conv_in(x.to(self.dtype))
        for i in range(self.n_res_layers):
            h = getattr(self, f"res_{i}")(h, deterministic)
        h = F.relu(self.bn_out(h, deterministic))
        for i in range(self.n_convt):
            h = getattr(self, f"convt_{i}")(h)
            if i < self.n_convt - 1:
                h = F.relu(h)
        return h


def preprocess_int_conv_params(
    channel_dims: Tuple[int, ...],
    kernel_sizes: Optional[Union[int, Tuple]] = None,
    strides: Optional[Union[int, Tuple]] = None,
):
    """int conv parameters -> a tuple of 3-tuples per layer."""
    if kernel_sizes is None and strides is None:
        raise ValueError("must specify at least one of kernel_sizes or strides")
    n = len(channel_dims)
    k = to_tuple_tuple(kernel_sizes, 3, n) if kernel_sizes is not None else None
    s = to_tuple_tuple(strides, 3, n) if strides is not None else None
    if k is not None and s is not None:
        return k, s
    return k if k is not None else s


def video_vqvae(
    in_channel_dim: int,
    encoder_hidden_dim: int,
    encoder_kernel_size: int,
    encoder_stride: int,
    encoder_n_layers: int,
    n_res_layers: int,
    attn_hidden_dim: int,
    num_embeddings: int,
    embedding_dim: int,
    decoder_hidden_dim: int,
    decoder_kernel_size: int,
    decoder_stride: int,
    decoder_n_layers: int,
    dtype: torch.dtype = torch.float32,
) -> VQVAE:
    """Generic video VQ-VAE builder (one kernel size and stride for every
    layer)."""
    encoder_in_channel_dims = (in_channel_dim,) + (encoder_hidden_dim,) * max(
        encoder_n_layers - 1, 0)
    decoder_out_channel_dims = (decoder_hidden_dim,) * max(decoder_n_layers - 1, 0) + (
        in_channel_dim,)
    enc_k, enc_s = preprocess_int_conv_params(encoder_in_channel_dims, encoder_kernel_size,
                                              encoder_stride)
    dec_k, dec_s = preprocess_int_conv_params(decoder_out_channel_dims, decoder_kernel_size,
                                              decoder_stride)
    encoder = VideoEncoder(encoder_in_channel_dims, enc_k, enc_s, embedding_dim, n_res_layers,
                           attn_hidden_dim, dtype=dtype)
    decoder = VideoDecoder(decoder_out_channel_dims, dec_k, dec_s, embedding_dim, n_res_layers,
                           attn_hidden_dim, dtype=dtype)
    return VQVAE(encoder, decoder, num_embeddings, embedding_dim)

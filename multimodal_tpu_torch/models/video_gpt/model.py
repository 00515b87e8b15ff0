"""VideoGPT builders. Counterpart of
``multimodal_tpu/models/video_gpt/model.py`` (``video_vqvae``,
``video_gpt``).

The builders make random weights from ``seed`` on the CPU
(:func:`init_video_gpt_`) and move the model to ``device``: CUDA unless the
caller passes ``device="cpu"``. Weights from the JAX package load through
``utils/checkpoint.py:video_gpt_state_dict_from_jax``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from multimodal_tpu_torch.models.video_gpt.gpt import (
    MultimodalGPT,
    MultimodalTransformerDecoder,
    RightShift,
    TransformerDecoder,
)
from multimodal_tpu_torch.models.video_gpt.video_vqvae import VideoDecoder, VideoEncoder
from multimodal_tpu_torch.models.vqvae import VQVAE
from multimodal_tpu_torch.modules.layers.codebook import Codebook
from multimodal_tpu_torch.modules.layers.position_embedding import BroadcastedPositionEmbedding
from multimodal_tpu_torch.utils.device import resolve_device
from multimodal_tpu_torch.utils.init import init_parameters_


@torch.no_grad()
def init_video_gpt_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Random weights from ``generator`` at the JAX modules' scales: dense
    and convolution kernels (transposed ones too) normal with std ``fan_in
    ** -0.5``, biases 0, norms 1 and 0, per-axis position tables std 0.01,
    the start vector and the modality projections std 0.02, ``to_logit``
    zero, codebooks unit normal (``code_avg`` a copy, usage 0)."""
    init_parameters_(model, generator)
    for m in model.modules():
        if isinstance(m, nn.ConvTranspose3d):
            fan_in = m.weight.shape[0] * m.weight[0, 0].numel()
            m.weight.copy_(torch.randn(m.weight.shape, generator=generator) * fan_in ** -0.5)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, BroadcastedPositionEmbedding):
            for p in m.parameters():
                p.copy_(torch.randn(p.shape, generator=generator) * 0.01)
        elif isinstance(m, RightShift):
            m.sos.copy_(torch.randn(m.sos.shape, generator=generator) * 0.02)
        elif isinstance(m, Codebook):
            m.embedding.copy_(torch.randn(m.embedding.shape, generator=generator))
            m.code_avg.copy_(m.embedding)
            m.code_usage.zero_()
            m.is_init.fill_(False)
        elif isinstance(m, MultimodalGPT):
            for name in ("in_projection", "out_projection"):
                if hasattr(m, name):
                    w = getattr(m, name).weight
                    w.copy_(torch.randn(w.shape, generator=generator) * 0.02)
            m.to_logit.weight.zero_()
    return model


def _built(model: nn.Module, device, seed: int) -> nn.Module:
    init_video_gpt_(model, torch.Generator().manual_seed(seed))
    return model.to(resolve_device(device)).eval()


def _vqvae_module(
    conv_filter_sizes: Tuple[Tuple[int, int, int], ...] = ((4, 4, 4),),
    conv_filter_strides: Tuple[Tuple[int, int, int], ...] = ((2, 2, 2),),
    encoder_filter_size: Tuple[int, int, int] = (3, 3, 3),
    encoder_filter_stride: Tuple[int, int, int] = (1, 1, 1),
    in_channel_dim: int = 3,
    encoder_hidden_dim: int = 240,
    n_res_layers: int = 4,
    attn_hidden_dim: int = 240,
    num_embeddings: int = 1024,
    embedding_dim: int = 256,
    decoder_hidden_dim: int = 240,
    dtype: torch.dtype = torch.float32,
) -> VQVAE:
    """VideoGPT's video VQ-VAE module, weights not drawn yet, on the CPU:
    the strided layers ``conv_filter_*`` then one ``encoder_filter_*``
    layer encode; the strided layers transposed decode."""
    encoder_kernel_sizes = tuple(conv_filter_sizes) + (tuple(encoder_filter_size),)
    encoder_strides = tuple(conv_filter_strides) + (tuple(encoder_filter_stride),)
    encoder_in_channel_dims = (in_channel_dim,) + (encoder_hidden_dim,) * max(
        len(encoder_strides) - 1, 0)
    decoder_out_channel_dims = (decoder_hidden_dim,) * max(len(conv_filter_strides) - 1, 0) + (
        in_channel_dim,)
    encoder = VideoEncoder(encoder_in_channel_dims, encoder_kernel_sizes, encoder_strides,
                           embedding_dim, n_res_layers, attn_hidden_dim, dtype=dtype)
    decoder = VideoDecoder(decoder_out_channel_dims, tuple(conv_filter_sizes),
                           tuple(conv_filter_strides), embedding_dim, n_res_layers,
                           attn_hidden_dim, dtype=dtype)
    return VQVAE(encoder, decoder, num_embeddings, embedding_dim)


def video_vqvae(device=None, seed: int = 0, **kwargs) -> VQVAE:
    """VideoGPT's video VQ-VAE (:func:`_vqvae_module`'s arguments) with
    random weights from ``seed``, on ``device``, in eval mode."""
    return _built(_vqvae_module(**kwargs), device, seed)


def video_gpt(
    input_shape: Tuple[int, int, int] = (16, 64, 64),
    latent_shape: Tuple[int, int, int] = (8, 32, 32),
    d_model: int = 576,
    n_head: int = 4,
    dropout: float = 0.2,
    attn_dropout: float = 0.3,
    num_decoder_layers: int = 16,
    vqvae_kwargs: Optional[dict] = None,
    dtype: torch.dtype = torch.float32,
    device=None,
    seed: int = 0,
) -> MultimodalGPT:
    """VideoGPT: video -> video generation with one VQ-VAE architecture
    tokenizing both modalities."""
    vqvae_kwargs = vqvae_kwargs or {}
    in_tokenizer = _vqvae_module(dtype=dtype, **vqvae_kwargs)
    out_tokenizer = _vqvae_module(dtype=dtype, **vqvae_kwargs)
    vqvae_latent_shape = in_tokenizer.encoder.get_latent_shape(input_shape)
    if tuple(latent_shape) != tuple(vqvae_latent_shape):
        raise ValueError(f"Latent shape required: {latent_shape} does not match that of VQVAE: "
                         f"{vqvae_latent_shape}")
    decoder = TransformerDecoder(num_decoder_layers, d_model, n_head, dropout, attn_dropout,
                                 dtype=dtype)
    mm_decoder = MultimodalTransformerDecoder(
        BroadcastedPositionEmbedding(tuple(latent_shape), d_model),
        BroadcastedPositionEmbedding(tuple(latent_shape), d_model), decoder, RightShift(d_model))
    model = MultimodalGPT(d_model, in_tokenizer.num_embeddings, out_tokenizer.num_embeddings,
                          tuple(latent_shape), in_tokenizer, out_tokenizer, mm_decoder,
                          dtype=dtype)
    return _built(model, device, seed)

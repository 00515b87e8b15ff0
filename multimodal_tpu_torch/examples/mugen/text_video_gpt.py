"""MUGEN text-to-video generation model. Counterpart of
``multimodal_tpu/examples/mugen/text_video_gpt.py``: a BPE text tokenizer
with a learned embedding table, MUGEN's video VQ-VAE, and a
``MultimodalGPT`` between them.

The defaults are the JAX builder's: 128 BPE tokens over CLIP's 49,408-id
vocabulary, 32 frames at 256 x 256 downsampled (4, 32, 32) to an (8, 8, 8)
latent, d_model 768, 8 heads, 12 layers. The JAX builder's default VQ-VAE
is VideoGPT's, whose latent is not that one; here ``vqvae_kwargs``
defaults to MUGEN's (:data:`MUGEN_VQVAE_KWARGS`, the reference's
``video_vqvae_mugen``: hidden width 240, 4 residual layers, 2,048 codes of
width 256, kernel 3), and the builder refuses a VQ-VAE whose latent shape
is not the one ``downsample`` gives.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from multimodal_tpu_torch.models.video_gpt.gpt import (
    MultimodalGPT,
    MultimodalTransformerDecoder,
    RightShift,
    TransformerDecoder,
)
from multimodal_tpu_torch.models.video_gpt.model import _built, _vqvae_module
from multimodal_tpu_torch.modules.layers.position_embedding import BroadcastedPositionEmbedding
from multimodal_tpu_torch.transforms.clip_transform import CLIPBPETokenizer

# MUGEN's video VQ-VAE through the VideoGPT builder's arguments: five strided
# layers (2,2,2), (2,2,2), (1,2,2), (1,2,2), (1,2,2) and a (1,1,1) one encode
# 32 x 256 x 256 to 8 x 8 x 8; the five strided layers transposed decode
MUGEN_VQVAE_KWARGS = dict(
    conv_filter_sizes=((3, 3, 3),) * 5,
    conv_filter_strides=((2, 2, 2), (2, 2, 2), (1, 2, 2), (1, 2, 2), (1, 2, 2)),
    encoder_filter_size=(3, 3, 3),
    encoder_filter_stride=(1, 1, 1),
    encoder_hidden_dim=240,
    n_res_layers=4,
    attn_hidden_dim=240,
    num_embeddings=2048,
    embedding_dim=256,
    decoder_hidden_dim=240,
)


class TextTokenizer(nn.Module):
    """BPE text tokenizer as a ``MultimodalGPT`` input tokenizer:
    ``tokenize_host`` turns strings into ``context_len`` ids (zero-padded)
    on the host, ``encode`` passes ids through, ``lookup`` reads the learned
    ``embedding_table``."""

    def __init__(self, context_len: int, vocab_size: int, embedding_dim: int,
                 bpe_path: Optional[str] = None):
        super().__init__()
        self.context_len = context_len
        self.embedding_dim = embedding_dim
        self.embedding_table = nn.Embedding(vocab_size, embedding_dim)
        self._bpe = CLIPBPETokenizer(bpe_path) if bpe_path is not None else None

    def tokenize_host(self, sentences: List[str]) -> np.ndarray:
        if self._bpe is None:
            raise ValueError("bpe_path required for host-side tokenization")
        out = np.zeros((len(sentences), self.context_len), np.int64)
        for i, s in enumerate(sentences):
            ids = self._bpe.encode(s)[: self.context_len]
            out[i, : len(ids)] = ids
        return out

    def encode(self, token_ids: torch.Tensor) -> torch.Tensor:
        return token_ids

    def lookup(self, token_ids: torch.Tensor) -> torch.Tensor:
        return self.embedding_table.weight[token_ids.long()]


def text_video_gpt(
    text_seq_len: int = 128,
    video_seq_len: int = 32,
    resolution: int = 256,
    downsample: Tuple[int, int, int] = (4, 32, 32),
    d_model: int = 768,
    n_head: int = 8,
    dropout: float = 0.2,
    attn_dropout: float = 0.3,
    num_decoder_layers: int = 12,
    text_vocab_size: int = 49408,
    bpe_path: Optional[str] = None,
    vqvae_kwargs: Optional[dict] = None,
    dtype: torch.dtype = torch.float32,
    device=None,
    seed: int = 0,
) -> MultimodalGPT:
    """Text -> video ``MultimodalGPT`` with random weights from ``seed``, on
    ``device`` (CUDA unless ``"cpu"``), in eval mode; ``dtype`` is the
    compute dtype."""
    latent_shape = (video_seq_len // downsample[0], resolution // downsample[1],
                    resolution // downsample[2])
    in_tokenizer = TextTokenizer(text_seq_len, text_vocab_size, d_model, bpe_path)
    out_tokenizer = _vqvae_module(dtype=dtype, **(vqvae_kwargs or MUGEN_VQVAE_KWARGS))
    vq_latent = out_tokenizer.encoder.get_latent_shape((video_seq_len, resolution, resolution))
    if tuple(vq_latent) != latent_shape:
        raise ValueError(f"the VQ-VAE's latent shape {vq_latent} is not {latent_shape}, the "
                         f"one downsample {tuple(downsample)} gives")
    decoder = TransformerDecoder(num_decoder_layers, d_model, n_head, dropout, attn_dropout,
                                 dtype=dtype)
    mm_decoder = MultimodalTransformerDecoder(
        BroadcastedPositionEmbedding((text_seq_len,), d_model),
        BroadcastedPositionEmbedding(latent_shape, d_model), decoder, RightShift(d_model))
    model = MultimodalGPT(d_model, text_vocab_size, out_tokenizer.num_embeddings, latent_shape,
                          in_tokenizer, out_tokenizer, mm_decoder,
                          use_in_projection=False,  # the text table is already d_model wide
                          use_out_projection=True, dtype=dtype)
    return _built(model, device, seed)

"""Position embeddings. Counterpart of
``multimodal_tpu/modules/layers/position_embedding.py``.

``BroadcastedPositionEmbedding`` factorizes an n-D latent volume's position
table into one table per axis, each ``embedding_dim / n_dims`` wide: a flat
position id is split into per-axis coordinates by div/mod and the axes'
rows are concatenated. Negative ids wrap (``position_ids % total``).
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
from torch import nn


class BroadcastedPositionEmbedding(nn.Module):
    """Factorized per-axis position embeddings for n-D latents (VideoGPT);
    the tables are ``d_0`` ... ``d_{n-1}``, the JAX module's names."""

    def __init__(self, latent_shape: Tuple[int, ...], embedding_dim: int):
        super().__init__()
        n_dim = len(latent_shape)
        if embedding_dim % n_dim != 0:
            raise ValueError(
                f"Embedding dim {embedding_dim} modulo len(latent_shape) {n_dim} is not zero")
        self.latent_shape = tuple(latent_shape)
        self.embedding_dim = embedding_dim
        for i, d in enumerate(self.latent_shape):
            self.register_parameter(
                f"d_{i}", nn.Parameter(torch.randn(d, embedding_dim // n_dim) * 0.01))

    @property
    def num_positions(self) -> int:
        return math.prod(self.latent_shape)

    def forward(self, position_ids: torch.Tensor) -> torch.Tensor:
        """``position_ids``: flat ids into the row-major latent volume, any
        shape; returns ``position_ids.shape + (embedding_dim,)``."""
        total = self.num_positions
        flat = position_ids.long() % total
        parts = []
        stride = total
        for i, d in enumerate(self.latent_shape):
            stride //= d
            parts.append(getattr(self, f"d_{i}")[(flat // stride) % d])
        return torch.cat(parts, dim=-1)


class SinusoidalPositionEmbeddings(nn.Module):
    """DDPM timestep embeddings (Ho et al. 2020): ``[sin | cos]`` of the
    timestep at geometric frequencies, zero-padded to an odd width."""

    def __init__(self, embed_dim: int = 128):
        super().__init__()
        self.embed_dim = embed_dim

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        half_dim = self.embed_dim // 2
        scale = math.log(10000) / (half_dim - 1)
        freqs = torch.exp(torch.arange(half_dim, dtype=torch.float32, device=t.device) * -scale)
        args = t.float()[:, None] * freqs[None, :]
        emb = torch.cat([torch.sin(args), torch.cos(args)], dim=-1)
        if self.embed_dim % 2 == 1:
            emb = nn.functional.pad(emb, (0, 1))
        return emb

"""EMA vector-quantization codebook (the VQ-VAE bottleneck). Counterpart of
``multimodal_tpu/modules/layers/codebook.py``.

The JAX module's ``vq_stats`` collection (``embedding``, ``code_usage``,
``code_avg``, ``is_init``) is four buffers here, updated in place by a
training call. The nearest code is the argmin of ``|e|^2 - 2 z.e`` in fp32
(``|z|^2`` is the same for every code). Training (``deterministic=False``)
initialises the codebook lazily from the first encoder batch, runs the EMA
update with Laplace smoothing and re-draws every code whose usage falls
below the threshold; the quantized output is looked up in the codebook as
it was **before** the update, and passes the encoder's gradient straight
through. The random vectors come from the caller's ``torch.Generator``:
JAX's draws cannot be reproduced, so only the paths they do not reach are
compared with JAX (``is_init`` set, every usage above the threshold).
Layout is channel-last ``(b, d1, ..., dn, c)``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn


class CodebookOutput(NamedTuple):
    encoded_flat: torch.Tensor
    quantized_flat: torch.Tensor
    codebook_indices: torch.Tensor
    quantized: torch.Tensor


def _random_vectors(x: torch.Tensor, n: int, generator: Optional[torch.Generator]
                    ) -> torch.Tensor:
    """``n`` rows of ``x`` in a random order, ``x`` tiled with a little
    noise first when it has fewer than ``n`` rows."""
    num_vectors, num_channels = x.shape
    if num_vectors < n:
        repeats = (n + num_vectors - 1) // num_vectors
        x = x.repeat(repeats, 1)
        noise = torch.randn(x.shape, generator=generator, device=x.device, dtype=x.dtype)
        x = x + noise * (0.01 / num_channels ** 0.5)
    idx = torch.randperm(x.shape[0], generator=generator, device=x.device)
    return x[idx[:n]]


class Codebook(nn.Module):
    def __init__(self, num_embeddings: int, embedding_dim: int, decay: float = 0.99,
                 codebook_usage_threshold: float = 1.0, epsilon: float = 1e-7):
        super().__init__()
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.decay = decay
        self.codebook_usage_threshold = codebook_usage_threshold
        self.epsilon = epsilon
        embedding = torch.randn(num_embeddings, embedding_dim)
        self.register_buffer("embedding", embedding)
        self.register_buffer("code_usage", torch.zeros(num_embeddings))
        self.register_buffer("code_avg", embedding.clone())
        self.register_buffer("is_init", torch.tensor(False))

    def lookup(self, indices: torch.Tensor) -> torch.Tensor:
        """Embeddings of shape ``indices.shape + (embedding_dim,)``."""
        return self.embedding[indices.long()]

    @staticmethod
    def quantize_indices(encoded_flat: torch.Tensor, embedding: torch.Tensor) -> torch.Tensor:
        """The nearest code of each row: argmin of ``|e|^2 - 2 z.e`` in fp32
        (the first on a tie)."""
        e = embedding.float()
        dots = encoded_flat.float() @ e.t()
        return torch.argmin((e * e).sum(-1)[None, :] - 2.0 * dots, dim=1)

    def forward(self, z: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> CodebookOutput:
        """``z``: encoder output ``(b, d1, ..., dn, c)``. With
        ``deterministic=False`` the codebook's buffers are updated in place,
        drawing from ``generator``."""
        orig_shape = z.shape
        if orig_shape[-1] != self.embedding_dim:
            raise ValueError(f"Expected last dim {orig_shape[-1]} to equal embedding size "
                             f"{self.embedding_dim}")
        encoded_flat = z.reshape(-1, self.embedding_dim)
        embedding = self.embedding
        if not deterministic:
            with torch.no_grad():
                enc = encoded_flat.detach().float()
                if not bool(self.is_init):
                    init = _random_vectors(enc, self.num_embeddings, generator)
                    self.embedding.copy_(init)
                    self.code_avg.copy_(init)
                    self.code_usage.fill_(1.0)
                embedding = self.embedding.clone()
        indices = self.quantize_indices(encoded_flat, embedding)
        if not deterministic:
            with torch.no_grad():
                self._ema_update(enc, indices, generator)
        quantized_flat = embedding[indices].to(z.dtype)
        # straight-through estimator
        quantized_flat = encoded_flat + (quantized_flat - encoded_flat).detach()
        return CodebookOutput(encoded_flat, quantized_flat, indices.reshape(orig_shape[:-1]),
                              quantized_flat.reshape(orig_shape))

    def _ema_update(self, enc: torch.Tensor, indices: torch.Tensor,
                    generator: Optional[torch.Generator]) -> None:
        n_codes = self.num_embeddings
        counts = torch.zeros(n_codes, device=enc.device).index_add_(
            0, indices, torch.ones_like(indices, dtype=torch.float32))
        usage = self.code_usage * self.decay + counts * (1 - self.decay)
        n = usage.sum()
        usage = (usage + self.epsilon) / (n + n_codes * self.epsilon) * n
        per_code = torch.zeros(n_codes, self.embedding_dim, device=enc.device).index_add_(
            0, indices, enc)
        code_avg = self.code_avg * self.decay + per_code * (1 - self.decay)
        embedding = code_avg / usage[:, None]
        reset = _random_vectors(enc, n_codes, generator)
        embedding = torch.where(usage[:, None] >= self.codebook_usage_threshold, embedding,
                                reset)
        self.embedding.copy_(embedding)
        self.code_usage.copy_(usage)
        self.code_avg.copy_(code_avg)
        self.is_init.fill_(True)

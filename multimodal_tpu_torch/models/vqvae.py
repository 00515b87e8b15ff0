"""Generic VQ-VAE: encoder, EMA codebook, decoder. Counterpart of
``multimodal_tpu/models/vqvae.py``. Channel-last ``(b, d1, ..., dn, c)``
throughout: the encoder's output feeds the codebook with no transpose.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn

from multimodal_tpu_torch.modules.layers.codebook import Codebook, CodebookOutput


class VQVAEOutput(NamedTuple):
    decoded: torch.Tensor
    codebook_output: CodebookOutput


class VQVAE(nn.Module):
    def __init__(self, encoder: nn.Module, decoder: nn.Module, num_embeddings: int,
                 embedding_dim: int):
        super().__init__()
        self.encoder = encoder
        self.decoder = decoder
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.codebook = Codebook(num_embeddings, embedding_dim)

    def latent_shape(self, input_shape: Tuple[int, ...]) -> Tuple[int, ...]:
        """Downsampled shape of the encoder output: (d1, ..., dn)."""
        if not hasattr(self.encoder, "get_latent_shape"):
            raise AttributeError(
                f"Missing attribute 'get_latent_shape' of the encoder {self.encoder}")
        return self.encoder.get_latent_shape(input_shape)

    def encode(self, x: torch.Tensor, return_embeddings: bool = False,
               deterministic: bool = True):
        """Data -> token ids ``(b, d1..dn)`` (and the quantized embeddings);
        the codebook is not updated."""
        out = self.codebook(self.encoder(x, deterministic=deterministic), deterministic=True)
        if return_embeddings:
            return out.codebook_indices, out.quantized
        return out.codebook_indices

    def decode(self, indices: torch.Tensor, deterministic: bool = True) -> torch.Tensor:
        """Token ids ``(b, d1..dn)`` -> data."""
        return self.decoder(self.lookup(indices), deterministic=deterministic)

    def lookup(self, indices: torch.Tensor) -> torch.Tensor:
        return self.codebook.lookup(indices)

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> VQVAEOutput:
        encoded = self.encoder(x, deterministic=deterministic)
        codebook_output = self.codebook(encoded, deterministic=deterministic, generator=generator)
        decoded = self.decoder(codebook_output.quantized, deterministic=deterministic)
        return VQVAEOutput(decoded, codebook_output)

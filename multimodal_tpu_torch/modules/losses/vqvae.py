"""VQ-VAE commitment loss. Counterpart of
``multimodal_tpu/modules/losses/vqvae.py``: the mean squared distance
between the encoder's outputs and the (detached) quantized vectors, in
fp32."""

from __future__ import annotations

import torch


def commitment_loss(quantized: torch.Tensor, encoded: torch.Tensor,
                    commitment_cost: float = 1.0) -> torch.Tensor:
    return ((quantized.detach().float() - encoded.float()) ** 2).mean() * commitment_cost


class CommitmentLoss:
    def __init__(self, commitment_cost: float = 1.0):
        self.commitment_cost = commitment_cost

    def __call__(self, quantized: torch.Tensor, encoded: torch.Tensor) -> torch.Tensor:
        return commitment_loss(quantized, encoded, self.commitment_cost)

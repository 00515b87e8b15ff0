"""ALBEF losses: image-text contrastive with momentum distillation, and
causal language modelling with distillation. Counterpart of
``multimodal_tpu/modules/losses/albef.py`` (``image_text_contrastive_loss``,
``causal_language_modeling_loss`` and their classes). Both compute in fp32
whatever their inputs' dtype."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F


def image_text_contrastive_loss(
    image_to_text_sim: torch.Tensor,
    text_to_image_sim: torch.Tensor,
    image_to_text_sim_m: Optional[torch.Tensor] = None,
    text_to_image_sim_m: Optional[torch.Tensor] = None,
    sim_targets: Optional[torch.Tensor] = None,
    alpha: float = 0.0,
) -> torch.Tensor:
    """Soft-target symmetric contrastive loss; with ``alpha`` > 0 the
    targets mix in the momentum similarities' softmax."""
    i2t, t2i = image_to_text_sim.float(), text_to_image_sim.float()
    if sim_targets is None:
        sim_targets = torch.eye(i2t.shape[0], i2t.shape[1], device=i2t.device)
    sim_targets = sim_targets.float()
    if alpha != 0:
        if image_to_text_sim_m is None or text_to_image_sim_m is None:
            raise ValueError("momentum similarities required for non-zero alpha")
        with torch.no_grad():
            i2t_targets = (alpha * F.softmax(image_to_text_sim_m.float(), dim=1)
                           + (1 - alpha) * sim_targets)
            t2i_targets = (alpha * F.softmax(text_to_image_sim_m.float(), dim=1)
                           + (1 - alpha) * sim_targets)
    else:
        i2t_targets = t2i_targets = sim_targets
    loss_i2t = -(F.log_softmax(i2t, dim=1) * i2t_targets).sum(dim=1).mean()
    loss_t2i = -(F.log_softmax(t2i, dim=1) * t2i_targets).sum(dim=1).mean()
    return (loss_i2t + loss_t2i) / 2


class ImageTextContrastiveLoss(nn.Module):
    def forward(self, *args, **kwargs) -> torch.Tensor:
        return image_text_contrastive_loss(*args, **kwargs)


def causal_language_modeling_loss(
    labels: torch.Tensor,
    prediction_scores: torch.Tensor,
    prediction_scores_m: Optional[torch.Tensor] = None,
    mask_token_id: int = -100,
    alpha: float = 0.0,
) -> torch.Tensor:
    """Next-token cross entropy of each sample, summed over its positions
    (labels equal to ``mask_token_id`` left out), with optional momentum
    distillation. Returns ``(batch,)``."""
    scores = prediction_scores[:, :-1, :].float()
    labels = labels[:, 1:]
    valid = labels != mask_token_id
    safe = torch.where(valid, labels, 0).long()
    logp = F.log_softmax(scores, dim=-1)
    nll = -logp.gather(-1, safe[..., None])[..., 0]
    loss = (nll * valid.float()).sum(dim=1)
    if alpha != 0:
        if prediction_scores_m is None:
            raise ValueError("prediction_scores_m cannot be None for non-zero alpha")
        with torch.no_grad():
            soft = F.softmax(prediction_scores_m[:, :-1, :].float(), dim=-1)
        distill = -(logp * soft).sum(dim=-1)
        distill = (distill * valid.float()).sum(dim=1)
        loss = (1 - alpha) * loss + alpha * distill
    return loss


class CausalLanguageModelingLoss(nn.Module):
    def __init__(self, mask_token_id: int = -100):
        super().__init__()
        self.mask_token_id = mask_token_id

    def forward(self, labels, prediction_scores, prediction_scores_m=None, alpha: float = 0.0):
        return causal_language_modeling_loss(labels, prediction_scores, prediction_scores_m,
                                             self.mask_token_id, alpha)

"""Global-batch contrastive loss with learnable temperature (CLIP ITC).

Counterpart of
``multimodal_tpu/modules/losses/contrastive_loss_with_temperature.py``:
local x global fp32 logits, symmetric cross entropy with labels offset by
``rank * local_batch``, an optional per-row boolean mask (0-weighted rows),
label smoothing, and a module owning ``logit_scale``, clamped to
``[ln 1, ln 100]`` in the forward (functionally, as the JAX module does).
The embeddings are gathered over ``group`` with the requested
``BackpropType`` (``parallel/collectives.py``); on one process it is the
local computation.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Union

import torch
import torch.distributed as dist
from torch import nn

from multimodal_tpu_torch.parallel.collectives import (
    BackpropType,
    all_gather_with_backprop_type,
    get_rank,
)

DEFAULT_LOGIT_SCALE = math.log(1 / 0.07)
DEFAULT_LOGIT_SCALE_MIN = math.log(1.0)
DEFAULT_LOGIT_SCALE_MAX = math.log(100.0)


class ContrastiveLossOutput(NamedTuple):
    loss: torch.Tensor
    logits_a: torch.Tensor
    logits_b: torch.Tensor
    loss_a: torch.Tensor
    loss_b: torch.Tensor


def cross_entropy(
    logits: torch.Tensor,
    labels: torch.Tensor,
    label_smoothing: float = 0.0,
    weights: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Mean cross entropy over rows; integer labels; optional smoothing
    (``(1 - eps) nll + eps * mean over classes``) and per-row 0/1 weights."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    label_logp = logp.gather(-1, labels[:, None])[:, 0]
    if label_smoothing > 0.0:
        nll = -(1.0 - label_smoothing) * label_logp - label_smoothing * logp.mean(-1)
    else:
        nll = -label_logp
    if weights is not None:
        w = weights.to(nll.dtype)
        return (nll * w).sum() / w.sum().clamp_min(1.0)
    return nll.mean()


def contrastive_loss_with_temperature(
    embeddings_a: torch.Tensor,
    embeddings_b: torch.Tensor,
    logit_scale: Union[float, torch.Tensor],
    mask: Optional[torch.Tensor] = None,
    backprop_type: BackpropType = BackpropType.GLOBAL,
    group: Optional[dist.ProcessGroup] = None,
    label_smoothing: float = 0.0,
) -> ContrastiveLossOutput:
    """Functional symmetric InfoNCE with temperature ``exp(logit_scale)``.

    ``mask`` is a per-local-row boolean; masked-out rows are excluded from
    both directions of the loss as 0-weighted rows.
    """
    temperature = torch.as_tensor(logit_scale, dtype=torch.float32,
                                  device=embeddings_a.device).exp()
    a_global = all_gather_with_backprop_type(embeddings_a, group, backprop_type)
    b_global = all_gather_with_backprop_type(embeddings_b, group, backprop_type)
    local_bs = embeddings_a.shape[0]
    labels = get_rank(group) * local_bs + torch.arange(local_bs, device=embeddings_a.device)
    # bf16 products are exact in fp32: these are the fp32-accumulated logits
    logits_a = embeddings_a.float() @ b_global.float().t() * temperature
    logits_b = embeddings_b.float() @ a_global.float().t() * temperature
    weights = mask.float() if mask is not None else None
    loss_a = cross_entropy(logits_a, labels, label_smoothing, weights)
    loss_b = cross_entropy(logits_b, labels, label_smoothing, weights)
    return ContrastiveLossOutput((loss_a + loss_b) / 2, logits_a, logits_b, loss_a, loss_b)


class ContrastiveLossWithTemperature(nn.Module):
    """Module owning the learnable ``logit_scale``, clamped to
    ``[logit_scale_min, logit_scale_max]`` in the forward."""

    def __init__(self, logit_scale: float = DEFAULT_LOGIT_SCALE,
                 logit_scale_min: Optional[float] = DEFAULT_LOGIT_SCALE_MIN,
                 logit_scale_max: Optional[float] = DEFAULT_LOGIT_SCALE_MAX):
        super().__init__()
        if logit_scale_min is None and logit_scale_max is None:
            raise ValueError(
                "Only one of `logit_scale_min` and `logit_scale_max` can be None."
            )
        self.logit_scale = nn.Parameter(torch.tensor(float(logit_scale)))
        self.logit_scale_min = logit_scale_min
        self.logit_scale_max = logit_scale_max

    def forward(
        self,
        embeddings_a: torch.Tensor,
        embeddings_b: torch.Tensor,
        backprop_type: BackpropType = BackpropType.GLOBAL,
        group: Optional[dist.ProcessGroup] = None,
        label_smoothing: float = 0.0,
        mask: Optional[torch.Tensor] = None,
        return_output: bool = False,
    ):
        logit_scale = torch.clamp(self.logit_scale, self.logit_scale_min, self.logit_scale_max)
        out = contrastive_loss_with_temperature(
            embeddings_a, embeddings_b, logit_scale, mask=mask,
            backprop_type=backprop_type, group=group, label_smoothing=label_smoothing,
        )
        return out if return_output else out.loss

"""FLAVA pretraining losses (MLM, MIM, ITM, MMM, global contrastive).
Counterpart of ``multimodal_tpu/modules/losses/flava.py``.

As in the JAX package, the masked-token losses run their heads over the
whole sequence and weight the cross entropy by ``label != ignore_index``
(no boolean row selection), and the ITM positive pairs become per-sample
0/1 weights in the MMM and contrastive terms. Heads take the compute dtype
of their input; the cross entropies and the contrastive logits are fp32.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional, Union

import torch
from torch import nn

from multimodal_tpu_torch.modules.layers.activation import get_activation
from multimodal_tpu_torch.modules.layers.multi_head_attention import dense
from multimodal_tpu_torch.modules.layers.normalizations import Fp32LayerNorm
from multimodal_tpu_torch.modules.losses.contrastive_loss_with_temperature import (
    contrastive_loss_with_temperature,
)
from multimodal_tpu_torch.parallel.collectives import BackpropType


class ITMLossOutput(NamedTuple):
    logits: torch.Tensor
    loss: torch.Tensor


class MaskedPredictionLossOutput(NamedTuple):
    logits: torch.Tensor
    loss: torch.Tensor


class FLAVAGlobalContrastiveLossOutput(NamedTuple):
    text_embedding: torch.Tensor
    image_embedding: torch.Tensor
    logit_scale: torch.Tensor
    image_logits: torch.Tensor
    text_logits: torch.Tensor
    image_loss: torch.Tensor
    text_loss: torch.Tensor
    loss: torch.Tensor


class FLAVAPretrainingLossesCollection(NamedTuple):
    mmm_text_loss: Optional[torch.Tensor] = None
    mmm_image_loss: Optional[torch.Tensor] = None
    mim_loss: Optional[torch.Tensor] = None
    mlm_loss: Optional[torch.Tensor] = None
    itm_loss: Optional[torch.Tensor] = None
    global_contrastive_loss: Optional[torch.Tensor] = None

    def total(self) -> torch.Tensor:
        parts = [loss for loss in self if loss is not None]
        return sum(parts[1:], parts[0]) if parts else torch.tensor(0.0)


class FLAVAPretrainingLossOutput(NamedTuple):
    losses: FLAVAPretrainingLossesCollection = FLAVAPretrainingLossesCollection()
    mlm_output: Optional[MaskedPredictionLossOutput] = None
    mim_output: Optional[MaskedPredictionLossOutput] = None
    mmm_text_output: Optional[MaskedPredictionLossOutput] = None
    mmm_image_output: Optional[MaskedPredictionLossOutput] = None
    itm_output: Optional[ITMLossOutput] = None
    global_contrastive_output: Optional[FLAVAGlobalContrastiveLossOutput] = None


def _masked_cross_entropy(logits: torch.Tensor, labels: torch.Tensor, ignore_index: int = -1,
                          sample_weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean fp32 cross entropy over the positions whose label is not
    ``ignore_index`` (and whose sample weight is nonzero); 0 if none."""
    valid = labels != ignore_index
    if sample_weights is not None:
        valid = valid & sample_weights.bool()[:, None]
    safe = torch.where(valid, labels, 0).long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, safe[..., None])[..., 0]
    w = valid.float()
    return (nll * w).sum() / w.sum().clamp_min(1.0)


class Pooler(nn.Module):
    """CLS-token dense + tanh pooler."""

    def __init__(self, hidden_size: int = 768):
        super().__init__()
        self.dense = nn.Linear(hidden_size, hidden_size)

    def forward(self, hidden_states: torch.Tensor) -> torch.Tensor:
        first = hidden_states[:, 0]
        return torch.tanh(dense(self.dense, first, first.dtype))


class TwoWayHead(nn.Module):
    def __init__(self, hidden_size: int = 768):
        super().__init__()
        self.seq_relationship = nn.Linear(hidden_size, 2)

    def forward(self, pooled_output: torch.Tensor) -> torch.Tensor:
        return dense(self.seq_relationship, pooled_output, pooled_output.dtype)


class ITMLoss(nn.Module):
    def __init__(self, hidden_size: int = 768, ignore_index: int = -1):
        super().__init__()
        self.ignore_index = ignore_index
        self.pooler = Pooler(hidden_size)
        self.cls = TwoWayHead(hidden_size)

    def forward(self, hidden_states: torch.Tensor,
                labels: Optional[torch.Tensor]) -> ITMLossOutput:
        pooled = self.pooler(hidden_states)
        scores = self.cls(pooled)
        if labels is None:
            loss = pooled.sum() * 0.0
        else:
            loss = _masked_cross_entropy(scores, labels, self.ignore_index)
        return ITMLossOutput(logits=scores, loss=loss)


class MaskedPredictionHead(nn.Module):
    def __init__(self, hidden_size: int = 768, vocab_size: int = 30522,
                 transform_act_fn: Union[str, Callable] = "gelu", layer_norm_eps: float = 1e-5):
        super().__init__()
        self.act = get_activation(transform_act_fn)
        self.dense = nn.Linear(hidden_size, hidden_size)
        self.layer_norm = Fp32LayerNorm(hidden_size, eps=layer_norm_eps)
        self.decoder = nn.Linear(hidden_size, vocab_size, bias=False)
        self.bias = nn.Parameter(torch.zeros(vocab_size))

    def forward(self, hidden_states: torch.Tensor) -> torch.Tensor:
        h = self.layer_norm(self.act(dense(self.dense, hidden_states, hidden_states.dtype)))
        logits = dense(self.decoder, h, h.dtype)
        return logits + self.bias.to(logits.dtype)


class MaskedPredictionLoss(nn.Module):
    def __init__(self, hidden_size: int = 768, vocab_size: int = 30522,
                 transform_act_fn: Union[str, Callable] = "gelu", layer_norm_eps: float = 1e-5,
                 ignore_index: int = -1):
        super().__init__()
        self.ignore_index = ignore_index
        self.cls = MaskedPredictionHead(hidden_size, vocab_size, transform_act_fn,
                                        layer_norm_eps)

    def forward(self, hidden_states: torch.Tensor, masked_labels: Optional[torch.Tensor] = None,
                sample_weights: Optional[torch.Tensor] = None) -> MaskedPredictionLossOutput:
        prediction = self.cls(hidden_states)
        if masked_labels is None:
            loss = prediction.sum() * 0.0
        else:
            loss = _masked_cross_entropy(prediction, masked_labels, self.ignore_index,
                                         sample_weights)
        return MaskedPredictionLossOutput(logits=prediction, loss=loss)


class FLAVAGlobalContrastiveLoss(nn.Module):
    """Contrastive loss of the L2-normalised (fp32) embeddings with a
    learnable fp32 ``logit_scale``, clipped to ``[0, 4.6052]`` in the
    forward."""

    def __init__(self, logit_scale_init: float = math.log(1 / 0.07)):
        super().__init__()
        self.logit_scale = nn.Parameter(torch.tensor(float(logit_scale_init)))

    def forward(self, image_sequence: torch.Tensor, text_sequence: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> FLAVAGlobalContrastiveLossOutput:
        def l2norm(x):
            x32 = x.float()
            return x32 / x32.norm(dim=-1, keepdim=True).clamp_min(1e-12)

        text_embedding = l2norm(text_sequence)
        image_embedding = l2norm(image_sequence)
        logit_scale = self.logit_scale.float().clamp(0.0, 4.6052)
        out = contrastive_loss_with_temperature(
            image_embedding, text_embedding, logit_scale, mask=mask,
            backprop_type=BackpropType.GLOBAL)
        return FLAVAGlobalContrastiveLossOutput(
            loss=out.loss, image_logits=out.logits_a, text_logits=out.logits_b,
            image_loss=out.loss_a, text_loss=out.loss_b, text_embedding=text_embedding,
            image_embedding=image_embedding, logit_scale=logit_scale)


class FLAVAPretrainingLoss(nn.Module):
    """The six FLAVA objectives with their weights. Inside the masked
    multimodal sequence the image tokens start at index 2 (the mm encoder's
    CLS and the image encoder's CLS come first) and the text tokens are the
    trailing ``mlm_labels.shape[1]`` positions."""

    def __init__(
        self,
        logit_scale_init: float = math.log(1 / 0.07),
        hidden_size: int = 768,
        text_vocab_size: int = 30522,
        image_vocab_size: int = 8192,
        transform_act_fn: Union[str, Callable] = "gelu",
        layer_norm_eps: float = 1e-5,
        ignore_index: int = -1,
        mlm_weight: float = 1.0,
        mim_weight: float = 1.0,
        contrastive_loss_weight: float = 1.0,
        mmm_image_loss_weight: float = 1.0,
        mmm_text_loss_weight: float = 1.0,
        itm_loss_weight: float = 1.0,
    ):
        super().__init__()
        self.mlm_weight = mlm_weight
        self.mim_weight = mim_weight
        self.contrastive_loss_weight = contrastive_loss_weight
        self.mmm_image_loss_weight = mmm_image_loss_weight
        self.mmm_text_loss_weight = mmm_text_loss_weight
        self.itm_loss_weight = itm_loss_weight
        kw = dict(transform_act_fn=transform_act_fn, layer_norm_eps=layer_norm_eps,
                  ignore_index=ignore_index)
        self.contrastive_loss = FLAVAGlobalContrastiveLoss(logit_scale_init)
        self.mlm_loss = MaskedPredictionLoss(hidden_size, text_vocab_size, **kw)
        self.mim_loss = MaskedPredictionLoss(hidden_size, image_vocab_size, **kw)
        self.mmm_text_loss_module = MaskedPredictionLoss(hidden_size, text_vocab_size, **kw)
        self.mmm_image_loss_module = MaskedPredictionLoss(hidden_size, image_vocab_size, **kw)
        self.itm_loss_module = ITMLoss(hidden_size, ignore_index)

    def forward(
        self,
        image_sequence: Optional[torch.Tensor] = None,
        text_sequence: Optional[torch.Tensor] = None,
        image_masked_sequence: Optional[torch.Tensor] = None,
        text_masked_sequence: Optional[torch.Tensor] = None,
        multimodal_sequence: Optional[torch.Tensor] = None,
        multimodal_masked_sequence: Optional[torch.Tensor] = None,
        itm_labels: Optional[torch.Tensor] = None,
        mim_labels: Optional[torch.Tensor] = None,
        mlm_labels: Optional[torch.Tensor] = None,
        projected_image_embeddings: Optional[torch.Tensor] = None,
        projected_text_embeddings: Optional[torch.Tensor] = None,
    ) -> FLAVAPretrainingLossOutput:
        losses, outputs = {}, {}
        pos_weights = None  # per-sample 0/1 weights in place of a boolean row selection
        mm_masked = multimodal_masked_sequence

        if image_masked_sequence is not None and self.mim_weight > 0 and mm_masked is None:
            start = -mim_labels.shape[1] if mim_labels is not None else 1
            out = self.mim_loss(image_masked_sequence[:, start:, :], mim_labels)
            outputs["mim_output"] = out._replace(loss=out.loss * self.mim_weight)
            losses["mim_loss"] = outputs["mim_output"].loss

        if text_masked_sequence is not None and self.mlm_weight > 0 and mm_masked is None:
            start = -mlm_labels.shape[1] if mlm_labels is not None else 1
            out = self.mlm_loss(text_masked_sequence[:, start:, :], mlm_labels)
            outputs["mlm_output"] = out._replace(loss=out.loss * self.mlm_weight)
            losses["mlm_loss"] = outputs["mlm_output"].loss

        if mm_masked is not None and self.itm_loss_weight > 0:
            if itm_labels is not None:
                pos_pairs = itm_labels != 0
                # no positive pair in the batch: every sample counts
                pos_weights = torch.where(pos_pairs.any(), pos_pairs,
                                          torch.ones_like(pos_pairs)).float()
            else:
                pos_weights = torch.ones(mm_masked.shape[0], device=mm_masked.device)
            out = self.itm_loss_module(mm_masked, itm_labels)
            outputs["itm_output"] = out._replace(loss=out.loss * self.itm_loss_weight)
            losses["itm_loss"] = outputs["itm_output"].loss

        if mm_masked is not None and self.mmm_text_loss_weight > 0:
            start = (-mlm_labels.shape[1] if mlm_labels is not None
                     else -(text_masked_sequence.shape[1] - 1))
            out = self.mmm_text_loss_module(mm_masked[:, start:, :], mlm_labels, pos_weights)
            outputs["mmm_text_output"] = out._replace(loss=out.loss * self.mmm_text_loss_weight)
            losses["mmm_text_loss"] = outputs["mmm_text_output"].loss

        if mm_masked is not None and self.mmm_image_loss_weight > 0:
            total = (mim_labels.shape[1] if mim_labels is not None
                     else image_masked_sequence.shape[1] - 1)
            out = self.mmm_image_loss_module(mm_masked[:, 2:2 + total, :], mim_labels,
                                             pos_weights)
            outputs["mmm_image_output"] = out._replace(
                loss=out.loss * self.mmm_image_loss_weight)
            losses["mmm_image_loss"] = outputs["mmm_image_output"].loss

        if (projected_image_embeddings is not None and projected_text_embeddings is not None
                and self.contrastive_loss_weight > 0):
            out = self.contrastive_loss(
                projected_image_embeddings, projected_text_embeddings,
                mask=pos_weights.bool() if pos_weights is not None else None)
            outputs["global_contrastive_output"] = out._replace(
                loss=out.loss * self.contrastive_loss_weight)
            losses["global_contrastive_loss"] = outputs["global_contrastive_output"].loss

        return FLAVAPretrainingLossOutput(
            losses=FLAVAPretrainingLossesCollection(**losses), **outputs)

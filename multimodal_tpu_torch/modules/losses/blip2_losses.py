"""BLIP-2 stage-1 losses: image-text contrastive (ITC), image-text matching
with hard negatives (ITM) and image-grounded captioning (ITG). Counterpart
of ``multimodal_tpu/modules/losses/blip2_losses.py``
(``compute_image_text_similarity``, ``itc_loss``, ``itg_loss``,
``itm_loss``, ``Blip2Phase1Loss``, ``blip2_phase1_loss``).

The gathers go through ``parallel/collectives.py`` (features and ids
without gradient, the image embeddings with it), as the JAX functions'
``all_gather_with_backprop_type``; on one process they are the local
tensors. The hard negatives are ALBEF's draw
(``models/albef/model.py:hard_negative_indices``, ``torch.multinomial``
from the caller's generator): the distribution of the JAX package's
``jax.random.categorical`` over the log-softmax with the diagonal at -inf,
other draws. Similarities and losses compute in fp32.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn

from multimodal_tpu_torch.models.albef.model import hard_negative_indices
from multimodal_tpu_torch.models.blip2.blip2 import BLIP2, Blip2Output
from multimodal_tpu_torch.modules.layers.multi_head_attention import dense
from multimodal_tpu_torch.modules.losses.contrastive_loss_with_temperature import cross_entropy
from multimodal_tpu_torch.parallel.collectives import (
    BackpropType,
    all_gather_with_backprop_type,
    get_rank,
)


class Blip2Stage1Losses(NamedTuple):
    image_text_contrastive_loss: torch.Tensor
    image_text_matching_loss: torch.Tensor
    image_captioning_loss: torch.Tensor
    total_loss: torch.Tensor


def compute_image_text_similarity(image_features: torch.Tensor, text_features: torch.Tensor,
                                  temp: torch.Tensor, group=None):
    """Max-over-query-token similarities ``(sim_i2t, sim_t2i)``, each
    ``(b_local, b_global)``: image features ``(b, num_query, d)``, text
    features ``(b, d)``."""
    image_all = all_gather_with_backprop_type(image_features, group, BackpropType.NONE)
    text_all = all_gather_with_backprop_type(text_features, group, BackpropType.NONE)
    sim_i2t = torch.einsum("bqd,gd->bgq", image_features.float(), text_all.float())
    sim_t2i = torch.einsum("bd,gqd->bgq", text_features.float(), image_all.float())
    return sim_i2t.amax(dim=-1) / temp, sim_t2i.amax(dim=-1) / temp


def itc_loss(sim_i2t: torch.Tensor, sim_t2i: torch.Tensor, label_smoothing: float = 0.1,
             group=None) -> torch.Tensor:
    local_bs = sim_i2t.shape[0]
    targets = get_rank(group) * local_bs + torch.arange(local_bs, device=sim_i2t.device)
    return (cross_entropy(sim_i2t, targets, label_smoothing)
            + cross_entropy(sim_t2i, targets, label_smoothing)) / 2


def itg_loss(input_ids: torch.Tensor, prediction_scores: torch.Tensor,
             decoder_bos_token_id: int, pad_token_id: int, vocab_size: int,
             label_smoothing: float = 0.1) -> torch.Tensor:
    """Causal captioning loss: the first id replaced by BOS, pad ids left
    out, label smoothing over the vocabulary."""
    labels = input_ids.clone()
    labels[:, 0] = decoder_bos_token_id
    labels = labels[:, 1:]
    scores = prediction_scores[:, :-1].float()
    valid = labels != pad_token_id
    logp = torch.log_softmax(scores, dim=-1)
    label_logp = logp.gather(-1, torch.where(valid, labels, 0)[..., None])[..., 0]
    nll = -(1 - label_smoothing) * label_logp - label_smoothing * logp.mean(dim=-1)
    w = valid.float()
    return (nll * w).sum() / w.sum().clamp_min(1.0)


def itm_loss(model: BLIP2, itm_head, input_ids: torch.Tensor, attention_mask: torch.Tensor,
             image_embeds: torch.Tensor, sim_i2t: torch.Tensor, sim_t2i: torch.Tensor,
             generator: Optional[torch.Generator] = None, group=None,
             deterministic: bool = True) -> torch.Tensor:
    """Matching over a 3x batch (positive pairs, hard-negative images,
    hard-negative texts): the Q-Former re-run with cross-attention, the
    head's logits averaged over the query tokens."""
    local_bs = image_embeds.shape[0]
    ids_all = all_gather_with_backprop_type(input_ids, group, BackpropType.NONE)
    atts_all = all_gather_with_backprop_type(attention_mask, group, BackpropType.NONE)
    image_embeds_all = all_gather_with_backprop_type(image_embeds, group, BackpropType.GLOBAL)
    neg_img_idx, neg_txt_idx = hard_negative_indices(sim_i2t, sim_t2i, generator,
                                                     offset=get_rank(group) * local_bs)
    text_ids_3x = torch.cat([input_ids, input_ids, ids_all[neg_txt_idx]])
    text_atts_3x = torch.cat([attention_mask, attention_mask, atts_all[neg_txt_idx]])
    image_embeds_3x = torch.cat([image_embeds, image_embeds_all[neg_img_idx], image_embeds])
    vl_embeddings = model.itm_forward(text_ids_3x, text_atts_3x, image_embeds_3x, deterministic)
    itm_logits = itm_head(vl_embeddings).mean(dim=1)
    itm_labels = torch.cat([torch.ones(local_bs, dtype=torch.long),
                            torch.zeros(2 * local_bs, dtype=torch.long)]).to(itm_logits.device)
    return cross_entropy(itm_logits, itm_labels)


class Blip2Phase1Loss(nn.Module):
    """Holds the ITM head (``itm_head``) and the learned temperature
    (``temp``, fp32)."""

    def __init__(self, dim_q: int = 768, enable_itc: bool = True, enable_itm: bool = True,
                 enable_itg: bool = True, temp: float = 0.07, label_smoothing: float = 0.1):
        super().__init__()
        if not (enable_itc or enable_itm or enable_itg):
            raise ValueError("All the loss tasks are disabled, please set at least one of them.")
        self.enable_itc, self.enable_itm, self.enable_itg = enable_itc, enable_itm, enable_itg
        self.label_smoothing = label_smoothing
        self.itm_head = nn.Linear(dim_q, 2)
        self.temp = nn.Parameter(torch.tensor(temp, dtype=torch.float32))

    def forward(self, vl_embeddings: torch.Tensor) -> torch.Tensor:
        return dense(self.itm_head, vl_embeddings, vl_embeddings.dtype)


def blip2_phase1_loss(
    loss_module: Blip2Phase1Loss,
    model: BLIP2,
    model_output: Blip2Output,
    input_ids: torch.Tensor,
    attention_mask: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    decoder_bos_token_id: int = 30522,
    pad_token_id: int = 0,
    vocab_size: int = 30523,
    group=None,
    deterministic: bool = True,
) -> Blip2Stage1Losses:
    """The three stage-1 objectives over one ``BLIP2`` forward; the hard
    negatives draw from ``generator`` (on the batch's device)."""
    sim_i2t, sim_t2i = compute_image_text_similarity(
        model_output.image_features, model_output.text_features, loss_module.temp, group)
    zero = sim_i2t.new_zeros(())
    loss_itm = loss_itg = loss_itc = zero
    if loss_module.enable_itm:
        loss_itm = itm_loss(model, loss_module, input_ids, attention_mask,
                            model_output.image_embeddings, sim_i2t, sim_t2i, generator, group,
                            deterministic)
    if loss_module.enable_itg:
        loss_itg = itg_loss(input_ids, model_output.prediction_scores, decoder_bos_token_id,
                            pad_token_id, vocab_size, loss_module.label_smoothing)
    if loss_module.enable_itc:
        loss_itc = itc_loss(sim_i2t, sim_t2i, loss_module.label_smoothing, group)
    return Blip2Stage1Losses(image_text_contrastive_loss=loss_itc,
                             image_text_matching_loss=loss_itm,
                             image_captioning_loss=loss_itg,
                             total_loss=loss_itc + loss_itm + loss_itg)

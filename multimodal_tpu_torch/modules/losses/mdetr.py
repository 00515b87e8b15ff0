"""MDETR losses and the Hungarian matcher. Counterpart of
``multimodal_tpu/modules/losses/mdetr.py``.

Targets are padded to ``max_boxes`` a sample with a validity mask; the
matcher gives each sample a ``(max_boxes,)`` row of assigned query indices
(-1 for padding). The matching cost is computed on the predictions' device
and detached; the assignment itself is scipy's ``linear_sum_assignment`` on
the host (``hungarian_assignment_np``), as in the JAX package.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np
import torch
from torch.nn import functional as F


# ---------------------------------------------------------------- box utils
def box_cxcywh_to_xyxy(boxes: torch.Tensor) -> torch.Tensor:
    cx, cy, w, h = boxes.unbind(-1)
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], dim=-1)


def generalized_box_iou(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Pairwise GIoU of xyxy boxes: ``(..., n, 4) x (..., m, 4) -> (..., n,
    m)``."""
    area1 = (boxes1[..., 2] - boxes1[..., 0]) * (boxes1[..., 3] - boxes1[..., 1])
    area2 = (boxes2[..., 2] - boxes2[..., 0]) * (boxes2[..., 3] - boxes2[..., 1])
    lt = torch.maximum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.minimum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    wh = (rb - lt).clamp_min(0)
    inter = wh[..., 0] * wh[..., 1]
    union = area1[..., :, None] + area2[..., None, :] - inter
    iou = inter / union.clamp_min(1e-9)
    lt_hull = torch.minimum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb_hull = torch.maximum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    wh_hull = (rb_hull - lt_hull).clamp_min(0)
    hull = wh_hull[..., 0] * wh_hull[..., 1]
    return iou - (hull - union) / hull.clamp_min(1e-9)


# ---------------------------------------------------------------- matcher
def hungarian_cost_matrix(
    pred_logits: torch.Tensor,   # (b, q, num_tokens) raw logits
    pred_boxes: torch.Tensor,    # (b, q, 4) cxcywh
    positive_map: torch.Tensor,  # (b, max_boxes, num_tokens)
    target_boxes: torch.Tensor,  # (b, max_boxes, 4)
    cost_class: float = 1.0,
    cost_bbox: float = 5.0,
    cost_giou: float = 2.0,
) -> torch.Tensor:
    """The ``(b, q, max_boxes)`` matching cost: soft-token alignment, L1
    and GIoU."""
    probs = torch.softmax(pred_logits.float(), dim=-1)
    cost_cls = -(probs @ positive_map.float().transpose(-1, -2))
    cost_l1 = (pred_boxes[:, :, None] - target_boxes[:, None]).abs().sum(-1)
    cost_g = -generalized_box_iou(box_cxcywh_to_xyxy(pred_boxes),
                                  box_cxcywh_to_xyxy(target_boxes))
    return cost_class * cost_cls + cost_bbox * cost_l1 + cost_giou * cost_g


def hungarian_assignment_np(cost: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """For each valid target, the matched query index (host, scipy).

    cost: (b, q, max_boxes); valid: (b, max_boxes) bool. Returns (b,
    max_boxes) int32 with -1 for invalid targets.
    """
    from scipy.optimize import linear_sum_assignment

    b, q, m = cost.shape
    out = np.full((b, m), -1, np.int32)
    for i in range(b):
        n = int(valid[i].sum())
        if n == 0:
            continue
        c = np.nan_to_num(cost[i, :, :n], nan=1e6, posinf=1e6, neginf=-1e6)
        rows, cols = linear_sum_assignment(c)
        out[i, cols] = rows
    return out


def hungarian_matcher(cost: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """The assignment of a detached cost, on the cost's device."""
    out = hungarian_assignment_np(cost.detach().float().cpu().numpy(),
                                  valid.detach().cpu().numpy().astype(bool))
    return torch.from_numpy(out).to(cost.device)


# ---------------------------------------------------------------- losses
def _matched_onehot(assignment: torch.Tensor, valid: torch.Tensor, q: int) -> torch.Tensor:
    """(b, max_boxes, q): target m's matched query, 0 rows for padding."""
    safe = torch.where(valid, assignment, 0).long()
    return F.one_hot(safe, q).float() * valid[..., None].float()


def soft_token_prediction_loss(
    pred_logits: torch.Tensor,   # (b, q, num_tokens)
    positive_map: torch.Tensor,  # (b, max_boxes, num_tokens)
    assignment: torch.Tensor,    # (b, max_boxes) query index per target, -1 pad
    valid: torch.Tensor,         # (b, max_boxes)
    num_boxes,
    no_object_weight: float = 0.1,
) -> torch.Tensor:
    """NLL of each query's target token distribution: a matched query's
    positive map, else the last token (no object) at ``no_object_weight``."""
    b, q, n_tok = pred_logits.shape
    logp = torch.log_softmax(pred_logits.float(), dim=-1)
    onehot = _matched_onehot(assignment, valid, q)
    target_matched = torch.einsum("bmq,bmt->bqt", onehot, positive_map.float())
    matched = onehot.sum(1) > 0
    target = torch.zeros((b, q, n_tok), device=logp.device)
    target[:, :, -1] = 1.0
    target = torch.where(matched[..., None], target_matched, target)
    weights = torch.where(matched, 1.0, no_object_weight)
    loss = -(logp * target).sum(-1) * weights
    return loss.sum() / torch.clamp(torch.as_tensor(num_boxes), min=1.0)


class BoxLosses(NamedTuple):
    l1_loss: torch.Tensor
    giou_loss: torch.Tensor


def box_losses(
    pred_boxes: torch.Tensor,    # (b, q, 4) cxcywh
    target_boxes: torch.Tensor,  # (b, max_boxes, 4)
    assignment: torch.Tensor,    # (b, max_boxes)
    valid: torch.Tensor,         # (b, max_boxes)
    num_boxes,
) -> BoxLosses:
    """Matched L1 and GIoU losses."""
    safe = torch.where(valid, assignment, 0).long()
    matched = torch.gather(pred_boxes.float(), 1, safe[..., None].expand(-1, -1, 4))
    w = valid.float()
    nb = torch.clamp(torch.as_tensor(num_boxes), min=1.0)
    l1 = ((matched - target_boxes.float()).abs() * w[..., None]).sum() / nb
    g = generalized_box_iou(box_cxcywh_to_xyxy(matched), box_cxcywh_to_xyxy(target_boxes.float()))
    giou = ((1 - torch.diagonal(g, dim1=-2, dim2=-1)) * w).sum()
    return BoxLosses(l1, giou / nb)


def contrastive_alignment_loss(
    query_embeddings: torch.Tensor,  # (b, q, d) normalized
    token_embeddings: torch.Tensor,  # (b, L, d) normalized
    positive_map: torch.Tensor,      # (b, max_boxes, L) box -> token map
    assignment: torch.Tensor,        # (b, max_boxes)
    valid: torch.Tensor,             # (b, max_boxes)
    num_boxes,
    temperature: float = 0.07,
) -> torch.Tensor:
    """Both-way InfoNCE between matched queries and their tokens."""
    logits = torch.einsum("bqd,bld->bql", query_embeddings.float(),
                          token_embeddings.float()) / temperature
    q = logits.shape[1]
    onehot = _matched_onehot(assignment, valid, q)
    pos = torch.einsum("bmq,bml->bql", onehot, positive_map.float()) > 0

    def direction(dim: int) -> torch.Tensor:
        logp = logits - torch.logsumexp(logits, dim=dim, keepdim=True)
        npos = pos.sum(dim).clamp_min(1)
        loss = -torch.where(pos, logp, 0.0).sum(dim) / npos
        return torch.where(pos.any(dim), loss, 0.0).sum()

    nb = torch.clamp(torch.as_tensor(num_boxes), min=1.0)
    return (direction(-1) + direction(1)) / 2 / nb


class MDETRLossOutput(NamedTuple):
    soft_token_loss: torch.Tensor
    l1_loss: torch.Tensor
    giou_loss: torch.Tensor
    contrastive_alignment_loss: Optional[torch.Tensor] = None

    def total(self, weights: Optional[Dict[str, float]] = None) -> torch.Tensor:
        w = {"soft_token_loss": 1.0, "l1_loss": 5.0, "giou_loss": 2.0,
             "contrastive_alignment_loss": 1.0, **(weights or {})}
        total = 0.0
        for name, value in self._asdict().items():
            if value is not None:
                total = total + w[name] * value
        return total


def mdetr_loss(
    pred_logits: torch.Tensor,
    pred_boxes: torch.Tensor,
    positive_map: torch.Tensor,
    target_boxes: torch.Tensor,
    valid: torch.Tensor,
    query_embeddings: Optional[torch.Tensor] = None,
    token_embeddings: Optional[torch.Tensor] = None,
    align_positive_map: Optional[torch.Tensor] = None,  # (b, max_boxes, text_len)
    no_object_weight: float = 0.1,
    temperature: float = 0.07,
) -> MDETRLossOutput:
    """The MDETR objective: match, then the soft-token and box losses (and
    the contrastive alignment). ``positive_map`` maps boxes to the
    classification token bins, ``align_positive_map`` to the text tokens."""
    valid = valid.bool()
    cost = hungarian_cost_matrix(pred_logits, pred_boxes.float(), positive_map,
                                 target_boxes.float())
    assignment = hungarian_matcher(cost, valid)
    num_boxes = valid.float().sum().clamp_min(1.0)
    st = soft_token_prediction_loss(pred_logits, positive_map, assignment, valid, num_boxes,
                                    no_object_weight)
    bl = box_losses(pred_boxes, target_boxes, assignment, valid, num_boxes)
    ca = None
    if query_embeddings is not None and token_embeddings is not None:
        if align_positive_map is None:
            raise ValueError("align_positive_map required for contrastive alignment loss")
        ca = contrastive_alignment_loss(query_embeddings, token_embeddings, align_positive_map,
                                        assignment, valid, num_boxes, temperature)
    return MDETRLossOutput(st, bl.l1_loss, bl.giou_loss, ca)


# ------------------------------------------------------------ VQA head losses
def masked_dict_cross_entropy(
    pred_dict: Dict[str, torch.Tensor],
    label_dict: Dict[str, torch.Tensor],
    mask_dict: Optional[Dict[str, torch.Tensor]] = None,
) -> Dict[str, torch.Tensor]:
    """Each answer head's cross entropy, averaged over the samples whose
    answer type activates it (0 for a head with none)."""
    if pred_dict.keys() != label_dict.keys():
        raise ValueError("Keys of pred_dict and label_dict must match")
    losses = {}
    for k, logits in pred_dict.items():
        per_sample = -torch.log_softmax(logits.float(), -1).gather(
            -1, label_dict[k].long()[:, None])[:, 0]
        if mask_dict is None or mask_dict.get(k) is None:
            losses[f"{k}_loss"] = per_sample.mean()
        else:
            mask = mask_dict[k].to(per_sample.dtype)
            losses[f"{k}_loss"] = (per_sample * mask).sum() / mask.sum().clamp_min(1.0)
    return losses


def masked_dict_accuracy(
    pred_dict: Dict[str, torch.Tensor],
    label_dict: Dict[str, torch.Tensor],
    mask_dict: Optional[Dict[str, torch.Tensor]] = None,
    answer_type_key: str = "answer_type",
) -> Dict[str, torch.Tensor]:
    """Each head's masked accuracy (1.0 for a head with no active sample)
    and the combined GQA accuracy."""
    accuracies, mask_counts = {}, {}
    for k, logits in pred_dict.items():
        correct = (logits.argmax(-1) == label_dict[k]).float()
        mask = (torch.ones_like(correct) if mask_dict is None or mask_dict.get(k) is None
                else mask_dict[k].float())
        count = mask.sum()
        mask_counts[k] = count
        accuracies[f"{k}_accuracy"] = torch.where(
            count > 0, (correct * mask).sum() / count.clamp_min(1.0), 1.0)
    weighted = sum(accuracies[f"{k}_accuracy"] * mask_counts[k]
                   for k in pred_dict if k != answer_type_key)
    batch = label_dict[answer_type_key].shape[0]
    accuracies["answer_total_accuracy"] = (
        accuracies[f"{answer_type_key}_accuracy"] * weighted / batch)
    return accuracies


def build_weight_dict(
    ce_loss_coef: float = 1.0,
    bbox_loss_coef: float = 5.0,
    giou_loss_coef: float = 2.0,
    qa_loss_coef: float = 1.0,
    contrastive_align_loss_coef: float = 1.0,
    vqa_keys=None,
    include_contrastive_loss: bool = True,
) -> Dict[str, float]:
    """The loss terms' weights."""
    weights = {"soft_token_loss": ce_loss_coef, "l1_loss": bbox_loss_coef,
               "giou_loss": giou_loss_coef}
    if vqa_keys is not None:
        for k in vqa_keys:
            weights[f"{k}_loss"] = qa_loss_coef
    if include_contrastive_loss:
        weights["contrastive_alignment_loss"] = contrastive_align_loss_coef
    return weights

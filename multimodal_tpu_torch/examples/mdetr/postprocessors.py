"""MDETR evaluation postprocessors. Counterpart of
``multimodal_tpu/examples/mdetr/postprocessors.py``: the whole batch of
phrases is scored and sorted at once on the outputs' device (phrases
flattened across the batch and mapped back to their sample by an index
vector); only the nested lists are made on the host."""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from multimodal_tpu_torch.modules.losses.mdetr import box_cxcywh_to_xyxy


def _score_and_sort_boxes(prob: torch.Tensor, boxes_abs: torch.Tensor,
                          positive_map: torch.Tensor, phrase_to_sample: torch.Tensor
                          ) -> torch.Tensor:
    """(p, q, 4) boxes for each phrase, by descending score: the largest
    probability over the phrase's positive tokens."""
    pos = (positive_map > 1e-6).to(prob.dtype)
    scores = (pos[:, None, :] * prob[phrase_to_sample]).amax(-1)  # (p, q)
    order = torch.argsort(-scores, dim=-1, stable=True)
    return torch.gather(boxes_abs[phrase_to_sample], 1, order[:, :, None].expand(-1, -1, 4))


def _scale_boxes(output_bbox: torch.Tensor, target_sizes: torch.Tensor) -> torch.Tensor:
    """cxcywh relative -> xyxy absolute."""
    boxes = box_cxcywh_to_xyxy(output_bbox)
    img_h, img_w = target_sizes[:, 0], target_sizes[:, 1]
    scale = torch.stack([img_w, img_h, img_w, img_h], dim=1)
    return boxes * scale[:, None, :].to(boxes.dtype)


def post_process_flickr(
    output_logits: torch.Tensor,   # (b, q, num_classes)
    output_bbox: torch.Tensor,     # (b, q, 4) cxcywh in [0, 1]
    target_sizes: torch.Tensor,    # (b, 2) original (h, w) per image
    positive_map: torch.Tensor,    # (total_phrases, num_classes)
    phrases_per_sample: Sequence[int],
) -> List[List[List[List[float]]]]:
    """``out[sample][phrase]``: that phrase's ``[x0, y0, x1, y1]`` boxes
    by descending confidence, for ``Flickr30kEntitiesRecallEvaluator``."""
    batch_size = int(output_logits.shape[0])
    target_sizes = torch.as_tensor(target_sizes, device=output_logits.device)
    if target_sizes.shape[0] != batch_size or target_sizes.shape[1] != 2:
        raise ValueError("target_sizes must be (batch_size, 2)")
    phrases_per_sample = [int(n) for n in phrases_per_sample]
    total = sum(phrases_per_sample)
    if positive_map.shape[0] != total:
        raise ValueError("first dim of positive_map must equal sum of phrases_per_sample")
    out: List[List[List[List[float]]]] = [[] for _ in range(batch_size)]
    if total == 0:
        return out
    phrase_to_sample = torch.from_numpy(
        np.repeat(np.arange(batch_size), phrases_per_sample)).to(output_logits.device)
    prob = torch.softmax(output_logits, dim=-1)
    boxes_abs = _scale_boxes(output_bbox, target_sizes)
    sorted_boxes = _score_and_sort_boxes(
        prob, boxes_abs, torch.as_tensor(positive_map, device=prob.device),
        phrase_to_sample).float().cpu().numpy()
    offset = 0
    for sample, n in enumerate(phrases_per_sample):
        for p in range(n):
            out[sample].append(sorted_boxes[offset + p].tolist())
        offset += n
    return out

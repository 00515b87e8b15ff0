"""MDETR phrase-grounding evaluation loop. Counterpart of
``multimodal_tpu/examples/mdetr/eval.py``: run the model over batches,
post-process into per-phrase ranked boxes, score them with the Flickr30k
evaluator.

Each batch carries the model's inputs (``images (b, H, W, 3)``,
``image_mask (b, H, W)``, ``text (b, L)``, ``text_mask (b, L)``, masks True
= padded, as ``models/mdetr/model.py:pad_images`` / ``pad_text`` make
them) and the eval's metadata: ``orig_sizes (b, 2)``, ``positive_map_eval
(P, num_classes)``, ``phrases_per_sample``, ``image_ids``,
``sentence_ids``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, List

import torch

from multimodal_tpu_torch.examples.mdetr.flickr_eval import Flickr30kEntitiesRecallEvaluator
from multimodal_tpu_torch.examples.mdetr.postprocessors import post_process_flickr


def evaluate_phrase_grounding(
    apply_fn: Callable,  # (images, image_mask, text, text_mask) -> MDETRPhraseGroundingOutput
    batches: Iterable[Dict[str, Any]],
    evaluator: Flickr30kEntitiesRecallEvaluator,
    device=None,
) -> Dict[int, Dict[str, float]]:
    """The evaluator's Recall@k report; the batches' arrays go to
    ``device`` (as they are when None) and ``apply_fn`` runs under
    ``torch.no_grad``."""
    predictions: List[Dict[str, Any]] = []
    to = (lambda x: torch.as_tensor(x, device=device)) if device is not None \
        else torch.as_tensor
    for batch in batches:
        with torch.no_grad():
            out = apply_fn(to(batch["images"]), to(batch["image_mask"]), to(batch["text"]),
                           to(batch["text_mask"]))
            ranked = post_process_flickr(
                out.model_output.pred_logits.float(), out.model_output.pred_boxes.float(),
                to(batch["orig_sizes"]).float(), to(batch["positive_map_eval"]),
                batch["phrases_per_sample"])
        for img_id, sent_id, boxes in zip(batch["image_ids"], batch["sentence_ids"], ranked):
            predictions.append({"image_id": img_id, "sentence_id": sent_id, "boxes": boxes})
    return evaluator.evaluate(predictions)

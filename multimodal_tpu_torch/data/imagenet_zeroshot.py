"""ImageNet zero-shot evaluation data and protocol. Counterpart of
``multimodal_tpu/data/imagenet_zeroshot.py``.

The 1,000 ImageNet class names and OpenAI CLIP's 80 prompt templates are
a JSON asset, ``assets/imagenet_zeroshot.json`` (this package's copy of the
JAX package's). ``imagenet_zero_shot_eval`` builds the classifier from every
class x template, then counts top-k hits of normalised image embeddings
against it over a stream of batches.
"""

from __future__ import annotations

import json
import os
from functools import lru_cache
from typing import Callable, Dict, Iterable, List, Sequence

import numpy as np
import torch

from multimodal_tpu_torch.training.zero_shot import (
    build_zero_shot_classifier,
    logits_against,
    top_k_correct,
    zero_shot_accuracy,
)

_ASSET = os.path.join(os.path.dirname(__file__), "assets", "imagenet_zeroshot.json")


@lru_cache(maxsize=1)
def _load_asset() -> dict:
    with open(_ASSET) as f:
        return json.load(f)


def imagenet_classnames() -> List[str]:
    """The 1,000 ImageNet-1k class names (open_clip's wording)."""
    return list(_load_asset()["classnames"])


def imagenet_templates() -> List[str]:
    """The 80 OpenAI CLIP prompt templates as ``str.format`` strings."""
    return list(_load_asset()["templates"])


def imagenet_zero_shot_eval(
    encode_image: Callable[[np.ndarray], torch.Tensor],
    encode_text: Callable[[torch.Tensor], torch.Tensor],
    tokenize: Callable[[Sequence[str]], torch.Tensor],
    batches: Iterable[Dict[str, np.ndarray]],
    classnames: Sequence[str] = None,
    templates: Sequence[str] = None,
    top_k: Sequence[int] = (1, 5),
) -> Dict[str, float]:
    """The whole protocol over a stream of ``{"image": ..., "labels": ...}``
    batches; ``encode_image`` maps the image field to embeddings."""
    classnames = imagenet_classnames() if classnames is None else classnames
    templates = imagenet_templates() if templates is None else templates
    classifier = build_zero_shot_classifier(encode_text, tokenize, classnames, templates)
    correct = {k: 0 for k in top_k}
    total = 0
    for batch in batches:
        logits = logits_against(encode_image(batch["image"]), classifier)
        labels = torch.as_tensor(np.asarray(batch["labels"]))
        for k, hit in top_k_correct(logits, labels, top_k).items():
            correct[k] += int(hit.sum())
        total += labels.shape[0]
    return {f"top{k}": correct[k] / max(total, 1) for k in top_k}


__all__ = [
    "imagenet_classnames",
    "imagenet_templates",
    "imagenet_zero_shot_eval",
    "build_zero_shot_classifier",
    "zero_shot_accuracy",
]

"""Zero-shot classification (CLIP-style). Counterpart of
``multimodal_tpu/training/zero_shot.py``.

A classifier is built from class names x prompt templates through the text
encoder (each class's prompt embeddings normalised, averaged and
normalised again), and normalised image embeddings are scored against it.
The arithmetic runs on the device and in the dtype of what the encoders
return; numpy arrays (an ``EmbeddingServer``'s output) become CPU tensors.
"""

from __future__ import annotations

from typing import Callable, List, Sequence

import torch

# The 7-template subset of OpenAI's CLIP prompts, for cheap in-training
# eval; the full 80-template x 1,000-class ImageNet protocol is
# ``data/imagenet_zeroshot.py``.
DEFAULT_PROMPT_TEMPLATES = (
    "itap of a {}.",
    "a bad photo of the {}.",
    "a origami {}.",
    "a photo of the large {}.",
    "a {} in a video game.",
    "art of the {}.",
    "a photo of the small {}.",
)


def _normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp_min(1e-12)


def build_zero_shot_classifier(
    encode_text: Callable[[torch.Tensor], torch.Tensor],
    tokenize: Callable[[List[str]], torch.Tensor],
    classnames: Sequence[str],
    templates: Sequence[str] = DEFAULT_PROMPT_TEMPLATES,
    batch_size: int = 64,
) -> torch.Tensor:
    """Returns the ``(embed_dim, n_classes)`` classifier: for each class,
    all its prompts encoded, normalised, averaged and normalised again;
    ``batch_size`` classes' prompts go to ``encode_text`` at a time."""
    weights = []
    for i in range(0, len(classnames), batch_size):
        chunk = classnames[i : i + batch_size]
        prompts = [t.format(name) for name in chunk for t in templates]
        emb = _normalize(torch.as_tensor(encode_text(tokenize(prompts))))
        emb = emb.reshape(len(chunk), len(templates), -1).mean(dim=1)
        weights.append(_normalize(emb))
    return torch.cat(weights, dim=0).T


def logits_against(embeddings: torch.Tensor, classifier: torch.Tensor) -> torch.Tensor:
    """Normalised ``embeddings`` times the classifier, on the embeddings'
    device, in the wider of the two dtypes (as JAX promotes them)."""
    emb = _normalize(torch.as_tensor(embeddings))
    dtype = torch.promote_types(emb.dtype, classifier.dtype)
    return emb.to(dtype) @ classifier.to(emb.device, dtype)


def top_k_correct(logits: torch.Tensor, labels: torch.Tensor, top_k: Sequence[int]) -> dict:
    """Per k, a bool per row: whether its label is among the row's k
    highest logits (ties in index order, as a stable sort of the negated
    logits gives them)."""
    top = torch.argsort(-logits, dim=-1, stable=True)[:, : max(top_k)]
    labels = torch.as_tensor(labels, device=top.device)
    return {k: (top[:, :k] == labels[:, None]).any(dim=1) for k in top_k}


def zero_shot_accuracy(
    image_embeddings: torch.Tensor,
    labels: torch.Tensor,
    classifier: torch.Tensor,
    top_k: Sequence[int] = (1, 5),
) -> dict:
    """Top-k accuracy of normalized image embeddings vs the classifier."""
    correct = top_k_correct(logits_against(image_embeddings, classifier), labels, top_k)
    return {f"top{k}": float(c.float().mean()) for k, c in correct.items()}

"""COCO-caption zero-shot retrieval. Counterpart of
``multimodal_tpu/examples/flava/coco_zero_shot.py``.

Every (image, first caption) pair of a caption dataset (any
``load_dataset`` source: jsonl, arrow, an image folder with captions) is
encoded with the contrastive projections, batch by batch on the model's
device, and Recall@k is computed both ways (``training/retrieval_eval.py``).
``build_coco_eval`` gives a ``Trainer`` ``eval_fn`` for the pretraining
recipe's ``data.coco_path``.

    python -m multimodal_tpu_torch.examples.flava.coco_zero_shot \\
        data.coco_path=captions.jsonl [train.checkpoint_dir=...]
"""

from __future__ import annotations

import argparse
from typing import Any, Callable, Dict, Iterator, Sequence

import numpy as np
import torch

from multimodal_tpu_torch.training.retrieval_eval import retrieval_recall_at_k


def coco_caption_batches(
    dataset,
    image_transform: Callable,
    text_transform: Callable[[Sequence[str]], Any],
    batch_size: int = 64,
    image_key: str = "image",
    text_key: str = "text",
) -> Iterator[Dict[str, np.ndarray]]:
    """(image, first caption) batches over a caption dataset."""
    images, texts = [], []
    for i in range(len(dataset)):
        sample = dataset[i]
        caption = sample[text_key]
        if isinstance(caption, (list, tuple)):
            caption = caption[0]
        images.append(np.asarray(image_transform(sample[image_key])))
        texts.append(np.asarray(text_transform([caption]))[0])
        if len(images) == batch_size:
            yield {"image": np.stack(images), "text": np.stack(texts)}
            images, texts = [], []
    if images:
        yield {"image": np.stack(images), "text": np.stack(texts)}


def coco_retrieval_eval(
    encode_image: Callable[[np.ndarray], torch.Tensor],
    encode_text: Callable[[np.ndarray], torch.Tensor],
    batches: Iterator[Dict[str, np.ndarray]],
    ks: Sequence[int] = (1, 5, 10),
) -> Dict[str, float]:
    """Encodes the pairs and returns ``image_to_text_recall@k`` and
    ``text_to_image_recall@k``; the embeddings are normalised inside."""
    image_embeds, text_embeds = [], []
    for batch in batches:
        image_embeds.append(torch.as_tensor(encode_image(batch["image"])).float())
        text_embeds.append(torch.as_tensor(encode_text(batch["text"])).float())
    recalls = retrieval_recall_at_k(torch.cat(image_embeds), torch.cat(text_embeds), ks=ks)
    out: Dict[str, float] = {}
    for k in ks:
        out[f"image_to_text_recall@{k}"] = recalls[f"a2b_recall_{k}"]
        out[f"text_to_image_recall@{k}"] = recalls[f"b2a_recall_{k}"]
    return out


def build_coco_eval(cfg: Dict[str, Any]) -> Callable[[torch.nn.Module], Dict[str, float]]:
    """``eval_fn(model)``: COCO retrieval over ``data.coco_path`` (its
    ``val`` split when it has one) with the model's contrastive
    projections (``FLAVAForPreTraining.encode_image`` / ``encode_text``)."""
    from multimodal_tpu_torch.data.datasets import load_dataset
    from multimodal_tpu_torch.examples.flava.pretrain import (
        _encoders,
        build_text_transform,
        flava_eval_image_transform,
    )

    d = cfg["data"]
    dataset = load_dataset(d["coco_path"], split="val")
    image_transform = flava_eval_image_transform(cfg)
    tokenize = build_text_transform(cfg)

    def eval_fn(model) -> Dict[str, float]:
        encode_image, encode_text = _encoders(model)
        return coco_retrieval_eval(
            encode_image, encode_text,
            coco_caption_batches(dataset, image_transform, tokenize,
                                 batch_size=d["eval_batch_size"], image_key=d["image_key"],
                                 text_key=d["text_key"]))

    return eval_fn


def main(argv=None) -> Dict[str, float]:
    """Recall@k of the recipe's model (from ``train.checkpoint_dir``'s
    newest checkpoint when given, random weights otherwise)."""
    from multimodal_tpu_torch.examples.flava.pretrain import DEFAULTS, build_model
    from multimodal_tpu_torch.training.checkpoint import CheckpointManager
    from multimodal_tpu_torch.utils.config import build_config

    parser = argparse.ArgumentParser(description="COCO zero-shot retrieval")
    parser.add_argument("--config", default=None, help="YAML config path")
    parser.add_argument("--device", default=None,
                        help="default CUDA; 'cpu' runs the kernels' plain versions")
    parser.add_argument("overrides", nargs="*", help="dotlist overrides a.b=c")
    args = parser.parse_args(argv)
    cfg = build_config(args.config, args.overrides, defaults=DEFAULTS)
    if not cfg["data"].get("coco_path"):
        raise SystemExit("set data.coco_path=<caption dataset>")
    model = build_model(cfg, device=args.device)
    ckpt = cfg["train"].get("checkpoint_dir")
    if ckpt:
        model.load_state_dict(CheckpointManager(ckpt).restore()["model"])
    with torch.no_grad():
        metrics = build_coco_eval(cfg)(model)
    for k, v in metrics.items():
        print(f"{k} {v:.4f}")
    return metrics


if __name__ == "__main__":
    main()

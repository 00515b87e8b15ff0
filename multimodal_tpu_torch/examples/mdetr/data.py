"""MDETR data layer: the positive map and the data module. Counterpart of
``multimodal_tpu/examples/mdetr/data.py``.

``create_positive_map`` aligns each box with the token bins its phrase's
character spans overlap; ``MDETRDataModule`` pads boxes and maps to static
``(max_boxes, num_bins)`` shapes on the host and ragged images through
``models/mdetr/model.py:pad_images``. The tokenizer is
``tokenize_with_offsets(text) -> (ids, offsets)`` with per-token
``(char_start, char_end)``; a whitespace + CRC32 fallback ships for tests
and runs without assets. With ``image_size`` a PIL image is resized (to
``image_size`` square, bicubic, PIL's default) by the port's copy of PIL's
resampler (``native/resample.py``); arrays pass through, as in the JAX
module.
"""

from __future__ import annotations

import zlib
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from multimodal_tpu_torch.data.datamodules import DataModule, _to_image
from multimodal_tpu_torch.models.mdetr.model import pad_images


def whitespace_tokenize_with_offsets(
    text: str, vocab_size: int = 30522, base: int = 1000
) -> Tuple[List[int], List[Tuple[int, int]]]:
    """Deterministic word-level fallback tokenizer with char offsets."""
    ids, offsets = [], []
    pos = 0
    for word in text.split():
        start = text.index(word, pos)
        end = start + len(word)
        ids.append(base + zlib.crc32(word.lower().encode()) % (vocab_size - base))
        offsets.append((start, end))
        pos = end
    return ids, offsets


def create_positive_map(
    offsets: Sequence[Tuple[int, int]],
    tokens_positive: Sequence[Sequence[Tuple[int, int]]],
    num_bins: int = 256,
) -> np.ndarray:
    """``positive_map[i, t] = 1`` iff box i's char span overlaps token t's;
    rows normalized to sum to 1 (the soft-token target distribution)."""
    positive_map = np.zeros((len(tokens_positive), num_bins), np.float32)
    for j, spans in enumerate(tokens_positive):
        for beg, end in spans:
            for t, (ts, te) in enumerate(offsets):
                if t >= num_bins:
                    break
                if ts < end and te > beg:
                    positive_map[j, t] = 1.0
    return positive_map / (positive_map.sum(-1, keepdims=True) + 1e-6)


def _resized(img, size: int):
    """A PIL image resized to ``size`` x ``size`` as ``img.resize`` does
    (bicubic), through the native resampler; other images as they are."""
    if isinstance(img, np.ndarray) or not hasattr(img, "resize"):
        return img
    from multimodal_tpu_torch.native.resample import resample_native

    return resample_native(np.asarray(img.convert("RGB")), (size, size), "bicubic")


class MDETRDataModule(DataModule):
    """Samples {image, text, boxes (cxcywh normalized), tokens_positive}
    -> the padded batch ``mdetr_loss`` takes: images / image_mask, text /
    text_attention_mask (True = a token), positive_map (b, max_boxes,
    num_bins), target_boxes, valid (and answers / answer_type_mask passed
    through when present)."""

    def __init__(
        self,
        dataset,
        tokenize_with_offsets: Callable = whitespace_tokenize_with_offsets,
        max_boxes: int = 16,
        num_bins: int = 256,
        text_len: int = 64,
        image_size: Optional[int] = None,
        **kwargs,
    ):
        super().__init__(dataset, **kwargs)
        self.tokenize_with_offsets = tokenize_with_offsets
        self.max_boxes = max_boxes
        self.num_bins = num_bins
        self.text_len = text_len
        self.image_size = image_size

    def process(self, sample: Dict[str, Any], rng) -> Dict[str, np.ndarray]:
        img = _to_image(sample["image"])
        if self.image_size is not None:
            img = _resized(img, self.image_size)
        img = np.asarray(img, np.float32)
        if img.max() > 1.5:
            img = img / 255.0

        ids, offsets = self.tokenize_with_offsets(sample["text"])
        ids = ids[: self.text_len]
        text = np.zeros((self.text_len,), np.int32)
        text[: len(ids)] = ids
        text_mask = np.zeros((self.text_len,), bool)
        text_mask[: len(ids)] = True

        boxes = np.asarray(sample["boxes"], np.float32).reshape(-1, 4)
        n = min(len(boxes), self.max_boxes)
        target_boxes = np.zeros((self.max_boxes, 4), np.float32)
        target_boxes[:n] = boxes[:n]
        valid = np.zeros((self.max_boxes,), bool)
        valid[:n] = True

        pm = create_positive_map(offsets, sample["tokens_positive"][:n], num_bins=self.num_bins)
        positive_map = np.zeros((self.max_boxes, self.num_bins), np.float32)
        positive_map[:n] = pm

        out = {"image": img, "text": text, "text_attention_mask": text_mask,
               "positive_map": positive_map, "target_boxes": target_boxes, "valid": valid}
        for key in ("answers", "answer_type_mask"):
            if key in sample:
                out[key] = sample[key]
        return out

    def collate(self, samples):
        # ragged images -> a padded batch and its mask; the rest stacks
        images, image_mask = pad_images([s.pop("image") for s in samples])
        rest: Dict[str, Any] = {}
        for key, v0 in samples[0].items():
            if isinstance(v0, dict):  # answers / answer_type_mask
                rest[key] = {k: np.stack([np.asarray(s[key][k]) for s in samples]) for k in v0}
            else:
                rest[key] = np.stack([np.asarray(s[key]) for s in samples])
        return {"images": images, "image_mask": image_mask, **rest}

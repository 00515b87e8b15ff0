"""ALBEF data layer: retrieval and VQA. Counterpart of
``multimodal_tpu/examples/albef/data.py`` (``RetrievalTrainingDataModule``,
``retrieval_eval_data``, ``VQADataModule``) on the port's
``data/datamodules.py:DataModule``: host-side numpy samples, batches out as
CPU tensors.

- Retrieval training: json annotations ``{image, caption, image_id}`` ->
  ``{image, text, text_atts, idx}``, string image ids densely re-indexed in
  order of first appearance (the queue targets' ids).
- Retrieval eval: the unique images, the flat caption list and the
  image <-> text ground-truth maps of the Recall@k protocol.
- VQA: a question and its de-duplicated answers with occurrence weights
  (visual-genome samples a single answer at weight 0.5), padded to
  ``max_answers`` rows of ``answer_len`` tokens; the test split gives the
  question id.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from multimodal_tpu_torch.data.datamodules import DataModule, _to_image


def _load_ann(ann_file) -> List[dict]:
    files = [ann_file] if isinstance(ann_file, str) else list(ann_file)
    ann: List[dict] = []
    for f in files:
        with open(f) as fh:
            ann += json.load(fh)
    return ann


def _pad(ids, length: int) -> np.ndarray:
    out = np.zeros((length,), np.int32)
    ids = np.asarray(ids)[:length]
    out[: len(ids)] = ids
    return out


class RetrievalTrainingDataModule(DataModule):
    """``{image, text, text_atts, idx}`` batches for
    ``albef_retrieval_train_step``."""

    def __init__(self, ann_file, image_root: str, image_transform: Callable,
                 text_transform: Callable[[Sequence[str]], np.ndarray], text_len: int = 30,
                 **kwargs):
        ann = _load_ann(ann_file)
        super().__init__(ann, **kwargs)
        self.image_root = image_root
        self.image_transform = image_transform
        self.text_transform = text_transform
        self.text_len = text_len
        self.idx: Dict[str, int] = {}
        for a in ann:
            self.idx.setdefault(a["image_id"], len(self.idx))

    def _text(self, caption: str) -> Tuple[np.ndarray, np.ndarray]:
        text = _pad(np.asarray(self.text_transform([caption]))[0], self.text_len)
        return text, text != 0

    def process(self, sample, rng):
        image = self.image_transform(_to_image(os.path.join(self.image_root, sample["image"])))
        text, atts = self._text(sample["caption"])
        return {"image": np.asarray(image), "text": text, "text_atts": atts,
                "idx": np.asarray(self.idx[sample["image_id"]], np.int32)}


def retrieval_eval_data(ann_file, image_root: str) -> Dict[str, object]:
    """The eval corpora: ``images`` (paths), ``texts``, ``image_to_text``
    (image index -> caption indices) and ``text_to_image``."""
    images, texts = [], []
    image_to_text: Dict[int, List[int]] = {}
    text_to_image: List[int] = []
    for image_id, a in enumerate(_load_ann(ann_file)):
        images.append(os.path.join(image_root, a["image"]))
        captions = a["caption"] if isinstance(a["caption"], list) else [a["caption"]]
        image_to_text[image_id] = list(range(len(texts), len(texts) + len(captions)))
        texts.extend(captions)
        text_to_image.extend([image_id] * len(captions))
    return {"images": images, "texts": texts, "image_to_text": image_to_text,
            "text_to_image": text_to_image}


class VQADataModule(DataModule):
    """Train: ``{image, question, question_atts, answers (A, L), answer_atts,
    answer_weights (A,), answer_counts}``, the first ``answer_counts`` rows
    the question's answers and the rest padding (``vqa_answer_loss`` decodes
    only those rows); test: ``{image, question, question_atts,
    question_id}`` (the test split reads ``answer_list``)."""

    def __init__(self, ann_file, vqa_root: str, vg_root: str, image_transform: Callable,
                 question_transform: Callable[[Sequence[str]], np.ndarray],
                 answer_transform: Optional[Callable[[Sequence[str]], np.ndarray]] = None,
                 split: str = "train", answer_list: Optional[str] = None,
                 max_answers: int = 10, question_len: int = 30, answer_len: int = 10,
                 **kwargs):
        super().__init__(_load_ann(ann_file), **kwargs)
        self.vqa_root = vqa_root
        self.vg_root = vg_root
        self.image_transform = image_transform
        self.question_transform = question_transform
        self.answer_transform = answer_transform or question_transform
        self.split = split
        self.max_answers = max_answers
        self.question_len = question_len
        self.answer_len = answer_len
        self.answer_list = None
        if split == "test":
            if answer_list is None:
                raise ValueError("test split requires answer_list")
            with open(answer_list) as f:
                self.answer_list = json.load(f)

    def process(self, sample, rng):
        is_vqa = sample.get("dataset", "vqa") == "vqa"
        root = self.vqa_root if is_vqa else self.vg_root
        image = self.image_transform(_to_image(os.path.join(root, sample["image"])))
        question = _pad(np.asarray(self.question_transform([sample["question"]]))[0],
                        self.question_len)
        out = {"image": np.asarray(image), "question": question,
               "question_atts": question != 0}
        if self.split == "test":
            out["question_id"] = np.asarray(sample["question_id"], np.int32)
            return out
        if is_vqa:
            weights: Dict[str, float] = {}
            for answer in sample["answer"]:
                weights[answer] = weights.get(answer, 0.0) + 1 / len(sample["answer"])
            answers, answer_weights = list(weights), list(weights.values())
        else:
            answers, answer_weights = [sample["answer"]], [0.5]
        a_ids = np.asarray(self.answer_transform(answers[: self.max_answers]))
        answer_mat = np.zeros((self.max_answers, self.answer_len), np.int32)
        w = np.zeros((self.max_answers,), np.float32)
        n = min(len(answers), self.max_answers)
        for i in range(n):
            answer_mat[i] = _pad(a_ids[i], self.answer_len)
            w[i] = answer_weights[i]
        out["answers"] = answer_mat
        out["answer_atts"] = answer_mat != 0
        out["answer_weights"] = w
        out["answer_counts"] = np.asarray(n, np.int64)
        return out

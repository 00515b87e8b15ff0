"""Flickr30k Entities phrase-grounding Recall@k evaluator. The port's copy of
``multimodal_tpu/examples/mdetr/flickr_eval.py`` (numpy and XML, no JAX):
parse the Flickr30k Entities sentence and Annotation formats, then score
ranked per-phrase box predictions (from ``postprocessors.py:
post_process_flickr``) against the ground truth at IoU >= a threshold for
each recall cutoff, split by phrase category. The evaluator also takes
annotations already parsed (``from_annotations``).
"""

from __future__ import annotations

import xml.etree.ElementTree as ET
from collections import defaultdict
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np


def get_sentence_data(filename) -> List[Dict[str, Any]]:
    """Parse a Flickr30k Entities sentence file.

    Each line is a sentence where phrases appear as
    ``[/EN#<id>/<type1>/<type2> word word]``. Returns, per sentence, the plain
    text plus a list of phrase dicts (``phrase``, ``first_word_index``,
    ``phrase_id``, ``phrase_type``) — same contract as the reference
    (``flickr_eval.py:22-94``).
    """
    with open(filename, "r") as f:
        lines = f.read().split("\n")

    annotations = []
    for line in lines:
        if not line:
            continue
        words: List[str] = []
        phrases: List[Dict[str, Any]] = []
        current: List[str] = []
        current_meta: Optional[Dict[str, Any]] = None
        for token in line.split():
            if current_meta is not None:
                closing = token.endswith("]")
                word = token[:-1] if closing else token
                current.append(word)
                words.append(word)
                if closing:
                    current_meta["phrase"] = " ".join(current)
                    phrases.append(current_meta)
                    current, current_meta = [], None
            elif token.startswith("["):
                parts = token.split("/")
                current_meta = {
                    "first_word_index": len(words),
                    "phrase_id": parts[1][3:],  # strip "EN#"
                    "phrase_type": parts[2:],
                }
            else:
                words.append(token)
        annotations.append({"sentence": " ".join(words), "phrases": phrases})
    return annotations


def get_annotations(filename) -> Dict[str, Any]:
    """Parse a Flickr30k Entities Annotations/*.xml file.

    Returns ``{"boxes": {phrase_id: [[x1,y1,x2,y2], ...]}, "nobox": [...],
    "scene": [...], "height"/"width"/"depth": int}`` — same contract as the
    reference (``flickr_eval.py:97-155``).
    """
    root = ET.parse(filename).getroot()
    info: Dict[str, Any] = {}
    for el in root.findall("size")[0]:
        info[el.tag] = int(el.text)
    boxes: Dict[str, List[List[int]]] = {}
    nobox: List[str] = []
    scene: List[str] = []
    for obj in root.findall("object"):
        for name in obj.findall("name"):
            box_id = name.text
            bnd = obj.findall("bndbox")
            if bnd:
                coords = [int(bnd[0].findall(tag)[0].text)
                          for tag in ("xmin", "ymin", "xmax", "ymax")]
                boxes.setdefault(box_id, []).append(coords)
            else:
                if int(obj.findall("nobndbox")[0].text) > 0:
                    nobox.append(box_id)
                if int(obj.findall("scene")[0].text) > 0:
                    scene.append(box_id)
    info.update(boxes=boxes, nobox=nobox, scene=scene)
    return info


def merge_boxes(boxes: List[List[int]]) -> List[List[int]]:
    """Smallest enclosing box of all boxes (ref ``flickr_eval.py:158-175``)."""
    if len(boxes) == 1:
        return boxes
    b = np.asarray(boxes)
    return [[int(b[:, 0].min()), int(b[:, 1].min()),
             int(b[:, 2].max()), int(b[:, 3].max())]]


def box_iou_xyxy(boxes1: np.ndarray, boxes2: np.ndarray) -> np.ndarray:
    """Pairwise IoU of two (n, 4) / (m, 4) xyxy box arrays -> (n, m)."""
    boxes1 = np.asarray(boxes1, np.float64)
    boxes2 = np.asarray(boxes2, np.float64)
    area1 = (boxes1[:, 2] - boxes1[:, 0]) * (boxes1[:, 3] - boxes1[:, 1])
    area2 = (boxes2[:, 2] - boxes2[:, 0]) * (boxes2[:, 3] - boxes2[:, 1])
    lt = np.maximum(boxes1[:, None, :2], boxes2[None, :, :2])
    rb = np.minimum(boxes1[:, None, 2:], boxes2[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    union = area1[:, None] + area2[None, :] - inter
    return inter / np.maximum(union, 1e-12)


class RecallTracker:
    """Recall@k accumulator split by category (ref ``metrics.py:192-232``)."""

    def __init__(self, topk: Sequence[int]):
        self.total: Dict[int, Dict[str, int]] = {k: defaultdict(int) for k in topk}
        self.positives: Dict[int, Dict[str, int]] = {k: defaultdict(int) for k in topk}

    def add_positive(self, k: int, category: str) -> None:
        if k not in self.total:
            raise RuntimeError(f"{k} is not a valid recall threshold")
        self.total[k][category] += 1
        self.positives[k][category] += 1

    def add_negative(self, k: int, category: str) -> None:
        if k not in self.total:
            raise RuntimeError(f"{k} is not a valid recall threshold")
        self.total[k][category] += 1

    def report(self) -> Dict[int, Dict[str, float]]:
        return {
            k: {cat: self.positives[k][cat] / self.total[k][cat]
                for cat in self.total[k]}
            for k in self.total
        }


class Flickr30kEntitiesRecallEvaluator:
    """Recall@k protocol over ranked per-phrase boxes.

    Construct either from the dataset layout on disk (``flickr_path`` with
    ``{subset}.txt`` / ``Sentences/`` / ``Annotations/``, like the reference
    ``flickr_eval.py:178-238``) or directly from parsed annotations via
    :meth:`from_annotations` (useful for tests and custom data plumbing).
    """

    def __init__(
        self,
        flickr_path: Optional[Union[str, Path]] = None,
        subset: str = "test",
        topk: Sequence[int] = (1, 5, 10, -1),
        iou_thresh: float = 0.5,
        merge: bool = False,
    ):
        self.topk = tuple(topk)
        self.iou_thresh = iou_thresh
        self.imgid2boxes: Dict[str, Dict[str, List[List[int]]]] = {}
        self.imgid2sentences: Dict[str, List[Optional[List[Dict]]]] = {}
        self.all_ids: List[str] = []
        if flickr_path is None:
            return
        if subset not in ("train", "test", "val"):
            raise ValueError(f"wrong flickr subset {subset}")
        flickr_path = Path(flickr_path)
        with open(flickr_path / f"{subset}.txt") as f:
            img_ids = [line.strip() for line in f if line.strip()]
        for img_id in img_ids:
            boxes = get_annotations(flickr_path / "Annotations" / f"{img_id}.xml")["boxes"]
            if merge:
                boxes = {pid: merge_boxes(b) for pid, b in boxes.items()}
            sentences = get_sentence_data(flickr_path / "Sentences" / f"{img_id}.txt")
            self._add_image(img_id, boxes, sentences)

    @classmethod
    def from_annotations(
        cls,
        images: Dict[str, Dict[str, Any]],
        topk: Sequence[int] = (1, 5, 10, -1),
        iou_thresh: float = 0.5,
    ) -> "Flickr30kEntitiesRecallEvaluator":
        """images[img_id] = {"boxes": {phrase_id: [...]}, "sentences": [...]}"""
        ev = cls(None, topk=topk, iou_thresh=iou_thresh)
        for img_id, data in images.items():
            ev._add_image(img_id, data["boxes"], data["sentences"])
        return ev

    def _add_image(self, img_id: str, boxes, sentences) -> None:
        self.imgid2boxes[img_id] = boxes
        slots: List[Optional[List[Dict]]] = []
        for sent_id, sent in enumerate(sentences):
            # phrases without a ground-truth box are filtered (ref :223-231)
            phrases = [p for p in sent["phrases"] if p["phrase_id"] in boxes]
            slots.append(phrases if phrases else None)
            if phrases:
                self.all_ids.append(f"{img_id}_{sent_id}")
        self.imgid2sentences[img_id] = slots

    def evaluate(self, predictions: List[Dict]) -> Dict[int, Dict[str, float]]:
        """predictions: [{"image_id", "sentence_id", "boxes": [phrase][rank][4]}]"""
        evaluated = set()
        tracker = RecallTracker(self.topk)
        for pred in predictions:
            img_id, sent_id = str(pred["image_id"]), int(pred["sentence_id"])
            cur_id = f"{img_id}_{sent_id}"
            if cur_id in evaluated:
                print(f"Warning: duplicate prediction for {cur_id}, skipping")
                continue
            if cur_id not in self.all_ids:
                if len(pred["boxes"]) != 0:
                    print(f"Warning: unexpected prediction for {cur_id}, ignoring")
                continue
            evaluated.add(cur_id)
            if img_id not in self.imgid2sentences:
                raise RuntimeError(f"unknown image id {img_id}")
            if not 0 <= sent_id < len(self.imgid2sentences[img_id]):
                raise RuntimeError(f"unknown sentence id {sent_id} in image {img_id}")
            phrases = self.imgid2sentences[img_id][sent_id]
            if len(pred["boxes"]) != len(phrases):
                raise RuntimeError(
                    f"got {len(pred['boxes'])} predictions, expected {len(phrases)}"
                    f" for sentence {sent_id} in image {img_id}"
                )
            for ranked_boxes, phrase in zip(pred["boxes"], phrases):
                targets = self.imgid2boxes[img_id][phrase["phrase_id"]]
                ious = box_iou_xyxy(np.asarray(ranked_boxes), np.asarray(targets))
                for k in self.topk:
                    best = ious.max() if k == -1 else ious[:k].max()
                    hit = best >= self.iou_thresh
                    cats = ["all"] + list(phrase["phrase_type"])
                    for cat in cats:
                        if hit:
                            tracker.add_positive(k, cat)
                        else:
                            tracker.add_negative(k, cat)
        if len(evaluated) != len(self.all_ids):
            missing = sorted(set(self.all_ids) - evaluated)
            raise RuntimeError(f"missing predictions for: {missing}")
        return tracker.report()

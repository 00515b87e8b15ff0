"""MUGEN (coinrun) dataset layer. Counterpart of
``multimodal_tpu/examples/mugen/data.py``.

Release-JSON metadata (``{split}.json`` with ``data[i].video.num_frames``
and ``data[i].annotations[j].text``), the too-short-clip filter, every-n
frame sampling from a fixed or random start, and the first or a random
annotation. Clips are pre-rendered ``{id}.npy`` arrays ((T, H, W, 3)
uint8) in ``frames_dir``; the resize and normalize run on the device
(``transforms/video_transform.py``). The start frame and the annotation
draw from the batch's ``RandomState`` as the JAX module's do, so one seed
gives the same frames and texts. The audio track (``get_audio``) comes with
MUGEN's audio recipe and is not ported yet (ROADMAP.md, slice 11).
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, Optional, Sequence

import numpy as np

from multimodal_tpu_torch.data.datamodules import DataModule


class MUGENDataModule(DataModule):
    """{video (S, H, W, 3) float32 in [0, 1], text (L,) int32} batches."""

    def __init__(
        self,
        data_path: str,
        frames_dir: str,
        split: str = "train",
        text_transform: Optional[Callable[[Sequence[str]], np.ndarray]] = None,
        sequence_length: int = 32,
        sample_every_n_frames: int = 3,
        fixed_start_idx: bool = True,
        random_text: bool = False,
        text_len: int = 32,
        get_audio: bool = False,
        **kwargs,
    ):
        if get_audio:
            raise NotImplementedError("MUGEN's audio track is not ported yet (ROADMAP.md, "
                                      "slice 11)")
        with open(os.path.join(data_path, f"{split}.json")) as f:
            all_data = json.load(f)
        self.metadata = all_data.get("metadata", {})
        min_frames = (sequence_length - 1) * sample_every_n_frames
        data = [d for d in all_data["data"] if d["video"]["num_frames"] > min_frames]
        super().__init__(data, **kwargs)
        self.frames_dir = frames_dir
        self.text_transform = text_transform
        self.sequence_length = sequence_length
        self.sample_every_n_frames = sample_every_n_frames
        self.fixed_start_idx = fixed_start_idx
        self.random_text = random_text
        self.text_len = text_len

    def _video_id(self, sample: Dict) -> str:
        vid = sample["video"]
        if "id" in vid:
            return str(vid["id"])
        # release jsons carry json_file paths like "x/y/<id>.json"
        return os.path.splitext(os.path.basename(vid.get("json_file", vid.get("video_file", ""))))[0]

    def frame_indices(self, num_frames: int, rng: np.random.RandomState) -> np.ndarray:
        """The clip's sampled frames: ``sequence_length`` of them, every
        ``sample_every_n_frames``-th from a start drawn from ``rng`` (0 with
        ``fixed_start_idx``)."""
        span = (self.sequence_length - 1) * self.sample_every_n_frames
        if self.fixed_start_idx or num_frames - span - 1 <= 0:
            start = 0
        else:
            start = rng.randint(0, num_frames - span)
        return start + np.arange(self.sequence_length) * self.sample_every_n_frames

    def process(self, sample, rng):
        frames = np.load(os.path.join(self.frames_dir, f"{self._video_id(sample)}.npy"),
                         mmap_mode="r")
        video = np.asarray(frames[self.frame_indices(len(frames), rng)], np.float32)
        if video.max() > 1.5:
            video = video / 255.0
        out = {"video": video}
        annotations = sample.get("annotations") or []
        if annotations:
            j = rng.randint(len(annotations)) if self.random_text else 0
            text = annotations[j]["text"]
            if self.text_transform is not None:
                ids = np.asarray(self.text_transform([text]))[0]
                padded = np.zeros((self.text_len,), np.int32)
                n = min(len(ids), self.text_len)
                padded[:n] = ids[:n]
                out["text"] = padded
        return out

"""Dataset loading. Counterpart of ``multimodal_tpu/data/datasets.py``.

One loader for the cases that need no network first: an on-disk arrow
dataset (``datasets.save_to_disk``), a jsonl or json file of samples, an
image folder (a directory per class), and only then a hub name. Only the
arrow and hub cases import HF ``datasets``, and they raise naming it when it
is absent.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Sequence

IMAGE_SUFFIXES = (".jpg", ".jpeg", ".png", ".bmp", ".npy")


class ListDataset:
    """An indexable dataset over a list of dict samples."""

    def __init__(self, samples: Sequence[Dict[str, Any]]):
        self.samples = list(samples)

    def __len__(self) -> int:
        return len(self.samples)

    def __getitem__(self, i: int) -> Dict[str, Any]:
        return self.samples[i]


def _load_jsonl(path: str) -> ListDataset:
    samples: List[Dict[str, Any]] = []
    with open(path) as f:
        if path.endswith(".json"):
            data = json.load(f)
            samples = data if isinstance(data, list) else data["data"]
        else:
            for line in f:
                line = line.strip()
                if line:
                    samples.append(json.loads(line))
    return ListDataset(samples)


def _load_imagefolder(path: str, split: Optional[str]) -> ListDataset:
    """A directory per class -> ``{image: path, label: int, classname}``."""
    root = (os.path.join(path, split)
            if split and os.path.isdir(os.path.join(path, split)) else path)
    classes = sorted(d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d)))
    samples = []
    for label, cls in enumerate(classes):
        cdir = os.path.join(root, cls)
        for fname in sorted(os.listdir(cdir)):
            if fname.lower().endswith(IMAGE_SUFFIXES):
                samples.append({"image": os.path.join(cdir, fname), "label": label,
                                "classname": cls})
    return ListDataset(samples)


def _hf_datasets():
    try:
        import datasets as hf_datasets
    except ImportError as e:
        raise ImportError("this dataset needs the HF `datasets` package, which is not "
                          "installed; a jsonl file or an image folder needs nothing") from e
    return hf_datasets


def load_dataset(path_or_name: str, split: str = "train", **kwargs):
    """A dataset from, in this order: a ``datasets.save_to_disk`` directory,
    a ``.json`` / ``.jsonl`` file, an image folder, a HF hub name."""
    if os.path.isdir(path_or_name):
        for c in (path_or_name, os.path.join(path_or_name, split)):
            if os.path.exists(os.path.join(c, "state.json")):
                ds = _hf_datasets().load_from_disk(c)
                if hasattr(ds, "keys") and split in getattr(ds, "keys", lambda: [])():
                    ds = ds[split]
                return ds
        if os.path.exists(os.path.join(path_or_name, "dataset_dict.json")):
            return _hf_datasets().load_from_disk(path_or_name)[split]
        return _load_imagefolder(path_or_name, split)
    if os.path.isfile(path_or_name):
        return _load_jsonl(path_or_name)
    return _hf_datasets().load_dataset(path_or_name, split=split, **kwargs)

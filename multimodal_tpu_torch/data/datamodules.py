"""Host-side datamodules. Counterpart of ``multimodal_tpu/data/datamodules.py``
(``ImageDataModule``, ``MLMDataModule``, ``VLDataModule``).

Samples are processed and collated as numpy arrays, as in the JAX package:
static shapes, a deterministic shuffle per epoch, and a RandomState per
batch keyed on (seed, epoch, offset), so batch b of epoch e is a function
of the config alone and a resumed run (``train_batches(start_step=...)``)
sees exactly the batches the interrupted one would have. Batches come out
as CPU tensors (``torch.from_numpy``, no copy); ``data/device_prefetch.py``
moves them to the card. A background thread (``_Prefetcher``) runs the
host work ahead of the consumer. An image transform with a ``plan`` method
(``FLAVAImageTransform``) makes its random draws from the batch's
RandomState, in sample order, and its pixel work runs on a thread pool
straight into the batch's arrays at ``collate``. Image fields that are
``.npy`` paths load without PIL; other image files need it. The JAX package's ``jpeg_staging``
(its native JPEG decoder) is not ported (ROADMAP.md, queue A8).
"""

from __future__ import annotations

import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, Iterator, Optional, Sequence

import numpy as np
import torch


def _refuse_jpeg_staging(jpeg_staging) -> None:
    if jpeg_staging is not None:
        raise NotImplementedError("jpeg_staging (the native JPEG decoder, native/jpeg.py) "
                                  "is not ported yet (ROADMAP.md, queue A8)")


def _to_image(x, jpeg_staging=None):
    """A sample's image field: an ``.npy`` path -> its array, another image
    path -> a PIL RGB image; arrays and images pass through."""
    _refuse_jpeg_staging(jpeg_staging)
    if isinstance(x, str):
        if x.endswith(".npy"):
            return np.load(x)
        from PIL import Image

        with Image.open(x) as im:
            return im.convert("RGB").copy()
    return x


def _collate(samples: Sequence[Dict[str, Any]]) -> Dict[str, np.ndarray]:
    return {key: np.stack([np.asarray(s[key]) for s in samples]) for key in samples[0]}


_PLANNED = "__planned_pixels__"
_POOL: Optional[ThreadPoolExecutor] = None


def _pixel_pool() -> ThreadPoolExecutor:
    """The process's threads for planned pixel work (C++ that releases the
    GIL): all cores but two, at most six."""
    global _POOL
    if _POOL is None:
        _POOL = ThreadPoolExecutor(max(1, min(6, (os.cpu_count() or 2) - 2)),
                                   thread_name_prefix="pixels")
    return _POOL


def _image_fields(image_transform: Callable, img, rng: np.random.RandomState
                  ) -> Dict[str, Any]:
    """A sample's image fields; a transform with ``plan`` only draws here,
    from the batch's ``rng``, and leaves its pixels to ``_collate_planned``."""
    if hasattr(image_transform, "plan"):
        return {_PLANNED: image_transform.plan(img, rng)}
    img = image_transform(img)
    return dict(img) if isinstance(img, dict) else {"image": np.asarray(img)}


def _collate_planned(samples: Sequence[Dict[str, Any]], image_transform
                     ) -> Dict[str, np.ndarray]:
    """``_collate``; planned samples' pixels are made on the pool, each into
    its row of the batch's arrays, and their other fields (the mask) join
    the sample's."""
    if _PLANNED not in samples[0]:
        return _collate(samples)
    samples = [dict(s) for s in samples]
    runs = [s.pop(_PLANNED) for s in samples]
    pixels = {k: np.empty((len(samples), *shape), np.float32)
              for k, shape in image_transform.pixel_shapes().items()}
    futures = [_pixel_pool().submit(run, {k: a[i] for k, a in pixels.items()})
               for i, run in enumerate(runs)]
    for s, f in zip(samples, futures):
        s.update({k: v for k, v in f.result().items() if k not in pixels})
    return {**_collate(samples), **pixels}


def as_tensors(batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A numpy batch as CPU tensors sharing its memory."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)) if isinstance(v, np.ndarray) else v
            for k, v in batch.items()}


class _Prefetcher:
    """Runs ``make_iter()`` on a background thread, at most ``depth`` items
    ahead; an exception there is raised in the consumer."""

    def __init__(self, make_iter: Callable[[], Iterator], depth: int = 2):
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._done = object()
        self._err: Optional[BaseException] = None

        def worker():
            try:
                for item in make_iter():
                    self._q.put(item)
            except BaseException as e:  # raised in the consumer
                self._err = e
            finally:
                self._q.put(self._done)

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._done:
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item


class DataModule:
    """Base: deterministic epoch shuffling, batching and prefetch.
    Subclasses implement ``process(sample, rng)`` and may override
    ``postprocess(batch, rng)`` for work on the whole batch."""

    def __init__(self, dataset, batch_size: int = 8, shuffle: bool = True,
                 drop_last: bool = True, seed: int = 0, prefetch: int = 2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.prefetch = prefetch
        self.rng_salt = 0  # a per-host salt of the per-batch draws

    def process(self, sample: Dict[str, Any], rng: np.random.RandomState
                ) -> Dict[str, np.ndarray]:
        raise NotImplementedError

    def postprocess(self, batch: Dict[str, np.ndarray], rng: np.random.RandomState
                    ) -> Dict[str, np.ndarray]:
        return batch

    def collate(self, samples: Sequence[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
        return _collate(samples)

    def _epoch_indices(self, epoch: int) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.RandomState(self.seed + epoch).shuffle(idx)
        return idx

    def _epoch_batches(self, epoch: int, start_batch: int = 0
                       ) -> Iterator[Dict[str, torch.Tensor]]:
        idx = self._epoch_indices(epoch)
        bs = self.batch_size
        end = len(idx) - (len(idx) % bs) if self.drop_last else len(idx)
        for start in range(start_batch * bs, end, bs):
            chunk = idx[start:start + bs]
            if self.drop_last and len(chunk) < bs:
                break
            rng = np.random.RandomState((self.seed, epoch, start, self.rng_salt))
            samples = [self.process(self.dataset[int(i)], rng) for i in chunk]
            yield as_tensors(self.postprocess(self.collate(samples), rng))

    def batches_per_epoch(self) -> int:
        n = len(self._epoch_indices(0))
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def eval_batches(self) -> Iterator[Dict[str, torch.Tensor]]:
        """One unshuffled pass (the last batch may be short)."""
        rng = np.random.RandomState(self.seed)
        bs = self.batch_size
        for start in range(0, len(self.dataset), bs):
            n = min(bs, len(self.dataset) - start)
            samples = [self.process(self.dataset[start + i], rng) for i in range(n)]
            yield as_tensors(self.postprocess(self.collate(samples), rng))

    def train_batches(self, start_step: int = 0) -> Iterator[Dict[str, torch.Tensor]]:
        """An endless stream, reshuffled each epoch, prefetched on a thread.
        ``start_step`` starts it at global batch ``start_step`` by index
        arithmetic: no sample of a skipped batch is processed."""
        per_epoch = max(self.batches_per_epoch(), 1)
        first_epoch, first_batch = divmod(start_step, per_epoch)

        def gen():
            epoch, start = first_epoch, first_batch
            while True:
                yield from self._epoch_batches(epoch, start_batch=start)
                epoch, start = epoch + 1, 0

        if self.prefetch > 0:
            return _Prefetcher(gen, depth=self.prefetch)
        return gen()

    def __iter__(self):
        return iter(self.train_batches())


class ImageDataModule(DataModule):
    """Images and, where the sample has one, an integer label."""

    def __init__(self, dataset, image_transform: Optional[Callable] = None,
                 image_key: str = "image", label_key: str = "label", jpeg_staging=None,
                 **kwargs):
        super().__init__(dataset, **kwargs)
        _refuse_jpeg_staging(jpeg_staging)
        self.image_transform = image_transform
        self.image_key = image_key
        self.label_key = label_key

    def process(self, sample, rng):
        img = _to_image(sample[self.image_key])
        if self.image_transform is not None:
            img = self.image_transform(img)
        out = img if isinstance(img, dict) else {"image": np.asarray(img)}
        if self.label_key in sample:
            out["labels"] = np.asarray(sample[self.label_key], dtype=np.int32)
        return out


class MLMDataModule(DataModule):
    """Text-only MLM batches: ``{text, text_masked, mlm_labels}``."""

    def __init__(self, dataset, text_transform: Callable[[Sequence[str]], Any],
                 mlm_collator, text_key: str = "text", **kwargs):
        super().__init__(dataset, **kwargs)
        self.text_transform = text_transform
        self.mlm_collator = mlm_collator
        self.text_key = text_key

    def process(self, sample, rng):
        ids = np.asarray(self.text_transform([sample[self.text_key]]))[0]
        return {"text": ids.astype(np.int32)}

    def postprocess(self, batch, rng):
        self.mlm_collator.rng = rng
        masked, labels = self.mlm_collator(batch["text"])
        return {"text": batch["text"], "text_masked": masked.astype(np.int32),
                "mlm_labels": labels.astype(np.int32)}


class VLDataModule(DataModule):
    """Image-text pairs: ``{image..., text, text_masked, mlm_labels,
    itm_labels}``. With probability ``itm_probability`` a sample's text is
    swapped for another sample's (a different caption) and its ITM label
    is 0; MLM masking applies to the text that ends up paired."""

    def __init__(self, dataset, image_transform: Callable,
                 text_transform: Callable[[Sequence[str]], Any], mlm_collator=None,
                 itm_probability: float = 0.1, image_key: str = "image",
                 text_key: str = "text", jpeg_staging=None, **kwargs):
        super().__init__(dataset, **kwargs)
        _refuse_jpeg_staging(jpeg_staging)
        self.image_transform = image_transform
        self.text_transform = text_transform
        self.mlm_collator = mlm_collator
        self.itm_probability = itm_probability
        self.image_key = image_key
        self.text_key = text_key

    def process(self, sample, rng):
        text = sample[self.text_key]
        itm_label = 1
        if self.itm_probability > 0 and rng.rand() < self.itm_probability:
            for _ in range(10):  # a negative needs a different caption
                j = rng.randint(len(self.dataset))
                neg_text = self.dataset[int(j)][self.text_key]
                if neg_text != text:
                    text = neg_text
                    itm_label = 0
                    break
        out = _image_fields(self.image_transform, _to_image(sample[self.image_key]), rng)
        ids = np.asarray(self.text_transform([text]))[0]
        out["text"] = ids.astype(np.int32)
        out["itm_labels"] = np.asarray(itm_label, dtype=np.int32)
        return out

    def collate(self, samples):
        return _collate_planned(samples, self.image_transform)

    def postprocess(self, batch, rng):
        if self.mlm_collator is not None:
            self.mlm_collator.rng = rng
            masked, labels = self.mlm_collator(batch["text"])
            batch["text_masked"] = masked.astype(np.int32)
            batch["mlm_labels"] = labels.astype(np.int32)
        return batch

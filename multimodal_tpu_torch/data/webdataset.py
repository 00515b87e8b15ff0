"""Streaming input from webdataset-style tar shards. Counterpart of
``multimodal_tpu/data/webdataset.py`` (``ShardedTarDataset``,
``expand_shards``, ``IterableDataModule``, ``StreamingVLDataModule``).

A shard's members group into samples by basename (``000123.jpg`` and
``000123.txt`` are one sample), read in sequence, one shard open at a time.
The data module assigns each host a strided slice of the shards, shuffles
the shard order per epoch and mixes samples in a bounded buffer; batches
come out as CPU tensors, as ``datamodules.py``'s do. A sample's image member
is a jpg, png or webp, as in the JAX package, so decoding it needs PIL.
"""

from __future__ import annotations

import io
import os
import tarfile
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from multimodal_tpu_torch.data.datamodules import (
    _collate,
    _collate_planned,
    _image_fields,
    _Prefetcher,
    _refuse_jpeg_staging,
    as_tensors,
)


class ShardedTarDataset:
    """``{__key__, <ext>: bytes}`` samples from tar shards. Member
    ``dir/000123.seg.jpg`` has key ``dir/000123`` and field ``seg.jpg``; the
    members of one sample are contiguous in the tar."""

    def __init__(self, shards: Sequence[str]):
        if not shards:
            raise ValueError("no shards given")
        self.shards = list(shards)

    @staticmethod
    def _split_key(name: str):
        base = name.rstrip("/")
        d, fname = os.path.split(base)
        if "." not in fname:
            return base, ""
        stem, ext = fname.split(".", 1)
        return os.path.join(d, stem) if d else stem, ext

    def iter_shard(self, shard: str) -> Iterator[Dict[str, Any]]:
        current: Optional[str] = None
        sample: Dict[str, Any] = {}
        with tarfile.open(shard, "r|*") as tf:  # streaming: no seeks
            for member in tf:
                if not member.isfile():
                    continue
                key, ext = self._split_key(member.name)
                if key != current:
                    if current is not None and sample:
                        yield {"__key__": current, **sample}
                    current, sample = key, {}
                f = tf.extractfile(member)
                if f is not None:
                    sample[ext] = f.read()
        if current is not None and sample:
            yield {"__key__": current, **sample}

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        for shard in self.shards:
            yield from self.iter_shard(shard)


def expand_shards(pattern_or_list) -> List[str]:
    """A list of paths, a glob pattern, or a directory of .tar files."""
    import glob as _glob

    if isinstance(pattern_or_list, (list, tuple)):
        return list(pattern_or_list)
    p = str(pattern_or_list)
    if os.path.isdir(p):
        return sorted(os.path.join(p, f) for f in os.listdir(p) if f.endswith(".tar"))
    return sorted(_glob.glob(p))


class IterableDataModule:
    """Streaming datamodule over tar shards: deterministic given (seed,
    epoch), ``process`` / ``postprocess`` / ``collate`` as in
    ``DataModule``. Host ``process_index`` of ``process_count`` reads the
    shards ``shards[pi::pc]``, cut to equal length. ``start_step`` skips
    whole batches without processing them (their tar bytes are still
    read)."""

    def __init__(self, shards, batch_size: int = 8, shuffle_buffer: int = 0, seed: int = 0,
                 prefetch: int = 2, process_index: int = 0, process_count: int = 1,
                 decode: Optional[Callable[[Dict[str, Any]], Dict[str, Any]]] = None):
        shards = expand_shards(shards)
        per = len(shards) // process_count
        if per < 1:
            raise ValueError(f"{len(shards)} shards cannot feed {process_count} hosts")
        self.all_shards = shards
        self.shards = shards[process_index::process_count][:per]
        self.batch_size = batch_size
        self.shuffle_buffer = shuffle_buffer
        self.seed = seed
        self.prefetch = prefetch
        self.decode = decode
        self.rng_salt = process_index

    def process(self, sample: Dict[str, Any], rng: np.random.RandomState
                ) -> Dict[str, np.ndarray]:
        if self.decode is None:
            raise NotImplementedError("pass decode= or subclass IterableDataModule.process")
        return self.decode(sample)

    def postprocess(self, batch, rng):
        return batch

    def collate(self, samples):
        return _collate(samples)

    def _epoch_samples(self, epoch: int) -> Iterator[Dict[str, Any]]:
        order = np.arange(len(self.shards))
        np.random.RandomState(self.seed + epoch).shuffle(order)
        stream = ShardedTarDataset([self.shards[i] for i in order])
        if self.shuffle_buffer <= 1:
            yield from stream
            return
        rng = np.random.RandomState((self.seed, epoch, 0))
        buf: List[Dict[str, Any]] = []
        for sample in stream:
            if len(buf) < self.shuffle_buffer:
                buf.append(sample)
                continue
            j = rng.randint(len(buf))
            yield buf[j]
            buf[j] = sample
        rng.shuffle(buf)
        yield from buf

    def _epoch_batches(self, epoch: int, skip: int = 0) -> Iterator[Dict[str, torch.Tensor]]:
        """This epoch's batches after the first ``skip``; the ragged tail is
        dropped. Sets ``_last_epoch_batches`` to the epoch's batch count."""
        bs = self.batch_size
        raw: List[Dict[str, Any]] = []
        n_batch = 0
        for sample in self._epoch_samples(epoch):
            raw.append(sample)
            if len(raw) < bs:
                continue
            batch_raw, raw = raw, []
            n_batch += 1
            if n_batch <= skip:
                continue
            rng = np.random.RandomState((self.seed, epoch, 1 + n_batch, self.rng_salt))
            samples = [self.process(s, rng) for s in batch_raw]
            yield as_tensors(self.postprocess(self.collate(samples), rng))
        self._last_epoch_batches = n_batch

    def train_batches(self, start_step: int = 0) -> Iterator[Dict[str, torch.Tensor]]:
        def gen():
            epoch, skip = 0, start_step
            while True:
                yield from self._epoch_batches(epoch, skip=skip)
                skip = max(0, skip - self._last_epoch_batches)
                epoch += 1

        if self.prefetch > 0:
            return _Prefetcher(gen, depth=self.prefetch)
        return gen()

    def eval_batches(self) -> Iterator[Dict[str, torch.Tensor]]:
        """One unshuffled pass over this host's shards."""
        rng = np.random.RandomState(self.seed)
        bs = self.batch_size
        raw: List[Dict[str, Any]] = []
        for sample in ShardedTarDataset(self.shards):
            raw.append(sample)
            if len(raw) == bs:
                yield as_tensors(self.postprocess(
                    self.collate([self.process(s, rng) for s in raw]), rng))
                raw = []
        if raw:
            yield as_tensors(self.postprocess(
                self.collate([self.process(s, rng) for s in raw]), rng))

    def __iter__(self):
        return iter(self.train_batches())


class StreamingVLDataModule(IterableDataModule):
    """Image-text pretraining batches from shards, with ``VLDataModule``'s
    output; ITM negatives are drawn within the batch (a caption swap
    between rows), since a stream has no random access."""

    IMAGE_EXTS = ("jpg", "jpeg", "png", "webp")

    def __init__(self, shards, image_transform: Callable, text_transform: Callable,
                 mlm_collator=None, itm_probability: float = 0.1, text_ext: str = "txt",
                 jpeg_staging=None, **kwargs):
        super().__init__(shards, **kwargs)
        _refuse_jpeg_staging(jpeg_staging)
        self.image_transform = image_transform
        self.text_transform = text_transform
        self.mlm_collator = mlm_collator
        self.itm_probability = itm_probability
        self.text_ext = text_ext

    def _decode_image(self, sample):
        for ext in self.IMAGE_EXTS:
            if ext in sample:
                blob = sample[ext]
                break
        else:
            raise KeyError(f"sample {sample.get('__key__')} has no image field "
                           f"(looked for {self.IMAGE_EXTS})")
        from PIL import Image

        with Image.open(io.BytesIO(blob)) as im:
            return im.convert("RGB").copy()

    def process(self, sample, rng):
        out = _image_fields(self.image_transform, self._decode_image(sample), rng)
        text = sample[self.text_ext].decode("utf-8")
        out["text"] = np.asarray(self.text_transform([text]))[0].astype(np.int32)
        return out

    def collate(self, samples):
        return _collate_planned(samples, self.image_transform)

    def postprocess(self, batch, rng):
        bs = len(batch["text"])
        itm = np.ones(bs, np.int32)
        if self.itm_probability > 0 and bs > 1:
            orig = batch["text"].copy()  # negatives come from the original rows
            for i in range(bs):
                if rng.rand() >= self.itm_probability:
                    continue
                j = rng.randint(bs - 1)
                j += j >= i  # uniform over the other rows
                if not np.array_equal(orig[i], orig[j]):
                    batch["text"][i] = orig[j]
                    itm[i] = 0
        batch["itm_labels"] = itm
        if self.mlm_collator is not None:
            self.mlm_collator.rng = rng
            masked, labels = self.mlm_collator(batch["text"])
            batch["text_masked"] = masked.astype(np.int32)
            batch["mlm_labels"] = labels.astype(np.int32)
        return batch

"""Sequence packing for LM pretraining. A copy of
``multimodal_tpu/data/packing.py`` (numpy only), kept in the port so that it
imports nothing of the JAX package.

Documents are concatenated into fixed ``seq_len`` rows, each position
carrying an int32 segment id, and both attention (block-diagonal within the
causal triangle: the flash kernels' segment path, ``ops/flash_attention.py``)
and the next-token loss (``packed_next_token_loss``) are masked at document
boundaries, so no FLOP goes to padding.

Conventions: segment id 0 = padding, documents numbered from 1 per row.
``positions`` restart at 0 for each document so positional embeddings see
per-document offsets.
"""

from __future__ import annotations

from typing import Dict, Iterable, Iterator, List, Sequence

import numpy as np


def pack_documents(
    docs: Iterable[Sequence[int]],
    seq_len: int,
    *,
    pad_id: int = 0,
    truncate: bool = True,
) -> Dict[str, np.ndarray]:
    """Greedily pack token sequences into fixed-length rows.

    Sequential first-fit: each document goes into the current row if it
    fits, else the row is flushed (padded) and a new one starts. Documents
    longer than ``seq_len`` are truncated (``truncate=True``) or split into
    ``seq_len`` chunks sharing one segment id per chunk-row.

    Returns ``{"tokens", "segment_ids", "positions"}``, each
    ``(n_rows, seq_len)``; ``segment_ids`` are 0 on padding and 1.. per
    document within a row; ``positions`` restart at 0 per document.
    """
    rows_tokens: List[np.ndarray] = []
    rows_segs: List[np.ndarray] = []
    rows_pos: List[np.ndarray] = []

    cur_t = np.full(seq_len, pad_id, np.int32)
    cur_s = np.zeros(seq_len, np.int32)
    cur_p = np.zeros(seq_len, np.int32)
    fill = 0
    n_seg = 0

    def flush():
        nonlocal cur_t, cur_s, cur_p, fill, n_seg
        if fill:
            rows_tokens.append(cur_t)
            rows_segs.append(cur_s)
            rows_pos.append(cur_p)
        cur_t = np.full(seq_len, pad_id, np.int32)
        cur_s = np.zeros(seq_len, np.int32)
        cur_p = np.zeros(seq_len, np.int32)
        fill = 0
        n_seg = 0

    for doc in docs:
        ids = np.asarray(doc, np.int32).reshape(-1)
        if len(ids) == 0:
            continue
        chunks = (
            [ids[:seq_len]] if truncate
            else [ids[i : i + seq_len] for i in range(0, len(ids), seq_len)]
        )
        for chunk in chunks:
            if fill + len(chunk) > seq_len:
                flush()
            n_seg += 1
            end = fill + len(chunk)
            cur_t[fill:end] = chunk
            cur_s[fill:end] = n_seg
            cur_p[fill:end] = np.arange(len(chunk), dtype=np.int32)
            fill = end
            if fill == seq_len:
                flush()
    flush()

    if not rows_tokens:
        empty = np.zeros((0, seq_len), np.int32)
        return {"tokens": empty, "segment_ids": empty.copy(),
                "positions": empty.copy()}
    return {
        "tokens": np.stack(rows_tokens),
        "segment_ids": np.stack(rows_segs),
        "positions": np.stack(rows_pos),
    }


def packed_batches(
    docs: Iterable[Sequence[int]],
    seq_len: int,
    batch_size: int,
    drop_last: bool = False,
    **kwargs,
) -> Iterator[Dict[str, np.ndarray]]:
    """Stream fixed-shape packed batches from a document iterator.

    When the (finite) iterator ends, the remaining buffered documents are
    still packed; with ``drop_last=False`` (default) a final batch is
    emitted, padded to ``batch_size`` with all-zero rows (``segment_ids==0``
    marks them as padding — the packed losses already mask those positions).
    With ``drop_last=True`` the tail is discarded instead and the number of
    dropped rows is logged — either way the semantics are explicit, never a
    silent drop."""
    buf: List[Sequence[int]] = []
    pending: Dict[str, List[np.ndarray]] = {
        "tokens": [], "segment_ids": [], "positions": []
    }

    def _drain():
        while len(pending["tokens"]) >= batch_size:
            yield {
                k: np.stack(v[:batch_size]) for k, v in pending.items()
            }
            for k in pending:
                pending[k] = pending[k][batch_size:]

    for doc in docs:
        buf.append(doc)
        if len(buf) < batch_size:  # pack in batch-sized document groups
            continue
        packed = pack_documents(buf, seq_len, **kwargs)
        buf = []
        for key in pending:
            pending[key].extend(packed[key])
        yield from _drain()

    # tail: pack whatever documents remain, then flush pending rows
    if buf:
        packed = pack_documents(buf, seq_len, **kwargs)
        for key in pending:
            pending[key].extend(packed[key])
    yield from _drain()
    n_left = len(pending["tokens"])
    if n_left:
        if drop_last:
            import logging

            logging.getLogger(__name__).info(
                "packed_batches: dropped %d tail rows (drop_last=True)", n_left
            )
        else:
            pad = batch_size - n_left
            zero = np.zeros(seq_len, np.int32)
            for k in pending:
                pending[k].extend([zero.copy() for _ in range(pad)])
            yield {k: np.stack(v) for k, v in pending.items()}


def packing_efficiency(segment_ids: np.ndarray) -> float:
    """Fraction of positions carrying real tokens (1.0 = no pad waste)."""
    return float((segment_ids > 0).mean())

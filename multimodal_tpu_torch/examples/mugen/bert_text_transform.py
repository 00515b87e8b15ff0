"""WordPiece text transform (BERT-style). Counterpart of
``multimodal_tpu/examples/mugen/bert_text_transform.py``.

A greedy longest-match WordPiece over a given vocab (a file or a list of
tokens), with [CLS]/[SEP] and padding. The splitting is the standard
library's ``\\w+|[^\\w\\s]``. ``WordPieceTokenizer`` is the plain version of
``native/wordpiece.py``'s C++ loop.
"""

from __future__ import annotations

import re
from typing import List, Sequence, Union

import numpy as np
import torch


class WordPieceTokenizer:
    def __init__(
        self,
        vocab: Sequence[str],
        unk_token: str = "[UNK]",
        lowercase: bool = True,
        max_chars_per_word: int = 100,
    ):
        self.vocab = {tok: i for i, tok in enumerate(vocab)}
        self.unk_token = unk_token
        self.lowercase = lowercase
        self.max_chars_per_word = max_chars_per_word

    def _split(self, text: str) -> List[str]:
        if self.lowercase:
            text = text.lower()
        return re.findall(r"\w+|[^\w\s]", text)

    def _wordpiece(self, word: str) -> List[str]:
        if len(word) > self.max_chars_per_word:
            return [self.unk_token]
        pieces = []
        start = 0
        while start < len(word):
            end = len(word)
            piece = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    piece = sub
                    break
                end -= 1
            if piece is None:
                return [self.unk_token]
            pieces.append(piece)
            start = end
        return pieces

    def tokenize(self, text: str) -> List[str]:
        out = []
        for word in self._split(text):
            out.extend(self._wordpiece(word))
        return out

    def encode(self, text: str) -> List[int]:
        unk = self.vocab.get(self.unk_token, 0)
        return [self.vocab.get(t, unk) for t in self.tokenize(text)]


class BertTextTransform:
    """Tokenize + [CLS]/[SEP] + pad to the longest row (at most
    ``max_length``), as a CPU int64 tensor."""

    def __init__(
        self,
        vocab: Union[str, Sequence[str]],
        max_length: int = 512,
        cls_token: str = "[CLS]",
        sep_token: str = "[SEP]",
        pad_token: str = "[PAD]",
    ):
        if isinstance(vocab, str):
            with open(vocab) as f:
                vocab = [line.strip() for line in f if line.strip()]
        self.tokenizer = WordPieceTokenizer(vocab)
        self.max_length = max_length
        self.cls_id = self.tokenizer.vocab[cls_token]
        self.sep_id = self.tokenizer.vocab[sep_token]
        self.pad_id = self.tokenizer.vocab[pad_token]

    def __call__(self, text: Union[str, List[str]]) -> torch.Tensor:
        single = isinstance(text, str)
        texts = [text] if single else text
        encoded = [
            [self.cls_id] + self.tokenizer.encode(t)[: self.max_length - 2] + [self.sep_id]
            for t in texts
        ]
        max_len = min(max(len(e) for e in encoded), self.max_length)
        out = np.full((len(encoded), max_len), self.pad_id, np.int64)
        for i, e in enumerate(encoded):
            out[i, : len(e)] = e[:max_len]
        out = torch.from_numpy(out)
        return out[0] if single else out

"""The WordPiece tokenizer with its loop in C++. Counterpart of
``multimodal_tpu/native/wordpiece.py``.

``NativeWordPieceTokenizer`` splits and segments an ASCII text in one call
into ``native/wordpiece_tokenizer.cpp`` (built by ``native/_build.py`` at
first use). Text with a character outside ASCII takes the Python path, as in
the JAX package: the C++ loop knows ASCII classes only. A failed build
raises; nothing falls back to Python.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence

from multimodal_tpu_torch.examples.mugen.bert_text_transform import WordPieceTokenizer
from multimodal_tpu_torch.native import _build

SOURCE = "wordpiece_tokenizer.cpp"


def _library() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    lib.wp_create.restype = ctypes.c_void_p
    lib.wp_create.argtypes = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int]
    lib.wp_destroy.restype = None
    lib.wp_destroy.argtypes = [ctypes.c_void_p]
    lib.wp_encode_text.restype = ctypes.c_int
    lib.wp_encode_text.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
    ]
    return lib


class NativeWordPieceTokenizer(WordPieceTokenizer):
    """``WordPieceTokenizer`` with the split and segmentation in C++.
    ``native_calls`` counts the texts sent to it."""

    def __init__(self, vocab: Sequence[str], **kwargs):
        super().__init__(vocab, **kwargs)
        self._lib = _library()
        self._handle = self._lib.wp_create(
            "\n".join(vocab).encode("utf-8"), self.unk_token.encode("utf-8"),
            self.max_chars_per_word)
        if not self._handle:
            raise RuntimeError("wp_create returned no tokenizer")
        self.native_calls = 0

    def encode(self, text: str) -> List[int]:
        if not text.isascii():
            # \w and \s are Unicode classes here; the C++ loop knows ASCII
            return super().encode(text)
        raw = text.encode("ascii")
        # every id consumes at least one character of the text
        cap = max(len(raw), 1)
        buf = (ctypes.c_int32 * cap)()
        n = self._lib.wp_encode_text(self._handle, raw, len(raw), int(self.lowercase), buf, cap)
        self.native_calls += 1
        return list(buf[:n])

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.wp_destroy(self._handle)
            self._handle = None

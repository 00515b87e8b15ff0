"""The CLIP tokenizer with its merge loop in C++. Counterpart of
``multimodal_tpu/native/bpe.py``.

``NativeCLIPBPETokenizer`` runs the per-word merge loop and vocab lookup in
``native/bpe_tokenizer.cpp`` (built by ``native/_build.py`` at first use);
pre-tokenization and the byte mapping stay in Python
(``transforms/clip_transform.py``). A word the loop refuses (a symbol
outside the vocab, or more than 512 ids) goes through the Python merge loop,
as in the JAX package. Unlike the JAX package's, a failed build raises: it
never falls back to Python for the whole text.
"""

from __future__ import annotations

import ctypes
from typing import List

from multimodal_tpu_torch.native import _build
from multimodal_tpu_torch.transforms.clip_transform import CLIPBPETokenizer

SOURCE = "bpe_tokenizer.cpp"
MAX_IDS = 512  # ids one call may write


def _library() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    lib.bpe_create.restype = ctypes.c_void_p
    lib.bpe_create.argtypes = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p]
    lib.bpe_destroy.restype = None
    lib.bpe_destroy.argtypes = [ctypes.c_void_p]
    lib.bpe_encode_word.restype = ctypes.c_int
    lib.bpe_encode_word.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
    ]
    return lib


class NativeCLIPBPETokenizer(CLIPBPETokenizer):
    """``CLIPBPETokenizer`` with the merge loop in C++. ``native_calls``
    counts the words sent to it, ``fallbacks`` those it refused."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._lib = _library()
        merges = "\n".join(
            f"{a} {b}" for (a, b), _ in sorted(self.bpe_ranks.items(), key=lambda kv: kv[1])
        )
        vocab = "\n".join(tok for tok, _ in sorted(self.encoder.items(), key=lambda kv: kv[1]))
        specials = "\n".join((self.bos_token, self.eos_token))
        self._handle = self._lib.bpe_create(
            merges.encode("utf-8"), vocab.encode("utf-8"), specials.encode("utf-8"))
        if not self._handle:
            raise RuntimeError("bpe_create returned no tokenizer")
        self._buf = (ctypes.c_int32 * MAX_IDS)()
        self.native_calls = 0
        self.fallbacks = 0

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for mapped in self._mapped_words(text):
            n = self._lib.bpe_encode_word(self._handle, mapped.encode("utf-8"), self._buf,
                                          MAX_IDS)
            self.native_calls += 1
            if n < 0:
                self.fallbacks += 1
                ids.extend(self.encoder[s] for s in self._merge_word(mapped).split(" "))
            else:
                ids.extend(self._buf[:n])
        return ids

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.bpe_destroy(self._handle)
            self._handle = None

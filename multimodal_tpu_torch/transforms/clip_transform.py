"""CLIP transforms: byte-level BPE tokenizer and image preprocessing.
Counterpart of ``multimodal_tpu/transforms/clip_transform.py``.

The tokenizer runs on the host. The JAX package splits text into
pre-tokens with the third-party ``regex`` module's pattern

    <\\|startoftext\\|>|<\\|endoftext\\|>|'s|'t|'re|'ve|'m|'ll|'d|[\\p{L}]+|[\\p{N}]|[^\\s\\p{L}\\p{N}]+

under IGNORECASE. This module gives the same pre-tokens with the standard
library only (:func:`pre_tokenize`), so it runs where ``regex`` is absent.
Read against that pattern on every code point:

- ``[\\p{L}]`` is ``str.isalpha()``; ``[\\p{N}]`` is a ``unicodedata``
  category ``N*`` (not ``str.isnumeric()``, which also takes CJK numerals
  of category ``Lo``), both as amended below;
- ``\\s`` is ``str.isspace()`` less U+001C-U+001F, which ``regex`` counts
  as punctuation;
- U+0345 (combining ypogegrammeni) matches no alternative: under
  IGNORECASE its case partner is a letter, so the negated class refuses it,
  and the letter class does too; it is skipped;
- IGNORECASE lets U+017F (long s) stand for ``s`` in the special tokens and
  contractions; no other character outside ASCII folds to their letters.

``regex``'s newer Unicode tables also call letters or numbers code points
that Python's ``unicodedata`` leaves unassigned (``Cn``): 9,568 letters and
93 numbers between Unicode 15.0 and 17.0. ``_unicode_tables.py`` holds
those differences as ranges (written once from ``regex`` by
``scripts/make_unicode_tables.py``); the classes consult them by bisection
before ``unicodedata``, so they equal ``regex``'s on every code point. A
Python whose ``unicodedata`` is not the table's version is refused.

The image path (:class:`CLIPImageTransform`) resamples with the port's copy
of PIL's resampler (``native/resample.py``), so it needs PIL only for a PIL
image; the card's serving path starts from uint8 arrays through
``ops/image.py`` instead. ``basic_clean`` normalises to NFC and unescapes
HTML, the JAX package's path when ``ftfy`` is absent; ``ftfy`` is not used.
"""

from __future__ import annotations

import bisect
import functools
import html
import re
import unicodedata
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from multimodal_tpu_torch.transforms import _unicode_tables, text_transforms

CLIP_DEFAULT_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_DEFAULT_STD = (0.26862954, 0.26130258, 0.27577711)

SPECIAL_TOKENS = ("<|startoftext|>", "<|endoftext|>")
CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")

# The classes of pre_tokenize, one character each: a letter, a number,
# "other" and a character no alternative matches (whitespace, U+0345).
_LETTER, _NUMBER, _OTHER, _SKIP = "L", "N", "O", " "
_LETTER_RUN = re.compile(_LETTER + "+")
_OTHER_RUN = re.compile(_OTHER + "+")
_FOLD = {"ſ": "s"}  # IGNORECASE's one fold outside ASCII onto these letters
_SPACE = re.compile(r"[^\S\x1c-\x1f]+")  # regex's \s: isspace() less U+001C-U+001F


def _is_space(c: str) -> bool:
    return c.isspace() and not "\x1c" <= c <= "\x1f"


def _in(ranges, cp: int) -> bool:
    """Whether ``cp`` lies in one of the sorted, inclusive ``ranges``."""
    i = bisect.bisect_right(ranges, (cp, 0x10FFFF)) - 1
    return i >= 0 and ranges[i][0] <= cp <= ranges[i][1]


def is_letter(c: str) -> bool:
    """``regex``'s ``\\p{L}``."""
    cp = ord(c)
    if _in(_unicode_tables.LETTERS_ADDED, cp):
        return True
    return c.isalpha() and not _in(_unicode_tables.LETTERS_REMOVED, cp)


def is_number(c: str) -> bool:
    """``regex``'s ``\\p{N}``."""
    cp = ord(c)
    if _in(_unicode_tables.NUMBERS_ADDED, cp):
        return True
    return unicodedata.category(c)[0] == "N" and not _in(_unicode_tables.NUMBERS_REMOVED, cp)


class _ClassTable(dict):
    """``str.translate`` table: code point -> class character, filled on
    first sight of each code point."""

    def __missing__(self, cp: int) -> str:
        if unicodedata.unidata_version != _unicode_tables.UNICODEDATA_VERSION:
            raise RuntimeError(
                f"_unicode_tables.py was written against unicodedata "
                f"{_unicode_tables.UNICODEDATA_VERSION}, this Python has "
                f"{unicodedata.unidata_version}: run scripts/make_unicode_tables.py")
        c = chr(cp)
        if is_letter(c):
            k = _LETTER
        elif is_number(c):
            k = _NUMBER
        elif _is_space(c) or cp == 0x345:
            k = _SKIP
        else:
            k = _OTHER
        self[cp] = k
        return k


_CLASSES = _ClassTable()


def _literal_at(text: str, i: int, literal: str) -> bool:
    """Whether ``text[i:]`` starts with ``literal`` under IGNORECASE."""
    if i + len(literal) > len(text):
        return False
    for j, want in enumerate(literal):
        c = text[i + j]
        if c != want and _FOLD.get(c, c.lower() if c.isascii() else c) != want:
            return False
    return True


def pre_tokenize(text: str) -> List[str]:
    """The pre-tokens ``regex.findall(_TOKEN_PATTERN, text, IGNORECASE)``
    gives: special tokens, contractions, runs of letters, single numbers,
    runs of other characters; whitespace and U+0345 are dropped."""
    classes = text.translate(_CLASSES)
    out: List[str] = []
    i, n = 0, len(text)
    while i < n:
        k = classes[i]
        if k == _SKIP:
            i += 1
            continue
        c = text[i]
        if c == "<" or c == "'":
            hit = next((lit for lit in (SPECIAL_TOKENS if c == "<" else CONTRACTIONS)
                        if _literal_at(text, i, lit)), None)
            if hit is not None:
                out.append(text[i : i + len(hit)])
                i += len(hit)
                continue
        if k == _LETTER:
            j = _LETTER_RUN.match(classes, i).end()
        elif k == _NUMBER:
            j = i + 1
        else:
            j = _OTHER_RUN.match(classes, i).end()
        out.append(text[i:j])
        i = j
    return out


@functools.lru_cache()
def bytes_to_unicode() -> dict:
    """GPT-2 reversible byte <-> printable-unicode table."""
    printable = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("¡"), ord("¬") + 1))
        + list(range(ord("®"), ord("ÿ") + 1))
    )
    # Insertion order (printables first) sets the vocab indices.
    ordered = {b: chr(b) for b in printable}
    extra = 0
    for b in range(256):
        if b not in ordered:
            ordered[b] = chr(256 + extra)
            extra += 1
    return ordered


def basic_clean(text: str) -> str:
    text = unicodedata.normalize("NFC", text)
    return html.unescape(html.unescape(text)).strip()


def whitespace_clean(text: str) -> str:
    return _SPACE.sub(" ", text).strip()


class CLIPBPETokenizer:
    """Byte-level BPE with CLIP's vocab layout: 256 byte symbols, the same
    with ``</w>``, the merge results, then ``bos``/``eos``. The merge loop
    here is the plain version of ``native/bpe.py``'s."""

    def __init__(
        self,
        bpe_path: str,
        bos_token: str = "<|startoftext|>",
        eos_token: str = "<|endoftext|>",
        num_merges: Optional[int] = None,
    ):
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}

        with open(bpe_path, "r", encoding="utf-8") as f:
            merge_lines = f.read().split("\n")[1:]
        if num_merges is not None:
            merge_lines = merge_lines[:num_merges]
        merges = [tuple(line.split()) for line in merge_lines if line.strip()]
        self.num_merges = len(merges)
        self.bpe_ranks = {pair: rank for rank, pair in enumerate(merges)}

        base = list(self.byte_encoder.values())
        vocab = base + [s + "</w>" for s in base]
        vocab += ["".join(pair) for pair in merges]
        vocab += [bos_token, eos_token]
        self.encoder = {tok: i for i, tok in enumerate(vocab)}
        self.decoder = {i: tok for tok, i in self.encoder.items()}
        self.bos_token = bos_token
        self.eos_token = eos_token
        self._cache = {bos_token: bos_token, eos_token: eos_token}

    @property
    def vocab_size(self) -> int:
        return len(self.encoder)

    def _merge_word(self, token: str) -> str:
        """Apply BPE merges to one pre-token; returns space-joined symbols."""
        cached = self._cache.get(token)
        if cached is not None:
            return cached
        symbols = list(token[:-1]) + [token[-1] + "</w>"]
        while len(symbols) > 1:
            # the lowest-rank adjacent pair
            best_rank = None
            best_i = -1
            for i in range(len(symbols) - 1):
                r = self.bpe_ranks.get((symbols[i], symbols[i + 1]))
                if r is not None and (best_rank is None or r < best_rank):
                    best_rank = r
                    best_i = i
            if best_rank is None:
                break
            first, second = symbols[best_i], symbols[best_i + 1]
            # merge every occurrence of this pair in one pass
            merged: List[str] = []
            i = 0
            while i < len(symbols):
                if (
                    i < len(symbols) - 1
                    and symbols[i] == first
                    and symbols[i + 1] == second
                ):
                    merged.append(first + second)
                    i += 2
                else:
                    merged.append(symbols[i])
                    i += 1
            symbols = merged
        result = " ".join(symbols)
        self._cache[token] = result
        return result

    def _mapped_words(self, text: str) -> List[str]:
        """The pre-tokens of lowercased, stripped ``text``, each byte mapped
        to its printable symbol."""
        enc = self.byte_encoder
        return ["".join(enc[b] for b in token.encode("utf-8"))
                for token in pre_tokenize(text.lower().strip())]

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for mapped in self._mapped_words(text):
            ids.extend(self.encoder[s] for s in self._merge_word(mapped).split(" "))
        return ids

    def decode(self, tokens: Sequence[int]) -> str:
        text = "".join(self.decoder[t] for t in tokens)
        raw = bytearray(self.byte_decoder[c] for c in text if c in self.byte_decoder)
        return raw.decode("utf-8", errors="replace").replace("</w>", " ")


class CLIPBPETransform:
    """String(s) -> token id list(s). ``native=True`` runs the merge loop in
    C++ (``native/bpe.py``)."""

    def __init__(
        self,
        bpe_path: str,
        bos_token: str = "<|startoftext|>",
        eos_token: str = "<|endoftext|>",
        num_merges: Optional[int] = None,
        native: bool = False,
    ):
        if native:
            from multimodal_tpu_torch.native.bpe import NativeCLIPBPETokenizer as cls
        else:
            cls = CLIPBPETokenizer
        self.bpe = cls(bpe_path, bos_token, eos_token, num_merges)

    def __call__(self, text: Union[str, List[str]]):
        if isinstance(text, str):
            return self.bpe.encode(text)
        return [self.bpe.encode(t) for t in text]


class CLIPTextTransform:
    """Tokenize -> truncate(75) -> +BOS/EOS -> pad to 77, as a CPU int64
    tensor: ``(77,)`` for a string, ``(n, 77)`` for a list."""

    def __init__(
        self,
        bpe_merges_path: str,
        text_max_length: int = 77,
        text_start_token: str = "<|startoftext|>",
        text_end_token: str = "<|endoftext|>",
        num_merges: Optional[int] = 48894,
        native: bool = False,
    ):
        self.tokenizer = CLIPBPETransform(
            bpe_merges_path, text_start_token, text_end_token, num_merges, native
        )
        bos_id = self.tokenizer([text_start_token])[0][0]
        eos_id = self.tokenizer([text_end_token])[0][0]
        self.truncate = text_transforms.Truncate(text_max_length - 2)
        self.add_bos = text_transforms.AddToken(bos_id, begin=True)
        self.add_eos = text_transforms.AddToken(eos_id, begin=False)
        self.to_tensor = text_transforms.ToTensor(padding_value=0)
        self.pad = text_transforms.PadTransform(max_length=text_max_length, pad_value=0)

    def __call__(self, text: Union[str, List[str]]) -> torch.Tensor:
        single = isinstance(text, str)
        tokens = self.tokenizer([text] if single else list(text))
        tokens = self.add_eos(self.add_bos(self.truncate(tokens)))
        out = self.pad(self.to_tensor(tokens))
        return out[0] if single else out


def _rgb_array(image) -> np.ndarray:
    """A uint8 HWC RGB array from an array (HW, HWC RGB or RGBA) or a PIL
    image, as PIL's ``convert("RGB")`` makes it: grey repeated, alpha
    dropped."""
    if not isinstance(image, np.ndarray):  # a PIL image
        if image.mode != "RGB":
            image = image.convert("RGB")
        return np.asarray(image, np.uint8)
    image = np.asarray(image, np.uint8)
    if image.ndim == 2:
        image = np.repeat(image[:, :, None], 3, axis=2)
    return image[:, :, :3]


def _resize_center_crop(img: np.ndarray, size: int) -> np.ndarray:
    """torchvision-equivalent Resize(size, bicubic) + CenterCrop(size)."""
    from multimodal_tpu_torch.native.resample import resample_native

    h, w, _ = img.shape
    short, long = (w, h) if w <= h else (h, w)
    new_long = int(round(size * long / short))
    new_w, new_h = (size, new_long) if w <= h else (new_long, size)
    img = resample_native(img, (new_w, new_h), "bicubic")
    left = (new_w - size) // 2
    top = (new_h - size) // 2
    return img[top:top + size, left:left + size]


class CLIPImageTransform:
    """Image (PIL or uint8 HWC array) -> normalized float32 HWC tensor.

    Eval: Resize(bicubic, short side) + CenterCrop; train: RandomResizedCrop
    with draws from ``rng`` in the JAX package's order. The resampling is
    ``native/resample.py``'s copy of PIL's (equal to ``Image.resize`` pixel
    for pixel), so arrays need no PIL. A host path: the batched device path
    is ``ops/image.py:fused_preprocess_for_encoder``.
    """

    def __init__(
        self,
        image_size: int = 224,
        image_interpolation: str = "bicubic",
        image_mean: Tuple[float, ...] = CLIP_DEFAULT_MEAN,
        image_std: Tuple[float, ...] = CLIP_DEFAULT_STD,
        is_train: bool = True,
        rng: Optional[np.random.RandomState] = None,
    ):
        self.image_size = image_size
        self.mean = np.asarray(image_mean, dtype=np.float32)
        self.std = np.asarray(image_std, dtype=np.float32)
        self.is_train = is_train
        self.rng = rng or np.random.RandomState()

    def _random_resized_crop(self, img: np.ndarray) -> np.ndarray:
        from multimodal_tpu_torch.native.resample import resample_native

        h, w, _ = img.shape
        area = w * h
        size = self.image_size
        for _ in range(10):
            target_area = area * self.rng.uniform(0.08, 1.0)
            aspect = np.exp(self.rng.uniform(np.log(3 / 4), np.log(4 / 3)))
            cw = int(round(np.sqrt(target_area * aspect)))
            ch = int(round(np.sqrt(target_area / aspect)))
            if 0 < cw <= w and 0 < ch <= h:
                left = self.rng.randint(0, w - cw + 1)
                top = self.rng.randint(0, h - ch + 1)
                return resample_native(img, (size, size), "bicubic",
                                       box=(left, top, left + cw, top + ch))
        return _resize_center_crop(img, size)

    def __call__(self, image) -> torch.Tensor:
        image = _rgb_array(image)
        if self.is_train:
            image = self._random_resized_crop(image)
        else:
            image = _resize_center_crop(image, self.image_size)
        arr = image.astype(np.float32) / 255.0
        return torch.from_numpy((arr - self.mean) / self.std)


class CLIPTransform:
    """Joint (image, text) transform: ``(n, size, size, 3)`` float32 and
    ``(n, 77)`` int64 CPU tensors."""

    def __init__(
        self,
        bpe_merges_path: str,
        image_size: int = 224,
        image_interpolation: str = "bicubic",
        image_mean: Tuple[float, ...] = CLIP_DEFAULT_MEAN,
        image_std: Tuple[float, ...] = CLIP_DEFAULT_STD,
        text_max_length: int = 77,
        is_train: bool = True,
        num_merges: Optional[int] = 48894,
    ):
        self.image_transform = CLIPImageTransform(
            image_size, image_interpolation, image_mean, image_std, is_train
        )
        self.text_transform = CLIPTextTransform(
            bpe_merges_path, text_max_length=text_max_length, num_merges=num_merges
        )

    def __call__(self, image, text) -> Tuple[torch.Tensor, torch.Tensor]:
        images = image if isinstance(image, (list, tuple)) else [image]
        img_out = torch.stack([self.image_transform(im) for im in images])
        txt_out = self.text_transform(text if isinstance(text, list) else [text])
        return img_out, txt_out

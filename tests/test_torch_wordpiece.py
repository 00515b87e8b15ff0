"""The port's WordPiece tokenizer (multimodal_tpu_torch/examples/mugen/
bert_text_transform.py and native/wordpiece.py) held against the JAX
package's Python WordPieceTokenizer and BertTextTransform, on a vocab the
test writes. Token ids must be exactly equal."""

import numpy as np
import pytest
import torch

from multimodal_tpu.examples.mugen import bert_text_transform as jbt
from multimodal_tpu_torch.examples.mugen import bert_text_transform as pbt
from multimodal_tpu_torch.native.wordpiece import NativeWordPieceTokenizer

VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "a", "man", "rides", "hor", "##se", "##s",
         "un", "##believ", "##able", "!", ",", ";", "the", "q", "_", "9", "##9", "x", "##x",
         "caf", "##é", "é", "the"]  # "the" twice: the last index counts
TEXTS = [
    "a man rides horses",
    "unbelievable!",
    "the ZZZ man",  # ZZZ -> [UNK]
    "",
    "a" * 150,  # over max_chars_per_word -> [UNK]
    "x" * 100 + " " + "x" * 101,  # at and past the limit
    "a man, rides; horses!!",
    "a_man rides\thorses\nagain 999",
    "x\x1cy\x1dz\x1e\x1f",  # U+001C-U+001F are whitespace to Python's \s
    "a\x00man",  # NUL is a character like another
    "unébelievable café",  # non-ASCII: the Python path
    "café the",
    "MAN Rides",
]


@pytest.mark.parametrize("lowercase", [True, False])
def test_ids_equal_jax(lowercase):
    want = jbt.WordPieceTokenizer(VOCAB, lowercase=lowercase)
    plain = pbt.WordPieceTokenizer(VOCAB, lowercase=lowercase)
    native = NativeWordPieceTokenizer(VOCAB, lowercase=lowercase)
    for text in TEXTS:
        ids = want.encode(text)
        assert plain.encode(text) == ids, repr(text)
        assert native.encode(text) == ids, repr(text)
    assert native.native_calls == sum(t.isascii() for t in TEXTS)


def test_random_ascii_equal_jax():
    r = np.random.RandomState(0)
    alphabet = np.array(list("aehmnorsux9_!,; \t\n\x1c\x1fAEMX"))
    want = jbt.WordPieceTokenizer(VOCAB)
    native = NativeWordPieceTokenizer(VOCAB)
    for _ in range(300):
        text = "".join(r.choice(alphabet, size=r.randint(0, 40)))
        assert native.encode(text) == want.encode(text), repr(text)


def test_bert_text_transform_equal_jax(tmp_path):
    vocab_file = tmp_path / "vocab.txt"
    vocab_file.write_text("\n".join(v for v in VOCAB if v.strip()) + "\n")
    want = jbt.BertTextTransform(str(vocab_file), max_length=8)
    got = pbt.BertTextTransform(str(vocab_file), max_length=8)
    texts = ["a man rides horses", "unbelievable! " * 5, "the"]
    out = got(texts)
    assert out.dtype == torch.int64
    np.testing.assert_array_equal(out.numpy(), want(texts))
    np.testing.assert_array_equal(got("a man").numpy(), want("a man"))

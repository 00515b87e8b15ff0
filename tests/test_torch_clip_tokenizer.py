"""The port's CLIP tokenizer and transforms (multimodal_tpu_torch/
transforms/clip_transform.py, native/bpe.py) held against the JAX
package's (multimodal_tpu/transforms/clip_transform.py, which pre-tokenizes
with the third-party ``regex`` module). Token ids must be exactly equal;
images exactly equal (the same PIL calls and float32 arithmetic)."""

import os

import numpy as np
import pytest
import regex
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from multimodal_tpu.transforms import clip_transform as jct
from multimodal_tpu_torch.data.imagenet_zeroshot import imagenet_classnames
from multimodal_tpu_torch.native.bpe import NativeCLIPBPETokenizer
from multimodal_tpu_torch.training.zero_shot import DEFAULT_PROMPT_TEMPLATES
from multimodal_tpu_torch.transforms import clip_transform as pct

BPE_PATH = os.path.join(os.path.dirname(__file__), "assets", "clip_merges.bpe")
NUM_MERGES = 48894
JAX_PATTERN = regex.compile(jct._TOKEN_PATTERN, regex.IGNORECASE)

# tests/test_native_bpe.py's prompts
PROMPTS = [
    "a photo of a cat sitting on a windowsill",
    "the quick brown fox jumps over 12 lazy dogs!",
    "it's a beautiful day... isn't it?",
    "supercalifragilisticexpialidocious antidisestablishmentarianism",
    "numbers 1234567890 and sym&ols @#%",
]
CORNER_CASES = [
    "aͅb", "ͅ", "x\x1cy", "x\x1dy", "x\x1e\x1fy", "\x1c", " \x1c ", "IT'S", "WE'LL", "'S'LL'D",
    "<|startoftext|>", "a <|startoftext|> b<|endoftext|>c", "!<|endoftext|>",
    "<|ſtartoftext|>", "'ſ", "١٢٣", "Ⅻ", "½", "x²", "一二三", "漢字とカタカナ",
    "🙂👍🏽", "é", "naïve café", "ǅ", "　a\xa0b c", "a" * 80,
    "\x7f" * 600,  # one pre-token of 600 symbols: more ids than the C++ buffer holds
]


@pytest.fixture(scope="module")
def tokenizers():
    return (jct.CLIPBPETokenizer(BPE_PATH, num_merges=NUM_MERGES),
            pct.CLIPBPETokenizer(BPE_PATH, num_merges=NUM_MERGES),
            NativeCLIPBPETokenizer(BPE_PATH, num_merges=NUM_MERGES))


def _assert_same_ids(tokenizers, text):
    want = tokenizers[0].encode(text)
    assert tokenizers[1].encode(text) == want, repr(text)
    assert tokenizers[2].encode(text) == want, repr(text)


def test_bytes_to_unicode_identical():
    assert list(pct.bytes_to_unicode().items()) == list(jct.bytes_to_unicode().items())


def test_vocab_identical(tokenizers):
    jax_tok, port_tok, _ = tokenizers
    assert port_tok.encoder == jax_tok.encoder
    assert port_tok.num_merges == jax_tok.num_merges == NUM_MERGES


@pytest.mark.parametrize("text", PROMPTS + CORNER_CASES)
def test_ids_equal_jax(tokenizers, text):
    _assert_same_ids(tokenizers, text)
    assert pct.pre_tokenize(text.lower().strip()) == JAX_PATTERN.findall(text.lower().strip())


def test_corner_case_pieces():
    """The pre-tokens the JAX pattern gives on its corner cases, spelled
    out: U+001C-U+001F are punctuation, not whitespace; U+0345 is dropped;
    IGNORECASE takes the uppercase contractions and U+017F's fold."""
    assert pct.pre_tokenize("x\x1cy") == ["x", "\x1c", "y"]
    assert pct.pre_tokenize("aͅb") == ["a", "b"]
    assert pct.pre_tokenize("ͅ") == []
    assert pct.pre_tokenize("IT'S") == ["IT", "'S"]
    assert pct.pre_tokenize("'ſun") == ["'ſ", "un"]
    assert pct.pre_tokenize("١٢٣ ½") == ["١", "٢", "٣", "½"]
    assert pct.pre_tokenize("一二") == ["一二"]  # CJK numerals are letters (Lo)


def test_native_counts_calls_and_fallbacks(tokenizers):
    native = tokenizers[2]
    calls, fallbacks = native.native_calls, native.fallbacks
    native.encode("a photo of " + "\x7f" * 600)
    assert native.native_calls == calls + 4
    assert native.fallbacks == fallbacks + 1


def test_imagenet_classnames_default_templates(tokenizers):
    """All 1,000 class names under the 7 default templates."""
    for name in imagenet_classnames():
        for template in DEFAULT_PROMPT_TEMPLATES:
            _assert_same_ids(tokenizers, template.format(name))


# Text over every code point but Cs (lone surrogates), which UTF-8 cannot
# encode; Cn (unassigned in this Python's unicodedata) is drawn too, since
# the port's classes carry the regex module's newer tables
# (transforms/_unicode_tables.py).
ASSIGNED = st.characters(exclude_categories=("Cs",))
PIECES = st.one_of(st.text(ASSIGNED, max_size=8), st.sampled_from(
    ["<|startoftext|>", "<|endoftext|>", "'s", "'LL", "'d", " ", "\x1c", "ͅ", "ſ", "'"]))


def test_classes_equal_regex_on_every_code_point():
    """The letter and number classes against regex's \\p{L} and \\p{N} over
    every code point but the surrogates (one string, one pass of the
    tokenizer's class table), and the pre-tokens of that string."""
    text = "".join(chr(cp) for cp in range(0x110000) if not 0xD800 <= cp <= 0xDFFF)
    got = np.frombuffer(text.translate(pct._CLASSES).encode("utf-32-le"), np.uint32)
    want = np.full(len(text), ord("x"), np.uint32)
    for pattern, cls in ((r"\p{L}+", pct._LETTER), (r"\p{N}+", pct._NUMBER)):
        for m in regex.finditer(pattern, text):
            want[m.start():m.end()] = ord(cls)
    classes = (ord(pct._LETTER), ord(pct._NUMBER))
    mismatch = np.isin(got, classes) | np.isin(want, classes)
    mismatch &= got != want
    points = np.frombuffer(text.encode("utf-32-le"), np.uint32)
    assert not mismatch.any(), [hex(c) for c in points[mismatch][:10]]
    assert pct.pre_tokenize(text) == JAX_PATTERN.findall(text)


@settings(max_examples=300, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(st.lists(PIECES, max_size=8).map("".join))
def test_ids_equal_jax_on_assigned_text(tokenizers, text):
    assert pct.pre_tokenize(text) == JAX_PATTERN.findall(text)
    _assert_same_ids(tokenizers, text)


@pytest.mark.parametrize("text", ["a\x1c\x1d b\t\n c　d", "  x  ", "\xa0y "])
def test_cleaners_equal_jax(text, monkeypatch):
    # the JAX package's path without ftfy, which the port follows (a stub
    # ftfy that another test file may have installed must not stand in)
    monkeypatch.setattr(jct, "_HAS_FTFY", False)
    assert pct.whitespace_clean(text) == jct.whitespace_clean(text)
    assert pct.basic_clean(text + " &amp;amp; é") == jct.basic_clean(
        text + " &amp;amp; é")


def test_decode_equal_jax(tokenizers):
    jax_tok, port_tok, _ = tokenizers
    ids = jax_tok.encode("naïve café, 12 dogs!")
    assert port_tok.decode(ids) == jax_tok.decode(ids)


@pytest.mark.parametrize("native", [False, True])
def test_text_transform_equal_jax(native):
    long = " ".join(["photograph"] * 40) + " of a " + "very " * 50 + "long prompt"
    texts = PROMPTS + [long, "", "<|endoftext|>"]
    want = jct.CLIPTextTransform(BPE_PATH)(texts)
    transform = pct.CLIPTextTransform(BPE_PATH, native=native)
    got = transform(texts)
    assert got.dtype == torch.int64 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.shape == (len(texts), 77)
    assert int(got[5, 76]) == 49407  # the long prompt: 75 tokens kept, then EOS
    np.testing.assert_array_equal(transform(long).numpy(), jct.CLIPTextTransform(BPE_PATH)(long))


def _image(r, h, w):
    return r.randint(0, 256, size=(h, w, 3)).astype(np.uint8)


@pytest.mark.parametrize("is_train", [False, True])
def test_image_transform_equal_jax(is_train):
    r = np.random.RandomState(0)
    images = [_image(r, 300, 200), _image(r, 150, 400), _image(r, 224, 224)]
    jax_t = jct.CLIPImageTransform(is_train=is_train, rng=np.random.RandomState(5))
    port_t = pct.CLIPImageTransform(is_train=is_train, rng=np.random.RandomState(5))
    for im in images:
        got = port_t(im)
        assert got.dtype == torch.float32 and got.shape == (224, 224, 3)
        np.testing.assert_array_equal(got.numpy(), jax_t(im))


def test_joint_transform_equal_jax():
    r = np.random.RandomState(1)
    images = [_image(r, 260, 240), _image(r, 240, 260)]
    jax_t = jct.CLIPTransform(BPE_PATH, image_size=64)
    port_t = pct.CLIPTransform(BPE_PATH, image_size=64)
    jax_t.image_transform.rng = np.random.RandomState(3)
    port_t.image_transform.rng = np.random.RandomState(3)
    want = jax_t(images, PROMPTS[:2])
    got = port_t(images, PROMPTS[:2])
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    np.testing.assert_array_equal(got[1].numpy(), want[1])

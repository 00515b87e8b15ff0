"""The port's LongContextLM (multimodal_tpu_torch/examples/long_context/model.py)
held against the JAX package's, through the weight carry-over
utils/checkpoint.py:long_context_lm_state_dict_from_jax.

A tiny model (2 layers, width 128, 4 heads, d_ff 512, vocab 256, 256
positions) in fp32 on the CPU: the full causal forward, the keys and values
it returns, and decode over a fixed-size cache, bf16 and int8, token by
token with per-row positions, as the serving engine drives it. Inputs come
from a numpy seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_tpu.examples.long_context.model import LongContextLM as JaxLM
from multimodal_tpu.examples.long_context.model import next_token_loss as jax_loss
from multimodal_tpu.models.clip.transformer import CLIPTransformer as JaxCLIPTransformer
from multimodal_tpu.ops.kv_cache import QuantizedKV as JaxQKV
from multimodal_tpu.ops.kv_cache import quantize_kv as jax_quantize
from multimodal_tpu_torch.examples.long_context.model import LongContextLM, next_token_loss
from multimodal_tpu_torch.models.clip.transformer import CLIPTransformer
from multimodal_tpu_torch.ops import attention as tattn
from multimodal_tpu_torch.ops.kv_cache import QuantizedKV, quantize_kv, quantized_kv_zeros
from multimodal_tpu_torch.utils.checkpoint import (
    _encoder_stack,
    long_context_lm_state_dict_from_jax,
)

CONFIG = dict(vocab_size=256, max_seq_len=256, n_layer=2, d_model=128, n_head=4,
              dim_feedforward=512)
L = 256  # cache length: a multiple of 128, so both sides take the int8 kernel route
# fp32 through two layers: the same arithmetic in two frameworks, sums in
# another order (the MLP's fused plain version against the JAX dense path).
ATOL = 1e-4
# Decode over a bf16 cache: both round the cached k/v and then the
# probabilities and the attention output to bf16; a sum in another order can
# move one output rounding across a tie, one bf16 ulp (2^-8 relative) of an
# attention output of |a| < 2, which the output projection and the later
# layer carry to the logits at about that size.
ATOL_BF16_CACHE = 2e-2
# Decode over an int8 cache: the kernel route rounds q to bf16 on both sides.
# With rope, q comes from sin and cos of two libraries that differ by an ulp,
# which can move that rounding across a tie (2^-8 of one q element; 1.2e-3
# seen in the logits).
ATOL_INT8_ROPE = 4e-3


def _pair(**overrides):
    cfg = {**CONFIG, **overrides}
    jax_model = JaxLM(**cfg)
    variables = jax_model.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    variables = jax.tree_util.tree_map(np.asarray, variables)
    port = LongContextLM(**cfg).eval()
    port.load_state_dict(long_context_lm_state_dict_from_jax(variables), strict=True)
    return jax_model, variables, port


@pytest.fixture(scope="module")
def learned():
    return _pair()


@pytest.fixture(scope="module")
def rope_gqa():
    return _pair(positional="rope", n_kv_head=2)


def _tokens(b, s, seed=0):
    return np.random.RandomState(seed).randint(0, CONFIG["vocab_size"], size=(b, s)).astype(np.int32)


@pytest.mark.parametrize("which", ["learned", "rope_gqa"])
def test_causal_logits_and_kv_match_jax(which, request):
    jax_model, variables, port = request.getfixturevalue(which)
    toks = _tokens(3, 40)
    want, want_kv = jax_model.apply(variables, jnp.asarray(toks), use_cache=True)
    with torch.no_grad():
        got, got_kv = port(torch.from_numpy(toks).long(), use_cache=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    assert len(got_kv) == CONFIG["n_layer"]
    for (gk, gv), (wk, wv) in zip(got_kv, want_kv):
        assert gk.shape == wk.shape  # (b, kv heads, s, head_dim)
        np.testing.assert_allclose(gk.numpy(), np.asarray(wk), atol=ATOL)
        np.testing.assert_allclose(gv.numpy(), np.asarray(wv), atol=ATOL)
    loss = next_token_loss(got[:, :-1], torch.from_numpy(toks[:, 1:]))
    np.testing.assert_allclose(loss.item(), float(jax_loss(want[:, :-1], jnp.asarray(toks[:, 1:]))),
                               rtol=1e-5)


def _jax_rows(cache, kv, lens):
    """Write each row's first lens[i] prefill keys/values into a JAX cache."""
    if isinstance(cache, JaxQKV):
        q, s = jax_quantize(kv)
        return JaxQKV(q=cache.q.at[:, :, : kv.shape[2]].set(q),
                      scale=cache.scale.at[:, :, : kv.shape[2]].set(s))
    return cache.at[:, :, : kv.shape[2]].set(kv.astype(cache.dtype))


@pytest.mark.parametrize("cache", ["bfloat16", "int8"])
@pytest.mark.parametrize("which", ["learned", "rope_gqa"])
def test_decode_over_a_fixed_cache_matches_jax(which, cache, request):
    """Prefill prompts of different lengths (one padded batch), write their
    rows into the cache, then decode 4 teacher-forced ticks with per-row
    positions and valid-prefix masks."""
    jax_model, variables, port = request.getfixturevalue(which)
    b, s0 = 3, 24
    lens = np.array([24, 17, 9])
    prompt = _tokens(b, s0, seed=1)
    feed = _tokens(b, 4, seed=2)
    kv_heads = port.n_kv_head or port.n_head
    shape = (b, kv_heads, L, CONFIG["d_model"] // CONFIG["n_head"])

    _, jkv = jax_model.apply(variables, jnp.asarray(prompt), use_cache=True)
    with torch.no_grad():
        _, tkv = port(torch.from_numpy(prompt).long(), use_cache=True)
    if cache == "int8":
        jcache = [(JaxQKV(q=jnp.zeros(shape, jnp.int8), scale=jnp.zeros(shape[:-1])),) * 2
                  for _ in range(CONFIG["n_layer"])]
        tcache = [(quantized_kv_zeros(shape), quantized_kv_zeros(shape))
                  for _ in range(CONFIG["n_layer"])]
    else:
        jcache = [(jnp.zeros(shape, jnp.bfloat16),) * 2 for _ in range(CONFIG["n_layer"])]
        tcache = [(torch.zeros(shape, dtype=torch.bfloat16), torch.zeros(shape, dtype=torch.bfloat16))
                  for _ in range(CONFIG["n_layer"])]
    jcache = tuple((_jax_rows(ck, k, lens), _jax_rows(cv, v, lens))
                   for (ck, cv), (k, v) in zip(jcache, jkv))
    for (ck, cv), (k, v) in zip(tcache, tkv):
        for c, new in ((ck, k), (cv, v)):
            if isinstance(c, QuantizedKV):
                q, sc = quantize_kv(new)
                c.q[:, :, :s0], c.scale[:, :, :s0] = q, sc
            else:
                c[:, :, :s0] = new.to(c.dtype)
    tcache = tuple(tcache)

    pos = lens.copy()
    atol = ATOL_BF16_CACHE if cache == "bfloat16" else (
        ATOL_INT8_ROPE if port.positional == "rope" else ATOL)
    for t in range(feed.shape[1]):
        mask = np.arange(L)[None, None, None, :] <= pos[:, None, None, None]
        want, jcache = jax_model.apply(
            variables, jnp.asarray(feed[:, t:t + 1]), positions=jnp.asarray(pos[:, None]),
            past_key_values=jcache, cache_index=jnp.asarray(pos), attention_mask=jnp.asarray(mask),
            use_cache=True)
        with torch.no_grad():
            got, tcache = port(torch.from_numpy(feed[:, t:t + 1]).long(),
                               positions=torch.from_numpy(pos[:, None]),
                               past_key_values=tcache, cache_index=torch.from_numpy(pos),
                               attention_mask=torch.from_numpy(mask), use_cache=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol, err_msg=f"tick {t}")
        pos = pos + 1
    if cache == "int8":  # the cache stayed int8 and holds the same codes (rope: within one
        # step, where a rotated k from two libraries' sin/cos rounds across a tie)
        assert isinstance(tcache[0][0], QuantizedKV)
        for (tk, tv), (jk, jv) in zip(tcache, jcache):
            for t_, j_ in ((tk, jk), (tv, jv)):
                step = np.abs(t_.q.numpy().astype(np.int32) - np.asarray(j_.q).astype(np.int32))
                assert step.max() <= (1 if port.positional == "rope" else 0)


def test_clip_layer_beyond_the_fused_kernels_matches_jax():
    """CLIP layers at S > 256 (ViT-L/14 has 257 tokens) take the JAX layer's
    non-fused dispatch: split heads through scaled_dot_product_attention
    (plain math, and the flash wrapper from FLASH_MIN_SEQ up) and the plain
    quick-GELU MLP."""
    width, heads = 64, 2
    for s, causal in ((257, False), (max(300, tattn.FLASH_MIN_SEQ + 3), True)):
        jax_model = JaxCLIPTransformer(width=width, heads=heads, layers=1)
        x = np.random.RandomState(s).randn(2, s, width).astype(np.float32)
        variables = jax.tree_util.tree_map(
            np.asarray, jax_model.init(jax.random.PRNGKey(1), jnp.asarray(x)))
        port = CLIPTransformer(width, heads, 1).eval()
        port.load_state_dict(
            {k.removeprefix("enc."): v
             for k, v in _encoder_stack(variables["params"], "enc", 1).items()},
            strict=True)
        want = jax_model.apply(variables, jnp.asarray(x), is_causal=causal)
        with torch.no_grad():
            got = port(torch.from_numpy(x), is_causal=causal)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("cache", ["float32", "int8"])
@pytest.mark.parametrize("kind", ["scalar", "per_row", "per_position"])
def test_write_fixed_cache_matches_jax(kind, cache):
    """The fixed-buffer cache write with each kind of cache_index (the
    port writes in place, the JAX layer returns updated arrays)."""
    from multimodal_tpu.modules.layers.multi_head_attention import (
        _write_fixed_cache as jax_write,
    )
    from multimodal_tpu_torch.modules.layers.multi_head_attention import _write_fixed_cache

    r = np.random.RandomState(7)
    b, h, length, s_new, d = 3, 2, 16, 3, 8
    k, v = (r.randn(b, h, s_new, d).astype(np.float32) for _ in range(2))
    index = {"scalar": np.int64(14),  # clamps to length - s_new
             "per_row": np.array([0, 5, 15]),
             "per_position": np.array([[1, 2, 3], [9, 4, 0], [15, 14, 13]])}[kind]
    if cache == "int8":
        jc = (JaxQKV(q=jnp.zeros((b, h, length, d), jnp.int8), scale=jnp.zeros((b, h, length))),) * 2
        tc = (quantized_kv_zeros((b, h, length, d)), quantized_kv_zeros((b, h, length, d)))
    else:
        jc = (jnp.zeros((b, h, length, d)),) * 2
        tc = (torch.zeros(b, h, length, d), torch.zeros(b, h, length, d))
    want = jax_write(jc, jnp.asarray(k), jnp.asarray(v), jnp.asarray(index))
    got = _write_fixed_cache(tc, torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(
        np.asarray(index)))
    for g, w in zip(got, want):
        if cache == "int8":
            np.testing.assert_array_equal(g.q.numpy(), np.asarray(w.q))
            np.testing.assert_array_equal(g.scale.numpy(), np.asarray(w.scale))
        else:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))

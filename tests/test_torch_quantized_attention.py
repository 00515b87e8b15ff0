"""The port's int8 KV cache (multimodal_tpu_torch/ops/kv_cache.py) and its
decode attention (ops/quantized_attention.py, kernel #10) held against the
JAX package's.

On the CPU the port's wrapper runs its plain PyTorch version; the JAX
``quantized_cache_attention`` runs its Pallas kernel in interpret mode (as
tests/serving/test_kv_quant.py does through the engine). Inputs come from a
numpy seed and go to both as the same arrays; cache lengths are multiples of
128, the lengths the TPU kernel takes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_tpu.ops import kv_cache as jkv
from multimodal_tpu.ops import quantized_attention as jqa
from multimodal_tpu_torch.ops import kv_cache as tkv
from multimodal_tpu_torch.ops import quantized_attention as tqa

# Both round q to bf16, take fp32 scores (sums in another order: 6e-8 seen)
# and round p * v_scale to bf16 at the same point. fp32 outputs: 1e-5. bf16
# outputs: one bf16 ulp of the output scale, for an exp that differs by an
# ulp and moves a rounding across a tie (none seen).
ATOL_F32 = 1e-5


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_bit_equal(dtype):
    r = np.random.RandomState(0)
    x = r.randn(2, 3, 40, 64).astype(np.float32) * r.rand(2, 3, 40, 1).astype(np.float32) * 3
    x[0, 0, 0] = 0.0  # an all-zero row: the 1e-8 scale floor
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16,
                                                                        torch.bfloat16)
    jq, js = jkv.quantize_kv(jnp.asarray(x, jdt))
    tq, ts = tkv.quantize_kv(torch.from_numpy(x).to(tdt))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    deq = tkv.QuantizedKV(tq, ts).dequantize()
    want = jkv.QuantizedKV(q=jq, scale=js).dequantize()
    np.testing.assert_array_equal(deq.numpy(), np.asarray(want))


def _caches(b, h, length, d, seed):
    r = np.random.RandomState(seed)
    k = r.randn(b, h, length, d).astype(np.float32)
    v = r.randn(b, h, length, d).astype(np.float32)
    (kq, ks), (vq, vs) = tkv.quantize_kv(torch.from_numpy(k)), tkv.quantize_kv(torch.from_numpy(v))
    return (kq.numpy(), ks.numpy()), (vq.numpy(), vs.numpy())


# (name, b, h_q, h_kv, S, L, d)
CASES = [
    ("mha_decode", 3, 4, 4, 1, 128, 64),
    ("mha_decode_256", 2, 4, 4, 1, 256, 32),
    ("verify_window", 2, 4, 4, 5, 128, 64),
    ("verify_window_256", 2, 2, 2, 5, 256, 32),
    ("gqa_group4", 2, 8, 2, 2, 128, 64),
    ("gqa_group4_256", 1, 8, 2, 2, 256, 32),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,b,hq,hkv,s,length,d", CASES, ids=[c[0] for c in CASES])
def test_quantized_cache_attention_matches_jax(name, b, hq, hkv, s, length, d, dtype):
    r = np.random.RandomState(1)
    q = r.randn(b, hq, s, d).astype(np.float32)
    (kq, ks), (vq, vs) = _caches(b, hkv, length, d, seed=2)
    # partial-prefix masks: row i of a verify window sees positions <= pos + i
    pos = r.randint(0, length - s, size=b)
    mask = np.arange(length)[None, None, None, :] <= (pos[:, None] + np.arange(s))[:, None, :, None]
    assert mask.shape == (b, 1, s, length)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16,
                                                                        torch.bfloat16)
    assert jqa.supports_quantized_attention(jnp.asarray(q), jnp.asarray(mask), 0.0, False, hkv)
    assert tqa.supports_quantized_attention(torch.from_numpy(q), torch.from_numpy(mask), 0.0,
                                            False, hkv)
    want = jqa.quantized_cache_attention(
        jnp.asarray(q, jdt), jkv.QuantizedKV(q=jnp.asarray(kq), scale=jnp.asarray(ks)),
        jkv.QuantizedKV(q=jnp.asarray(vq), scale=jnp.asarray(vs)), jnp.asarray(mask))
    tqa.reset_launch_counts()
    got = tqa.quantized_cache_attention(
        torch.from_numpy(q).to(tdt), tkv.QuantizedKV(torch.from_numpy(kq), torch.from_numpy(ks)),
        tkv.QuantizedKV(torch.from_numpy(vq), torch.from_numpy(vs)), torch.from_numpy(mask))
    assert got.dtype == tdt and got.shape == (b, hq, s, d)
    assert tqa.quantized_cache_attention.launches == 0  # CPU tensors: no kernel
    want = np.asarray(want.astype(jnp.float32))
    atol = ATOL_F32 if dtype == "float32" else 2.0 ** -8 * max(1.0, np.abs(want).max())
    np.testing.assert_allclose(got.float().numpy(), want, atol=atol)


def test_predicate_follows_the_jax_rule():
    q = torch.zeros(2, 4, 1, 64)
    mask = torch.ones(2, 1, 1, 256, dtype=torch.bool)
    assert tqa.supports_quantized_attention(q, mask, 0.0)
    assert not tqa.supports_quantized_attention(q, mask, 0.1)  # dropout
    assert not tqa.supports_quantized_attention(q, None, 0.0)  # no mask
    assert not tqa.supports_quantized_attention(q, mask, 0.0, is_causal=True)
    assert not tqa.supports_quantized_attention(q, mask.float(), 0.0)  # a bias
    assert not tqa.supports_quantized_attention(q, mask.expand(2, 4, 1, 256), 0.0)
    assert not tqa.supports_quantized_attention(torch.zeros(2, 4, 9, 64), mask, 0.0)  # 9 rows
    assert not tqa.supports_quantized_attention(torch.zeros(2, 8, 3, 64), mask, 0.0,
                                                kv_heads=2)  # group 4 x 3 rows
    assert not tqa.supports_quantized_attention(torch.zeros(2, 4, 1, 48), mask, 0.0)
    # the whole score row must fit a block's shared memory
    assert tqa.supports_quantized_attention(q, torch.ones(1, 1, 1, 50_000, dtype=torch.bool), 0.0)
    assert not tqa.supports_quantized_attention(q, torch.ones(1, 1, 1, 60_000, dtype=torch.bool),
                                                0.0)

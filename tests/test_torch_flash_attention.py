"""The port's flash attention forward (multimodal_tpu_torch/ops/flash_attention.py,
kernel #6) held against the JAX package's Pallas kernel, and the port's
attention dispatch (ops/attention.py) against the JAX package's.

On the CPU the port's wrapper runs its plain PyTorch version; the JAX
``flash_attention_forward`` runs its Pallas kernel in interpret mode (as
tests/ops/test_flash_attention.py does). Inputs come from a numpy seed and
go to both as the same arrays. The lse is compared in log2 space, the JAX
kernel's ``lse[..., :Sq, 0]``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_tpu.ops import attention as jattn
from multimodal_tpu.ops import flash_attention as jfa
from multimodal_tpu_torch.ops import attention as tattn
from multimodal_tpu_torch.ops import flash_attention as tfa

# fp32: the same log2-space arithmetic in two frameworks, sums in another
# order and exp2 from two libraries (a few ulps each) over up to 1000 keys.
ATOL_F32 = 2e-5
# bf16: both round the probabilities and the output to bf16 at the same
# points; an exp2 that differs by an ulp can move a rounding across a tie,
# which shows as one bf16 ulp of the output (2^-8 at |o| < 1) plus its effect
# on the sum. Two ulps.
ATOL_BF16 = 2.0 ** -7
LSE_ATOL = 2e-5  # log2-space lse of fp32 scores (|lse| < 16)

# (name, b, h, sq, sk, d, causal, bias shape or None, segments)
CASES = [
    ("causal", 1, 2, 256, 256, 64, True, None, False),
    ("sq_lt_sk_causal", 1, 2, 128, 512, 64, True, None, False),
    ("non_causal", 2, 2, 192, 192, 64, False, None, False),
    ("segment_ids", 2, 2, 256, 256, 64, True, None, True),
    ("bias_1h1k", 2, 2, 160, 160, 64, False, "1h1k", False),
    ("bias_b1qk", 2, 2, 160, 160, 64, True, "b1qk", False),
    ("ragged_1000", 1, 1, 1000, 1000, 32, True, None, False),
    ("head_width_32", 1, 2, 128, 128, 32, False, None, False),
    ("head_width_128", 1, 2, 128, 128, 128, True, None, False),
]


def _inputs(b, h, sq, sk, d, bias_kind, segments, seed=0):
    r = np.random.RandomState(seed)
    q = r.randn(b, h, sq, d).astype(np.float32)
    k = r.randn(b, h, sk, d).astype(np.float32)
    v = r.randn(b, h, sk, d).astype(np.float32)
    bias = None
    if bias_kind == "1h1k":  # ALiBi-style per-head key ramp
        bias = (-0.05 * r.rand(1, h, 1, 1) * np.arange(sk)[None, None, None, :]).astype(np.float32)
    elif bias_kind == "b1qk":
        bias = r.randn(b, 1, sq, sk).astype(np.float32)
    qseg = kvseg = None
    if segments:  # packed documents: every query sees at least its own key
        cuts = np.sort(r.choice(np.arange(1, sq), size=(b, 3), replace=False), axis=1)
        qseg = np.stack([np.searchsorted(c, np.arange(sq), side="right") for c in cuts])
        qseg = qseg.astype(np.int32)
        kvseg = qseg.copy()
    return q, k, v, bias, qseg, kvseg


def _jax(q, k, v, bias, causal, qseg, kvseg, dtype):
    c = lambda a: None if a is None else jnp.asarray(a)
    out, lse = jfa.flash_attention_forward(
        jnp.asarray(q, dtype), jnp.asarray(k, dtype), jnp.asarray(v, dtype), c(bias),
        causal=causal, return_lse=True, q_segment_ids=c(qseg), kv_segment_ids=c(kvseg))
    return np.asarray(out.astype(jnp.float32)), np.asarray(lse)[:, :, : q.shape[2], 0]


def _port(q, k, v, bias, causal, qseg, kvseg, dtype):
    c = lambda a: None if a is None else torch.from_numpy(a)
    out, lse = tfa.flash_attention_forward(
        torch.from_numpy(q).to(dtype), torch.from_numpy(k).to(dtype),
        torch.from_numpy(v).to(dtype), c(bias), causal=causal, return_lse=True,
        q_segment_ids=c(qseg), kv_segment_ids=c(kvseg))
    return out.float().numpy(), lse.numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,b,h,sq,sk,d,causal,bias_kind,segments", CASES,
                         ids=[c[0] for c in CASES])
def test_flash_forward_matches_jax(name, b, h, sq, sk, d, causal, bias_kind, segments, dtype):
    q, k, v, bias, qseg, kvseg = _inputs(b, h, sq, sk, d, bias_kind, segments)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16,
                                                                        torch.bfloat16)
    want, want_lse = _jax(q, k, v, bias, causal, qseg, kvseg, jdt)
    got, got_lse = _port(q, k, v, bias, causal, qseg, kvseg, tdt)
    np.testing.assert_allclose(got, want, atol=ATOL_F32 if dtype == "float32" else ATOL_BF16)
    np.testing.assert_allclose(got_lse, want_lse, atol=LSE_ATOL, rtol=1e-6)


def test_rows_that_see_no_key():
    """A query row whose segment id matches no key: the port defines it as
    output 0 and lse -inf. The TPU kernel masks with -1e30 and so returns the
    mean of V over its padded block there (a value set by its 1024-wide
    blocks), so those rows are left out of the comparison; every other row
    must agree."""
    q, k, v, _, _, _ = _inputs(2, 2, 96, 96, 64, None, False, seed=3)
    qseg = np.zeros((2, 96), np.int32)
    kvseg = np.zeros((2, 96), np.int32)
    qseg[:, 40:50] = 7  # id 7 appears in no key
    want, want_lse = _jax(q, k, v, None, False, qseg, kvseg, jnp.float32)
    got, got_lse = _port(q, k, v, None, False, qseg, kvseg, torch.float32)
    blind = qseg == 7
    assert np.all(got[:, :, 40:50] == 0.0)
    assert np.all(np.isneginf(got_lse[:, :, 40:50]))
    seen = ~blind[:, None, :, None].repeat(2, 1)
    np.testing.assert_allclose(np.where(seen, got, 0), np.where(seen, want, 0), atol=ATOL_F32)
    np.testing.assert_allclose(got_lse[:, :, :40], want_lse[:, :, :40], atol=LSE_ATOL)
    # causal with Sq > Sk: the first Sq - Sk rows see nothing
    q2 = q[:, :, :64]
    k2, v2 = k[:, :, :32], v[:, :, :32]
    want, want_lse = _jax(q2, k2, v2, None, True, None, None, jnp.float32)
    got, got_lse = _port(q2, k2, v2, None, True, None, None, torch.float32)
    assert np.all(got[:, :, :32] == 0.0) and np.all(np.isneginf(got_lse[:, :, :32]))
    np.testing.assert_allclose(got[:, :, 32:], want[:, :, 32:], atol=ATOL_F32)


# The dispatch: plain math below the port's threshold (JAX's XLA path on the
# CPU), the flash wrapper from it up; bool key-padding masks become segment
# ids, other masks a bias. fp32 throughout.
DISPATCH_CASES = [
    ("short_causal", 2, 2, 40, 40, True, None),
    ("short_padding_mask", 2, 2, 40, 40, False, "padding"),
    ("short_full_mask", 2, 2, 40, 40, False, "full"),
    ("long_causal", 1, 2, tattn.FLASH_MIN_SEQ, tattn.FLASH_MIN_SEQ, True, None),
    ("long_padding_mask", 2, 2, tattn.FLASH_MIN_SEQ, tattn.FLASH_MIN_SEQ, False, "padding"),
    ("long_padding_mask_causal", 2, 1, tattn.FLASH_MIN_SEQ + 8, tattn.FLASH_MIN_SEQ + 8, True,
     "padding"),
    ("long_padding_mask_one_row", 2, 2, tattn.FLASH_MIN_SEQ, tattn.FLASH_MIN_SEQ, False,
     "padding_one_row"),
]


@pytest.mark.parametrize("name,b,h,sq,sk,causal,mask_kind", DISPATCH_CASES,
                         ids=[c[0] for c in DISPATCH_CASES])
def test_sdpa_dispatch_matches_jax(name, b, h, sq, sk, causal, mask_kind):
    q, k, v, _, _, _ = _inputs(b, h, sq, sk, 32, None, False, seed=5)
    r = np.random.RandomState(6)
    mask = None
    if mask_kind == "padding":
        mask = np.ones((b, 1, 1, sk), bool)
        mask[0, ..., sk - 7:] = False
    elif mask_kind == "padding_one_row":  # one mask row broadcast over the batch
        mask = np.ones((1, 1, 1, sk), bool)
        mask[..., sk - 7:] = False
    elif mask_kind == "full":
        mask = r.rand(b, 1, sq, sk) > 0.3
        mask[..., 0] = True
    want = jattn.scaled_dot_product_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        mask=None if mask is None else jnp.asarray(mask), is_causal=causal)
    tfa.reset_launch_counts()
    got = tattn.scaled_dot_product_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        mask=None if mask is None else torch.from_numpy(mask), is_causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL_F32)
    assert tfa.flash_attention_forward.launches == 0  # CPU tensors: no kernel


def test_sdpa_probs_and_dropout_stay_plain():
    q, k, v, _, _, _ = _inputs(1, 2, tattn.FLASH_MIN_SEQ, tattn.FLASH_MIN_SEQ, 32, None, False)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    out, probs = tattn.scaled_dot_product_attention(tq, tk, tv, is_causal=True,
                                                    return_probs=True)
    want, want_p = jattn.scaled_dot_product_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), is_causal=True, return_probs=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=ATOL_F32)
    np.testing.assert_allclose(probs.numpy(), np.asarray(want_p), atol=1e-6)
    g = torch.Generator().manual_seed(0)
    dropped = tattn.scaled_dot_product_attention(tq, tk, tv, is_causal=True, dropout_rate=0.5,
                                                 generator=g)
    assert dropped.shape == out.shape and torch.isfinite(dropped).all()

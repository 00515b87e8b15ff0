"""The port's fused encoder kernels (multimodal_tpu_torch/ops/fused_encoder.py)
held against the JAX package's Pallas kernels.

On the CPU each port wrapper runs its plain PyTorch version; the JAX
functions run their Pallas kernels in interpret mode (as
tests/ops/test_fused_encoder.py does) and their XLA references. Inputs come
from a numpy seed and go to both as the same arrays.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_tpu.ops import fused_encoder as jfe
from multimodal_tpu_torch.ops import fused_encoder as tfe

# fp32 attention: the same exact-softmax arithmetic in two frameworks; the
# sums differ only in order (the JAX package's own kernel-vs-XLA tolerance).
ATTN_ATOL = 2e-5
# fp32 MLP: as above; the Pallas gelu_exact uses an erf polynomial that is
# 1.5e-7 off, far inside this.
MLP_ATOL = 1e-5


def _attention_pair(qkv, h, causal, sm_scale=None, kb=None):
    want_kernel = jfe.fused_qkv_attention(
        jnp.asarray(qkv), h, causal, sm_scale,
        None if kb is None else jnp.asarray(kb),
    )
    want_xla = jfe._qkv_attention_xla(
        jnp.asarray(qkv), h, causal, sm_scale,
        None if kb is None else jnp.asarray(kb),
    )
    got = tfe.fused_qkv_attention(
        torch.from_numpy(qkv), h, causal, sm_scale,
        None if kb is None else torch.from_numpy(kb),
    )
    return got.numpy(), np.asarray(want_kernel), np.asarray(want_xla)


@pytest.mark.parametrize(
    "b,s,d,h,causal",
    [(4, 50, 96, 12, False), (4, 77, 64, 8, True), (3, 17, 48, 3, True)],
)
def test_plain_attention_matches_jax(b, s, d, h, causal):
    qkv = np.random.RandomState(0).randn(b, s, 3 * d).astype(np.float32)
    got, want_kernel, want_xla = _attention_pair(qkv, h, causal)
    assert got.shape == (b, s, d)
    np.testing.assert_allclose(got, want_kernel, atol=ATTN_ATOL)
    np.testing.assert_allclose(got, want_xla, atol=ATTN_ATOL)


def test_plain_attention_sm_scale_matches_jax():
    qkv = np.random.RandomState(1).randn(2, 25, 3 * 64).astype(np.float32)
    got, want_kernel, want_xla = _attention_pair(qkv, 4, False, sm_scale=0.5)
    np.testing.assert_allclose(got, want_kernel, atol=ATTN_ATOL)
    np.testing.assert_allclose(got, want_xla, atol=ATTN_ATOL)


@pytest.mark.parametrize("causal", [False, True])
def test_plain_attention_key_bias_matches_jax(causal):
    r = np.random.RandomState(2)
    b, s = 3, 20
    qkv = r.randn(b, s, 3 * 64).astype(np.float32)
    kb = np.where(r.rand(b, s) < 0.3, -1e30, 0.0).astype(np.float32)
    kb[:, 0] = 0.0  # every row keeps a visible key
    got, want_kernel, want_xla = _attention_pair(qkv, 4, causal, kb=kb)
    np.testing.assert_allclose(got, want_kernel, atol=ATTN_ATOL)
    np.testing.assert_allclose(got, want_xla, atol=ATTN_ATOL)


def _mlp_inputs(seed, din=128, dff=256, dout=128):
    r = np.random.RandomState(seed)
    x = r.randn(4, 19, din).astype(np.float32)
    w1 = (r.randn(din, dff) * din ** -0.5).astype(np.float32)
    b1 = (r.randn(dff) * 0.02).astype(np.float32)
    w2 = (r.randn(dff, dout) * dff ** -0.5).astype(np.float32)
    b2 = (r.randn(dout) * 0.02).astype(np.float32)
    return x, w1, b1, w2, b2


@pytest.mark.parametrize("act", ["quick_gelu", "gelu", "gelu_exact", "relu", "silu"])
def test_plain_mlp_matches_jax(act):
    args = _mlp_inputs(3)
    want = np.asarray(jfe.fused_mlp(*map(jnp.asarray, args), act))
    got = tfe.fused_mlp(*map(torch.from_numpy, args), act).numpy()
    assert got.shape == want.shape == (4, 19, 128)
    np.testing.assert_allclose(got, want, atol=MLP_ATOL)


def test_plain_mlp_bf16_matches_jax():
    """bf16 operands: both round the fp32 intermediate to bf16 before the
    second product and the fp32 output to bf16 at the end; an intermediate
    or output landing on the other side of a rounding tie moves a value by
    a bf16 unit in the last place (2**-7 relative), so the bound is two
    such units of the output scale."""
    args = _mlp_inputs(4)
    want = np.asarray(
        jfe.fused_mlp(*(jnp.asarray(a, jnp.bfloat16) for a in args), "quick_gelu")
    ).astype(np.float32)
    got = tfe.fused_mlp(
        *(torch.from_numpy(a).to(torch.bfloat16) for a in args), "quick_gelu"
    )
    assert got.dtype == torch.bfloat16
    atol = 2 * 2.0 ** -7 * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.float().numpy(), want, atol=atol)


@pytest.mark.parametrize(
    "seq,width,heads,ok",
    [(50, 768, 12, True), (77, 512, 8, True), (256, 768, 12, True),
     (257, 1024, 16, False), (50, 768, 5, False), (50, 60, 6, False),
     (256, 1024, 4, False), (256, 1536, 12, False), (128, 1536, 12, True)],
)
def test_attention_shape_predicate(seq, width, heads, ok):
    """Admits CLIP's S=50 / 77 at head width 64; rejects sequences above 256
    (ViT-L/14's 257 goes to the flash kernels), unclean head splits, head
    widths not a multiple of 8, and blocks over the shared-memory budget."""
    assert tfe.fused_attention_supported(seq, width, heads) is ok

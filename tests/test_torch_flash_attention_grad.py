"""The port's flash attention backward (multimodal_tpu_torch/ops/flash_attention.py:
kernels #7-#9 behind ``flash_attention`` and ``flash_attention_lse``) held
against ``jax.grad`` of the JAX package's, whose backward runs its Pallas
kernels in interpret mode (as tests/ops/test_flash_bias_backward.py does).

On the CPU the port's wrappers run their plain versions. The inputs and the
output cotangent come from a numpy seed and go to both as the same arrays;
the loss is sum(out * w), so the cotangent of out is w in out's dtype. The
masking cases are #6's (tests/test_torch_flash_attention.py); a bias case
checks the bias gradient too, and again with the bias not differentiated.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_tpu.ops import flash_attention as jfa
from multimodal_tpu_torch.ops import flash_attention as tfa

from tests.test_torch_flash_attention import CASES, _inputs

# Both tolerances are relative to the largest gradient of the tensor.
# fp32: the same fp32 arithmetic in two frameworks, sums in another order
# (readings up to 9e-7).
RTOL_F32 = 1e-5
# bf16: both round ds to bf16 before ds . k and ds . q, p before p^T . do,
# and the gradients to bf16; a sum in another order can move one rounding
# across a tie, a bf16 ulp (2^-8) of an element (readings up to 2.8e-3).
RTOL_BF16 = 2.0 ** -7

DTYPES = {"float32": (jnp.float32, torch.float32, RTOL_F32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, RTOL_BF16)}


def _cotangent(b, h, sq, d):
    return np.random.RandomState(9).randn(b, h, sq, d).astype(np.float32)


def _jax_grads(q, k, v, bias, causal, qseg, kvseg, w, jdt, with_dbias):
    c = lambda a: None if a is None else jnp.asarray(a)

    def loss(q_, k_, v_, b_):
        out = jfa.flash_attention(q_, k_, v_, b_, causal, None, c(qseg), c(kvseg))
        return jnp.sum(out.astype(jnp.float32) * w)

    argnums = (0, 1, 2, 3) if with_dbias else (0, 1, 2)
    grads = jax.grad(loss, argnums=argnums)(
        jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt), c(bias))
    return [np.asarray(g.astype(jnp.float32)) for g in grads]


def _port_grads(q, k, v, bias, causal, qseg, kvseg, w, tdt, with_dbias):
    tq, tk, tv = (torch.from_numpy(a).to(tdt).requires_grad_() for a in (q, k, v))
    tb = None if bias is None else torch.from_numpy(bias).requires_grad_(with_dbias)
    c = lambda a: None if a is None else torch.from_numpy(a)
    out = tfa.flash_attention(tq, tk, tv, tb, causal, None, c(qseg), c(kvseg))
    (out.float() * torch.from_numpy(w)).sum().backward()
    grads = [tq.grad, tk.grad, tv.grad]
    if with_dbias:
        grads.append(tb.grad)
    elif tb is not None:
        assert tb.grad is None
    return [g.float().numpy() for g in grads]


def _assert_close(got, want, rtol, names):
    for g, w, name in zip(got, want, names):
        assert g.shape == w.shape, name
        scale = np.abs(w).max()
        np.testing.assert_allclose(g, w, atol=rtol * scale, rtol=0, err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,b,h,sq,sk,d,causal,bias_kind,segments", CASES,
                         ids=[c[0] for c in CASES])
def test_flash_backward_matches_jax(name, b, h, sq, sk, d, causal, bias_kind, segments, dtype):
    """dq, dk, dv, and the bias gradient where there is a bias."""
    q, k, v, bias, qseg, kvseg = _inputs(b, h, sq, sk, d, bias_kind, segments)
    w = _cotangent(b, h, sq, d)
    jdt, tdt, rtol = DTYPES[dtype]
    with_dbias = bias is not None
    want = _jax_grads(q, k, v, bias, causal, qseg, kvseg, w, jdt, with_dbias)
    tfa.reset_launch_counts()
    got = _port_grads(q, k, v, bias, causal, qseg, kvseg, w, tdt, with_dbias)
    _assert_close(got, want, rtol, ["dq", "dk", "dv", "dbias"])
    assert tfa.flash_attention_bwd.launches == 0  # CPU tensors: plain versions


BIAS_CASES = [c for c in CASES if c[7] is not None]


@pytest.mark.parametrize("name,b,h,sq,sk,d,causal,bias_kind,segments", BIAS_CASES,
                         ids=[c[0] for c in BIAS_CASES])
def test_flash_backward_with_a_bias_not_differentiated(name, b, h, sq, sk, d, causal,
                                                       bias_kind, segments):
    """A bias that is not differentiated: dq, dk and dv only, no bias
    gradient (#9 is not run), fp32."""
    q, k, v, bias, qseg, kvseg = _inputs(b, h, sq, sk, d, bias_kind, segments)
    w = _cotangent(b, h, sq, d)
    want = _jax_grads(q, k, v, bias, causal, qseg, kvseg, w, jnp.float32, False)
    got = _port_grads(q, k, v, bias, causal, qseg, kvseg, w, torch.float32, False)
    _assert_close(got, want, RTOL_F32, ["dq", "dk", "dv"])


def test_flash_backward_composes_bias_and_segments():
    """A per-head key bias and packed segment ids together, differentiated."""
    q, k, v, _, qseg, kvseg = _inputs(2, 2, 128, 128, 32, None, True, seed=4)
    bias = (-0.05 * np.arange(128)[None, None, None, :] * np.array([1.0, 0.5])[None, :, None,
                                                                              None])
    bias = bias.astype(np.float32)
    w = _cotangent(2, 2, 128, 32)
    want = _jax_grads(q, k, v, bias, True, qseg, kvseg, w, jnp.float32, True)
    got = _port_grads(q, k, v, bias, True, qseg, kvseg, w, torch.float32, True)
    _assert_close(got, want, RTOL_F32, ["dq", "dk", "dv", "dbias"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,sq,sk", [(True, 192, 192), (False, 128, 256),
                                          (True, 128, 320)])
def test_flash_lse_gradients_match_jax(causal, sq, sk, dtype):
    """``flash_attention_lse``: the output and the log2-space lse, and the
    gradients through both cotangents."""
    q, k, v, _, _, _ = _inputs(1, 2, sq, sk, 64, None, False, seed=11)
    r = np.random.RandomState(12)
    w_out = r.randn(1, 2, sq, 64).astype(np.float32)
    w_lse = r.randn(1, 2, sq).astype(np.float32)
    jdt, tdt, rtol = DTYPES[dtype]

    def loss(q_, k_, v_):
        out, lse = jfa.flash_attention_lse(q_, k_, v_, causal)
        return jnp.sum(out.astype(jnp.float32) * w_out) + jnp.sum(lse * w_lse)

    args = [jnp.asarray(a, jdt) for a in (q, k, v)]
    want_out, want_lse = jfa.flash_attention_lse(*args, causal)
    want = [np.asarray(g.astype(jnp.float32)) for g in jax.grad(loss, argnums=(0, 1, 2))(*args)]

    tq, tk, tv = (torch.from_numpy(a).to(tdt).requires_grad_() for a in (q, k, v))
    out, lse = tfa.flash_attention_lse(tq, tk, tv, causal)
    ((out.float() * torch.from_numpy(w_out)).sum() + (lse * torch.from_numpy(w_lse)).sum()
     ).backward()
    np.testing.assert_allclose(out.detach().float().numpy(),
                               np.asarray(want_out.astype(jnp.float32)),
                               atol=2e-5 if dtype == "float32" else 2.0 ** -7)
    np.testing.assert_allclose(lse.detach().numpy(), np.asarray(want_lse), atol=2e-5, rtol=1e-6)
    _assert_close([t.grad.float().numpy() for t in (tq, tk, tv)], want, rtol,
                  ["dq", "dk", "dv"])


def test_lse_cotangent_of_rows_that_see_no_key_is_dropped():
    """Causal with Sq > Sk: the first Sq - Sk rows see no key (lse -inf, out
    0); a cotangent on their lse must reach no gradient and give no NaN. The
    remaining rows' gradients equal those of the attention over them alone."""
    q, k, v, _, _, _ = _inputs(1, 2, 96, 64, 32, None, False, seed=13)
    r = np.random.RandomState(14)
    w_out, w_lse = r.randn(1, 2, 96, 32).astype(np.float32), r.randn(1, 2, 96).astype(np.float32)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out, lse = tfa.flash_attention_lse(tq, tk, tv, True)
    assert torch.isneginf(lse[:, :, :32]).all() and (out[:, :, :32] == 0).all()
    torch.autograd.backward([out, lse], [torch.from_numpy(w_out), torch.from_numpy(w_lse)])
    grads = [t.grad.clone() for t in (tq, tk, tv)]
    assert all(torch.isfinite(g).all() for g in grads)
    assert (grads[0][:, :, :32] == 0).all()
    sq_ = torch.from_numpy(q[:, :, 32:]).requires_grad_()
    sk_, sv_ = (torch.from_numpy(a).requires_grad_() for a in (k, v))
    out2, lse2 = tfa.flash_attention_lse(sq_, sk_, sv_, True)
    ((out2 * torch.from_numpy(w_out[:, :, 32:])).sum()
     + (lse2 * torch.from_numpy(w_lse[:, :, 32:])).sum()).backward()
    for g, g2 in zip(grads, (sq_.grad, sk_.grad, sv_.grad)):
        g = g[:, :, 32:] if g.shape[2] == 96 else g
        np.testing.assert_allclose(g.numpy(), g2.numpy(), atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_backward_matches_jax_flash_backward(dtype):
    """``flash_attention_bwd_plain`` against the JAX package's
    ``_flash_backward`` called directly, from each side's own forward:
    a per-batch bias that is differentiated, segment ids, and an lse
    cotangent, all at once."""
    b, h, s, d = 2, 2, 96, 32
    q, k, v, bias, qseg, kvseg = _inputs(b, h, s, s, d, "b1qk", True, seed=15)
    r = np.random.RandomState(16)
    do = r.randn(b, h, s, d).astype(np.float32)
    dlse = r.randn(b, h, s).astype(np.float32)
    jdt, tdt, rtol = DTYPES[dtype]
    jq, jk, jv, jdo = (jnp.asarray(a, jdt) for a in (q, k, v, do))
    jseg = jnp.asarray(qseg)
    out, lse = jfa.flash_attention_forward(jq, jk, jv, jnp.asarray(bias), causal=True,
                                           return_lse=True, q_segment_ids=jseg,
                                           kv_segment_ids=jseg)
    want = jfa._flash_backward(jq, jk, jv, out, lse, jdo, causal=True, sm_scale=None,
                               q_segment_ids=jseg, kv_segment_ids=jseg,
                               dlse=jnp.asarray(dlse), bias=jnp.asarray(bias), need_dbias=True)
    tq, tk, tv, tdo = (torch.from_numpy(a).to(tdt) for a in (q, k, v, do))
    tseg = torch.from_numpy(qseg)
    tout, tlse = tfa.flash_attention_forward(tq, tk, tv, torch.from_numpy(bias), causal=True,
                                             return_lse=True, q_segment_ids=tseg,
                                             kv_segment_ids=tseg)
    got = tfa.flash_attention_bwd_plain(tq, tk, tv, tout, tlse, tdo, torch.from_numpy(bias),
                                        causal=True, q_segment_ids=tseg, kv_segment_ids=tseg,
                                        dlse=torch.from_numpy(dlse), need_dbias=True)
    assert got[3].shape == bias.shape and got[3].dtype == torch.float32
    _assert_close([g.float().numpy() for g in got],
                  [np.asarray(w.astype(jnp.float32)) for w in want], rtol,
                  ["dq", "dk", "dv", "dbias"])

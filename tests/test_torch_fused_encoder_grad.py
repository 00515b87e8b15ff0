"""The backward of the port's fused encoder kernels
(multimodal_tpu_torch/ops/fused_encoder.py) held against the JAX package.

On the CPU the port's backward wrappers run their plain versions
(``qkv_attention_bwd_plain``, ``mlp_bwd_plain``) inside the same
``torch.autograd.Function``s the CUDA kernels sit in. The JAX side runs its
Pallas backward kernels in interpret mode (as tests/ops/test_fused_encoder.py
does) and ``jax.grad`` / ``jax.vjp`` of its XLA references. Inputs come from
a numpy seed and go to both as the same arrays.
"""

import importlib.util
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_tpu.ops import fused_encoder as jfe
from multimodal_tpu_torch.ops import fused_encoder as tfe

ROOT = Path(__file__).resolve().parents[1]

# fp32 attention: the same exact-softmax arithmetic in two frameworks, sums
# in another order; the JAX package's own kernel-vs-XLA tolerance.
ATTN_ATOL = 2e-5
# fp32 MLP: as above, over up to 256-term sums; the Pallas gelu_exact uses
# an erf polynomial 1.5e-7 off where the port uses torch.erf.
MLP_ATOL = 1e-4


def _bf16_atol(want: np.ndarray) -> float:
    """Two bf16 units in the last place of the output scale: a rounded
    intermediate (p, ds, da) or the rounded result landing on the other side
    of a tie moves a value by one unit (2**-7 relative)."""
    return 2 * 2.0 ** -7 * max(1.0, float(np.abs(want).max()))


def _key_bias(r, b, s):
    kb = np.where(r.rand(b, s) < 0.3, -1e30, 0.0).astype(np.float32)
    kb[:, 0] = 0.0  # every row keeps a visible key
    return kb


ATTN_CASES = [
    # b, s, d, h, causal, sm_scale, key_bias
    (2, 50, 192, 2, False, None, False),   # head width 96, vision-like S
    (2, 77, 128, 2, True, None, False),    # head width 64, text-like S, causal
    (3, 26, 144, 3, True, None, False),    # head width 48
    (2, 25, 128, 2, False, 0.5, False),    # sm_scale
    (2, 20, 128, 2, False, None, True),    # key-bias lane
    (2, 20, 128, 2, True, None, True),     # key-bias lane, causal
    (1, 197, 128, 2, False, None, False),  # ViT-B/16's S, past the tensor-core path's 128
]


@pytest.mark.parametrize("b,s,d,h,causal,scale,kb", ATTN_CASES)
def test_attention_bwd_plain_matches_jax(b, s, d, h, causal, scale, kb):
    r = np.random.RandomState(s + d)
    qkv = r.randn(b, s, 3 * d).astype(np.float32)
    g = r.randn(b, s, d).astype(np.float32)
    bias = _key_bias(r, b, s) if kb else None
    jbias = None if bias is None else jnp.asarray(bias)
    want_kernel = np.asarray(jfe._qkv_attention_bwd_impl(
        jnp.asarray(qkv), jnp.asarray(g), h, causal, scale, jbias))
    _, vjp = jax.vjp(lambda t: jfe._qkv_attention_xla(t, h, causal, scale, jbias),
                     jnp.asarray(qkv))
    want_xla = np.asarray(vjp(jnp.asarray(g))[0])
    got = tfe.qkv_attention_bwd_plain(
        torch.from_numpy(qkv), torch.from_numpy(g), h, causal, scale,
        None if bias is None else torch.from_numpy(bias)).numpy()
    assert got.shape == (b, s, 3 * d)
    np.testing.assert_allclose(got, want_kernel, atol=ATTN_ATOL)
    np.testing.assert_allclose(got, want_xla, atol=ATTN_ATOL)


def test_attention_bwd_plain_wholly_masked_causal_rows_match_jax():
    """A causal call whose -1e30 key bias masks every visible key of rows
    0-5 of batch row 0: their scores are all -1e30, above the diagonal too,
    so their p is 1 / S at every key (the TPU kernel adds the bias, then
    writes -1e30 above the diagonal) and their gradients reach keys above
    the diagonal. The plain version against ``_qkv_attention_bwd_impl`` in
    interpret mode, fp32, S = 16, two heads of 64. ``jax.vjp`` of the XLA
    reference agrees on dv only: it passes no gradient through the -1e30
    written above the diagonal, where the TPU kernel's ds = p (dp -
    rowsum) flows into dq and dk like any other entry's."""
    r = np.random.RandomState(16)
    b, s, d, h = 2, 16, 128, 2
    qkv = r.randn(b, s, 3 * d).astype(np.float32)
    g = r.randn(b, s, d).astype(np.float32)
    kb = np.zeros((b, s), np.float32)
    kb[0, :6] = -1e30
    kb[1, 3] = -1e30
    want_kernel = np.asarray(jfe._qkv_attention_bwd_impl(
        jnp.asarray(qkv), jnp.asarray(g), h, True, None, jnp.asarray(kb)))
    _, vjp = jax.vjp(lambda t: jfe._qkv_attention_xla(t, h, True, None, jnp.asarray(kb)),
                     jnp.asarray(qkv))
    want_xla = np.asarray(vjp(jnp.asarray(g))[0])
    tq, tk = (x.reshape(b, s, h, d // h).transpose(1, 2)
              for x in torch.from_numpy(qkv).split(d, dim=-1)[:2])
    p = tfe._attention_probs(tq, tk, (d // h) ** -0.5, True, torch.from_numpy(kb))
    torch.testing.assert_close(p[0, :, :6], torch.full((h, 6, s), 1.0 / s), rtol=0, atol=1e-7)
    got = tfe.qkv_attention_bwd_plain(torch.from_numpy(qkv), torch.from_numpy(g), h, True, None,
                                      torch.from_numpy(kb)).numpy()
    np.testing.assert_allclose(got, want_kernel, atol=ATTN_ATOL)
    np.testing.assert_allclose(got[..., 2 * d:], want_xla[..., 2 * d:], atol=ATTN_ATOL)
    np.testing.assert_allclose(got[1], want_xla[1], atol=ATTN_ATOL)  # no row masked wholly
    # the last key's dv takes rows 0-5's p = 1 / S besides row 15's own
    gh = g[0].reshape(s, h, d // h)
    p15 = p[0, :, 15, 15].numpy()
    dv_last = got[0, 15, 2 * d:].reshape(h, d // h)
    np.testing.assert_allclose(dv_last, gh[:6].sum(0) / s + p15[:, None] * gh[15], atol=ATTN_ATOL)


@pytest.mark.parametrize("causal", [False, True])
def test_attention_bwd_masked_keys_get_zero_grad(causal):
    """A key the bias masks (-1e30) is seen by no query: its dk and dv are
    exactly 0, the property the card's kernels are held to as well."""
    r = np.random.RandomState(7)
    qkv = torch.from_numpy(r.randn(2, 197, 3 * 128).astype(np.float32))
    g = torch.from_numpy(r.randn(2, 197, 128).astype(np.float32))
    bias = torch.from_numpy(_key_bias(r, 2, 197))
    dkv = tfe.qkv_attention_bwd_plain(qkv, g, 2, causal, None, bias)[..., 128:]
    masked = bias < -1e29
    assert masked.any()
    assert (dkv[masked] == 0).all()
    assert (dkv[~masked] != 0).any()


@pytest.mark.parametrize("causal", [False, True])
def test_attention_function_grad_matches_plain_autograd(causal):
    """The Function's backward (plain backward on the CPU) against autograd
    through the plain forward: the plumbing hands the right gradient to
    ``qkv`` and none to the key bias."""
    r = np.random.RandomState(5)
    qkv = torch.from_numpy(r.randn(2, 19, 3 * 96).astype(np.float32)).requires_grad_()
    bias = torch.from_numpy(_key_bias(r, 2, 19)).requires_grad_()
    g = torch.from_numpy(r.randn(2, 19, 96).astype(np.float32))
    out = tfe.fused_qkv_attention(qkv, 4, causal, None, bias)
    got, got_bias = torch.autograd.grad(out, (qkv, bias), g, allow_unused=True)
    ref = tfe.qkv_attention_plain(qkv, 4, causal, None, bias.detach())
    (want,) = torch.autograd.grad(ref, qkv, g)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATTN_ATOL)
    assert got_bias is None


def _bf16_bwd_against_jax(b, s, d, h, causal, kb, seed):
    """The plain backward in bf16 against ``_qkv_attention_bwd_impl`` (the
    Pallas kernel in interpret mode) on the same bf16 inputs."""
    r = np.random.RandomState(seed)
    qkv = r.randn(b, s, 3 * d).astype(np.float32)
    g = r.randn(b, s, d).astype(np.float32)
    bias = _key_bias(r, b, s) if kb else None
    want = np.asarray(jfe._qkv_attention_bwd_impl(
        jnp.asarray(qkv, jnp.bfloat16), jnp.asarray(g, jnp.bfloat16), h, causal, None,
        None if bias is None else jnp.asarray(bias))).astype(np.float32)
    got = tfe.qkv_attention_bwd_plain(
        torch.from_numpy(qkv).bfloat16(), torch.from_numpy(g).bfloat16(), h, causal, None,
        None if bias is None else torch.from_numpy(bias))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=_bf16_atol(want))


def test_attention_bwd_bf16_matches_jax():
    _bf16_bwd_against_jax(2, 50, 128, 2, True, False, seed=6)


@pytest.mark.parametrize("s,causal,kb", [(129, True, True), (197, True, True),
                                         (197, False, False), (256, True, True)])
def test_attention_bwd_bf16_past_128_matches_jax(s, causal, kb):
    """The shapes of the `wgmma` route (S past 128, bf16, head width 64):
    one past the `mma.sync` route's 128, ViT-B/16's 197 and the largest,
    256, causal and with a key bias."""
    _bf16_bwd_against_jax(1, s, 128, 2, causal, kb, seed=s)


@pytest.fixture
def _force_fused(monkeypatch):
    monkeypatch.setenv("MMTPU_FORCE_FUSED_ENCODER", "1")


def _mlp_inputs(seed, rows=76, din=128, dff=256, dout=128):
    r = np.random.RandomState(seed)
    x = r.randn(rows, din).astype(np.float32)
    g = (r.randn(rows, dout) * 0.5).astype(np.float32)
    w1 = (r.randn(din, dff) * din ** -0.5).astype(np.float32)
    b1 = (r.randn(dff) * 0.1).astype(np.float32)
    w2 = (r.randn(dff, dout) * dff ** -0.5).astype(np.float32)
    b2 = (r.randn(dout) * 0.1).astype(np.float32)
    return x, g, w1, b1, w2, b2


ACTS = ["quick_gelu", "gelu", "gelu_exact", "relu", "silu"]


@pytest.mark.parametrize("act", ACTS)
def test_mlp_bwd_plain_matches_jax_kernel(act, _force_fused):
    x, g, w1, b1, w2, _ = _mlp_inputs(7)
    want = jfe._mlp_bwd_pallas(*map(jnp.asarray, (x, g, w1, b1, w2)), act)
    got = tfe.mlp_bwd_plain(*map(torch.from_numpy, (x, g, w1, b1, w2)), act)
    for name, gv, wv in zip(("dx", "da", "h"), got, want):
        np.testing.assert_allclose(gv.numpy(), np.asarray(wv), atol=MLP_ATOL, err_msg=name)


def _port_mlp_grads(x, g, w1, b1, w2, b2, act):
    ts = [torch.from_numpy(a).requires_grad_() for a in (x, w1, b1, w2, b2)]
    out = tfe.fused_mlp(*ts, act)
    return [t.numpy() for t in torch.autograd.grad(out, ts, torch.from_numpy(g))]


@pytest.mark.parametrize("act", ACTS)
def test_mlp_function_grads_match_jax(act, _force_fused, monkeypatch):
    """(dx, dW1, db1, dW2, db2) of the port's Function against jax.grad of
    the XLA reference (the JAX default VJP) and of ``fused_mlp`` with the
    opt-in Pallas tiers on (``_mlp_bwd`` tries the dW-accumulating tier
    first, so this holds the port's staged arithmetic against it)."""
    x, g, w1, b1, w2, b2 = _mlp_inputs(8)
    got = _port_mlp_grads(x, g, w1, b1, w2, b2, act)
    args = tuple(map(jnp.asarray, (x, w1, b1, w2, b2)))
    _, vjp = jax.vjp(lambda *a: jfe._mlp_xla(*a, act), *args)
    want_xla = vjp(jnp.asarray(g))
    monkeypatch.setenv("MMTPU_FUSED_MLP_BWD", "1")
    _, vjp = jax.vjp(lambda *a: jfe.fused_mlp(*a, act), *args)
    want_fused = vjp(jnp.asarray(g))
    for name, gv, wx, wf in zip(("dx", "dW1", "db1", "dW2", "db2"), got, want_xla, want_fused):
        assert gv.shape == wx.shape, name
        np.testing.assert_allclose(gv, np.asarray(wx), atol=MLP_ATOL, err_msg=name)
        np.testing.assert_allclose(gv, np.asarray(wf), atol=MLP_ATOL, err_msg=name)


def test_mlp_bwd_bf16_matches_jax_kernel(_force_fused):
    x, g, w1, b1, w2, _ = _mlp_inputs(9)
    want = jfe._mlp_bwd_pallas(*(jnp.asarray(a, jnp.bfloat16) for a in (x, g, w1, b1, w2)),
                               "quick_gelu")
    got = tfe.mlp_bwd_plain(*(torch.from_numpy(a).bfloat16() for a in (x, g, w1, b1, w2)),
                            "quick_gelu")
    for name, gv, wv in zip(("dx", "da", "h"), got, want):
        assert gv.dtype == torch.bfloat16, name
        wv = np.asarray(wv).astype(np.float32)
        np.testing.assert_allclose(gv.float().numpy(), wv, atol=_bf16_atol(wv), err_msg=name)


@pytest.mark.parametrize("act", ["quick_gelu", "gelu_exact"])
def test_mlp_function_grad_matches_plain_autograd(act):
    """The Function's backward against autograd through the plain forward,
    with the weights passed as the column-major views an nn.Linear gives:
    each gradient comes back in its input's shape."""
    x, g, w1, b1, w2, b2 = _mlp_inputs(10)
    lin1 = torch.from_numpy(np.ascontiguousarray(w1.T)).requires_grad_()
    lin2 = torch.from_numpy(np.ascontiguousarray(w2.T)).requires_grad_()
    xs, b1s, b2s = (torch.from_numpy(a).requires_grad_() for a in (x, b1, b2))
    leaves = (xs, lin1, b1s, lin2, b2s)
    got = torch.autograd.grad(tfe.fused_mlp(xs, lin1.t(), b1s, lin2.t(), b2s, act),
                              leaves, torch.from_numpy(g))
    want = torch.autograd.grad(tfe.mlp_plain(xs, lin1.t(), b1s, lin2.t(), b2s, act),
                               leaves, torch.from_numpy(g))
    for leaf, gv, wv in zip(leaves, got, want):
        assert gv.shape == leaf.shape
        np.testing.assert_allclose(gv.numpy(), wv.numpy(), atol=MLP_ATOL)


@pytest.mark.parametrize(
    "seq,width,heads,dtype,ok",
    [(50, 768, 12, torch.bfloat16, True), (77, 512, 8, torch.bfloat16, True),
     (128, 768, 12, torch.bfloat16, True), (197, 768, 12, torch.bfloat16, True),
     (77, 512, 8, torch.float32, True), (50, 384, 4, torch.float32, True),
     (77, 512, 4, torch.float32, True), (128, 768, 12, torch.float32, True),
     (257, 1024, 16, torch.bfloat16, False)],
)
def test_attention_bwd_shape_predicate(seq, width, heads, dtype, ok):
    """The backward admits CLIP's S=50 / 77 in bf16 and fp32, ViT-B/16's
    S=197, and every other shape the forward takes, up to S=256."""
    assert tfe.fused_attention_bwd_supported(seq, width, heads, dtype) is ok


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("head_dim", [8, 48, 64, 96, 100, 128, 136])
def test_attention_bwd_domain_is_forward_domain(head_dim, dtype):
    """The backward takes exactly the forward's shapes: at every S up to
    past 256 and 1, 2 or 3 heads of this width (and a width that does not
    split into heads), in either dtype."""
    for heads in (1, 2, 3):
        for width in (head_dim * heads, head_dim * heads + 1):
            for seq in range(1, 262):
                assert (tfe.fused_attention_bwd_supported(seq, width, heads, dtype)
                        == tfe.fused_attention_supported(seq, width, heads)), (seq, width, heads)


@pytest.mark.parametrize("seq,head_dim,dtype,route", [
    (1, 64, torch.bfloat16, tfe._BWD_MMA), (50, 64, torch.bfloat16, tfe._BWD_MMA),
    (77, 64, torch.bfloat16, tfe._BWD_MMA),
    (tfe._BWD_WGMMA_MIN_SEQ - 1, 64, torch.bfloat16, tfe._BWD_MMA),
    (tfe._BWD_WGMMA_MIN_SEQ, 64, torch.bfloat16, tfe._BWD_WGMMA),
    (197, 64, torch.bfloat16, tfe._BWD_WGMMA), (256, 64, torch.bfloat16, tfe._BWD_WGMMA),
    (50, 64, torch.float32, tfe._BWD_FP32_PIPES), (197, 64, torch.float32, tfe._BWD_FP32_PIPES),
    (197, 128, torch.bfloat16, tfe._BWD_FP32_PIPES), (50, 96, torch.bfloat16, tfe._BWD_FP32_PIPES),
    (181, 128, torch.bfloat16, tfe._BWD_FP32_PIPES), (77, 32, torch.bfloat16, tfe._BWD_FP32_PIPES),
])
def test_attention_bwd_route(seq, head_dim, dtype, route):
    """bf16 at head width 64 takes the tensor cores (`mma.sync` below
    ``_BWD_WGMMA_MIN_SEQ``, `wgmma` from it); fp32 and every other width the
    FP32 pipes."""
    assert tfe._attention_bwd_route(seq, head_dim, dtype) == route


def test_attention_bwd_routes_take_their_shapes():
    """Every S of the backward's domain goes to a kernel the C entry takes:
    the `mma.sync` kernel only up to S = 128, the `wgmma` kernel up to 256."""
    assert 1 < tfe._BWD_WGMMA_MIN_SEQ <= 129
    for seq in range(1, 257):
        route = tfe._attention_bwd_route(seq, 64, torch.bfloat16)
        assert route == (tfe._BWD_MMA if seq <= 128 and seq < tfe._BWD_WGMMA_MIN_SEQ
                         else tfe._BWD_WGMMA), seq


def test_attention_bwd_argtypes_match_the_entry_point():
    """The wrapper's ctypes signature has one argument per parameter of
    ``mm_qkv_attention_bwd``: pointers as pointers, the scale as a float,
    sizes, flags, the dtype code and the route as ints."""
    src = (ROOT / "multimodal_tpu_torch" / "csrc" / "fused_qkv_attention_bwd.cu").read_text()
    params = re.search(r"int mm_qkv_attention_bwd\(([^)]*)\)", src).group(1).split(",")
    py = Path(tfe.__file__).read_text()
    argtypes = re.search(r"lib\.mm_qkv_attention_bwd\.argtypes = \[([^\]]*)\]",
                         py).group(1).split(",")
    assert len(params) == len(argtypes) == 13
    assert params[-2].split() == ["int", "route"]
    for param, arg in zip(params, argtypes):
        param, arg = param.strip(), arg.strip()
        if "*" in param:
            assert arg == "_V", param
        elif param.startswith("float"):
            assert arg == "ctypes.c_float", param
        else:
            assert arg == "_I", param


def test_attention_bwd_kernels_are_filed_under_the_backward():
    """A profile files the backward's kernels, the `wgmma` one among them,
    under #2, and the forward's under #1."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    names = re.findall(r"__global__ void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\(",
                       (ROOT / "multimodal_tpu_torch" / "csrc" /
                        "fused_qkv_attention_bwd.cu").read_text())
    assert "qkv_attention_bwd_wgmma_kernel" in names
    assert "qkv_attention_bwd_mma_long_kernel" not in names
    for name in names:
        assert cs.kernel_group(f"void (anonymous namespace)::{name}<256>(...)") == \
            "fused_qkv_attention_bwd"

"""The port's flash attention backward call, ``flash_attention_bwd``
(multimodal_tpu_torch/ops/flash_attention.py: the TPU's kernels #7 dq and #8
dk/dv as one call): its CPU route against the JAX package's
``_flash_backward`` (Pallas in interpret mode), the checks that refuse what
its kernels cannot take, its workspace, the ctypes signatures of its C entry
points (csrc/flash_attention_bwd.cu), and how ``chip_smoke`` files its
kernels in a profile.

On the CPU the wrapper runs the plain version. Inputs come from a numpy
seed and go to both sides as the same arrays; each side runs its own
forward for ``out`` and ``lse``.
"""

import importlib.util
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_tpu.ops import flash_attention as jfa
from multimodal_tpu_torch.ops import flash_attention as tfa
from multimodal_tpu_torch.tools import kernel_variants

from tests.test_torch_flash_attention import CASES, _inputs

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "multimodal_tpu_torch" / "csrc"

# Relative to the largest gradient of each tensor, as in
# tests/test_torch_flash_attention_grad.py: fp32, the same arithmetic summed
# in another order; bf16, ds and p rounded to bf16 before their products on
# both sides, one rounding on the other side of a tie a bf16 ulp (2^-8).
RTOL = {"float32": 1e-5, "bfloat16": 2.0 ** -7}
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,b,h,sq,sk,d,causal,bias_kind,segments", CASES,
                         ids=[c[0] for c in CASES])
def test_cpu_route_matches_jax_flash_backward(name, b, h, sq, sk, d, causal, bias_kind,
                                              segments, dtype):
    """dq, dk and dv of ``flash_attention_bwd`` on CPU tensors against the
    JAX package's ``_flash_backward`` on the same inputs; no launch."""
    q, k, v, bias, qseg, kvseg = _inputs(b, h, sq, sk, d, bias_kind, segments, seed=21)
    do = np.random.RandomState(22).randn(b, h, sq, d).astype(np.float32)
    jdt, tdt = DTYPES[dtype]
    c = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    jq, jk, jv, jdo = (jnp.asarray(a, jdt) for a in (q, k, v, do))
    out, lse = jfa.flash_attention_forward(jq, jk, jv, c(bias), causal=causal, return_lse=True,
                                           q_segment_ids=c(qseg), kv_segment_ids=c(kvseg))
    want = jfa._flash_backward(jq, jk, jv, out, lse, jdo, causal=causal, sm_scale=None,
                               q_segment_ids=c(qseg), kv_segment_ids=c(kvseg), bias=c(bias))

    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    tq, tk, tv, tdo = (torch.from_numpy(a).to(tdt) for a in (q, k, v, do))
    kw = dict(causal=causal, q_segment_ids=t(qseg), kv_segment_ids=t(kvseg))
    tout, tlse = tfa.flash_attention_forward(tq, tk, tv, t(bias), return_lse=True, **kw)
    tfa.reset_launch_counts()
    got = tfa.flash_attention_bwd(tq, tk, tv, tdo, tlse, tfa._delta(tout, tdo, None), t(bias),
                                  **kw)
    assert tfa.flash_attention_bwd.launches == 0
    for g, w, part, like in zip(got, want, ("dq", "dk", "dv"), (tq, tk, tv)):
        assert g.shape == like.shape and g.dtype == like.dtype, part
        w = np.asarray(w.astype(jnp.float32))
        np.testing.assert_allclose(g.float().numpy(), w, atol=RTOL[dtype] * np.abs(w).max(),
                                   rtol=0, err_msg=part)


def _args(b=2, h=3, sq=96, sk=128, d=64, dtype=torch.bfloat16):
    q = torch.zeros(b, h, sq, d, dtype=dtype)
    k = torch.zeros(b, h, sk, d, dtype=dtype)
    v = torch.zeros(b, h, sk, d, dtype=dtype)
    do = torch.zeros(b, h, sq, d, dtype=dtype)
    lse = torch.zeros(b, h, sq)
    delta = torch.zeros(b, h, sq)
    return q, k, v, do, lse, delta


def _check(q, k, v, do, lse, delta, outs=None, dq_acc=None, bias=None):
    tfa._check_bwd("flash_attention_bwd", q, k, v, do, lse, delta, bias, None, None, outs,
                   dq_acc)


def _outs(q, k, v):
    return tuple(tfa._grad_like(t) for t in (q, k, v))


def _workspace(q):
    return torch.empty(tfa._dq_workspace(q))


def test_checks_take_the_head_split_views_of_a_projection():
    """q, k and v as the head split of a (B, S, 3 H D) projection and do in
    (B, Sq, H, D) storage, as the LM passes them: accepted."""
    b, s, h, d = 2, 96, 3, 64
    qkv = torch.zeros(b, s, 3, h, d, dtype=torch.bfloat16)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    do = torch.zeros(b, s, h, d, dtype=torch.bfloat16).transpose(1, 2)
    lse, delta = torch.zeros(b, h, s), torch.zeros(b, h, s)
    _check(q, k, v, do, lse, delta, _outs(q, k, v), _workspace(q))


def _misaligned_rows(t):
    """``t``'s values in rows 8 bytes apart from 16-byte alignment: a view
    whose row stride is D + 4 elements."""
    b, h, s, d = t.shape
    return torch.zeros(b, h, s, d + 4, dtype=t.dtype)[..., :d]


ROWS = "rows must be contiguous and 16-byte aligned"
REFUSALS = {
    "q rows not 16-byte aligned": (lambda a: (_misaligned_rows(a[0]),) + a[1:], ROWS),
    "k last dim not contiguous": (
        lambda a: (a[0], a[1].transpose(2, 3).contiguous().transpose(2, 3)) + a[2:], ROWS),
    "do of another shape": (lambda a: a[:3] + (a[3][:, :, :-1],) + a[4:], "do must match q"),
    "do of another dtype": (lambda a: a[:3] + (a[3].float(),) + a[4:], "do must match q"),
    "do rows not 16-byte aligned": (lambda a: a[:3] + (_misaligned_rows(a[3]),) + a[4:],
                                    "rows of do"),
    "lse not fp32": (lambda a: a[:4] + (a[4].double(),) + a[5:], "lse and delta"),
    "delta not contiguous": (lambda a: a[:5] + (torch.zeros(3, 2, 96).transpose(0, 1),),
                             "lse and delta"),
    "head width not a multiple of 8": (
        lambda a: tuple(t[..., :60] if t.dim() == 4 else t for t in a), "head width 60"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_checks_refuse_inputs(case):
    edit, match = REFUSALS[case]
    with pytest.raises(ValueError, match=match):
        _check(*edit(_args()))


@pytest.mark.parametrize("case", ["dq of another shape", "dk of another dtype",
                                  "dv rows not 16-byte aligned"])
def test_checks_refuse_outputs(case):
    q, k, v, do, lse, delta = _args()
    dq, dk, dv = _outs(q, k, v)
    if case.startswith("dq"):
        dq = dq[:, :, :-1]
    elif case.startswith("dk"):
        dk = dk.float()
    else:
        dv = _misaligned_rows(dv)
    with pytest.raises(ValueError, match="outputs"):
        _check(q, k, v, do, lse, delta, (dq, dk, dv), _workspace(q))


@pytest.mark.parametrize("case", ["missing", "too short", "bf16", "not contiguous"])
def test_checks_refuse_a_workspace_the_route_cannot_take(case):
    q, k, v, do, lse, delta = _args()
    n = tfa._dq_workspace(q)[0]
    ws = {"missing": None, "too short": torch.empty(n - 4),
          "bf16": torch.empty(n, dtype=torch.bfloat16),
          "not contiguous": torch.empty(2 * n)[::2]}[case]
    with pytest.raises(ValueError, match="workspace"):
        _check(q, k, v, do, lse, delta, _outs(q, k, v), ws)


def test_dbias_checks_take_no_workspace():
    """#9 sums nothing across blocks: its checks ask for no workspace."""
    _check(*_args())


def test_no_kernel_off_cuda():
    q, k, v, do, lse, delta = (t.to("meta") for t in _args())
    with pytest.raises(ValueError, match="no kernel for meta"):
        tfa.flash_attention_bwd(q, k, v, do, lse, delta, causal=True)


@pytest.mark.parametrize("dtype,d", [(torch.float32, 64), (torch.bfloat16, 32),
                                     (torch.float32, 96), (torch.bfloat16, 128)])
def test_other_routes_take_no_workspace(dtype, d):
    q = torch.zeros(2, 3, 96, d, dtype=dtype)
    assert tfa._dq_workspace(q) is None
    _check(q, q, q, q, torch.zeros(2, 3, 96), torch.zeros(2, 3, 96), _outs(q, q, q), None)


@pytest.mark.parametrize("d", [64, 96])
@pytest.mark.parametrize("sq,pad", [(1, 64), (64, 64), (1000, 1024), (8192, 8192)])
def test_workspace_holds_the_sum_and_the_padded_rows(sq, pad, d):
    """bf16 at head widths 64 and 96 (the one-pass route): dq's fp32 sum
    (B, H, Sq, D), then lse and delta padded to whole 64-query tiles; the
    checks take that workspace and refuse the call without it."""
    q = torch.zeros(2, 3, sq, d, dtype=torch.bfloat16)
    assert tfa._dq_workspace(q) == (2 * 3 * (d * sq + 2 * pad),)
    if sq == 64:
        lse = torch.zeros(2, 3, sq)
        _check(q, q, q, q, lse, lse, _outs(q, q, q), torch.zeros(tfa._dq_workspace(q)))
        with pytest.raises(ValueError, match="workspace"):
            _check(q, q, q, q, lse, lse, _outs(q, q, q), None)


def test_workspace_at_the_lm_train_shape():
    """(8, 12, 8192, 64): 201 MB of dq's sum and 0.8 MB of rows, freed when
    the call returns."""
    q = torch.zeros(1, dtype=torch.bfloat16).expand(8, 12, 8192, 64)
    assert tfa._dq_workspace(q)[0] * 4 == 207_618_048


def _params(src, entry):
    text = (CSRC / src).read_text()
    return re.search(rf"int {entry}\(([^)]*)\)", text).group(1).split(",")


@pytest.mark.parametrize("entry,n", [("mm_flash_attention_bwd", 27),
                                     ("mm_flash_attention_bwd_dbias", 24),
                                     ("mm_flash_attention_bwd_route", 2)])
def test_argtypes_match_the_entry_points(entry, n):
    """The wrapper's ctypes signature has one argument per parameter of the
    C entry point, pointers and strides as pointers, sizes as ints."""
    py = Path(tfa.__file__).read_text()
    argtypes = re.search(rf"lib\.{entry}\.argtypes = \[([^\]]*)\]", py).group(1).split(",")
    params = _params("flash_attention_bwd.cu", entry)
    assert len(params) == len(argtypes) == n
    for param, arg in zip(params, argtypes):
        param, arg = param.strip(), arg.strip()
        if "*" in param:
            assert arg == "_V", param
        elif param.startswith("long long"):
            assert arg == "_L", param
        elif param.startswith("float"):
            assert arg == "ctypes.c_float", param
        else:
            assert param.startswith("int") and arg == "_I", param


def test_no_mma_sync_instance_at_head_width_64():
    """bf16 at head widths 64 and 96 takes the one-pass kernel for dq, dk
    and dv, launched at both: the `mma.sync` dq and dk/dv bodies are
    instantiated only at 32 and 128, and the entry takes the one-pass route
    at 64 and 96. #9 in bf16 takes its `wgmma` kernel at 32, 64 and 96 and
    the `mma.sync` dq body only at 128."""
    text = (CSRC / "flash_attention_bwd.cu").read_text()
    assert set(re.findall(r"launch_mma_dq<(\d+), false>\(", text)) == {"32", "128"}
    assert set(re.findall(r"launch_mma_dkv<(\d+)>\(", text)) == {"32", "128"}
    assert set(re.findall(r"launch_mma_dq<(\d+), true>\(", text)) == {"128"}
    assert set(re.findall(r"launch_wgmma<(\d+)>\(", text)) == {"64", "96"}
    assert "if (dtype == 1 && (D == 64 || D == 96)) return 2;" in text
    entry = text[text.index("int mm_flash_attention_bwd_dbias("):]
    assert set(re.findall(r"dispatch_dbias<(\d+)>\(a, st\)", entry)) == {"32", "64", "96"}
    assert "if (dtype == 0) return (int)dispatch_fp32<float>(2, a, D, st);" in entry


@pytest.mark.parametrize("variant", sorted(kernel_variants.VARIANTS))
def test_kernel_variants_apply_to_the_source(variant):
    """Each default variant of tools/kernel_variants.py edits text that the
    one-pass kernel's source holds, so the tool still measures what
    PERF.md reports."""
    text = (CSRC / kernel_variants.SOURCE).read_text()
    for old, _ in kernel_variants.VARIANTS[variant]:
        assert old in text


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name,group", [
    ("flash_bwd_wgmma_kernel<64>((anonymous namespace)::WgParams)", "flash_attention_bwd"),
    ("flash_bwd_wgmma_kernel<96>((anonymous namespace)::WgParams)", "flash_attention_bwd"),
    ("flash_bwd_wgmma_rows_kernel((anonymous namespace)::Args, float*)", "flash_attention_bwd"),
    ("flash_bwd_wgmma_dq_kernel<96>(float4 const*)", "flash_attention_bwd"),
    ("flash_bwd_dq_mma_kernel<128, false>((anonymous namespace)::Args)", "flash_attention_bwd"),
    ("flash_bwd_dkv_mma_kernel<32, 64, 32>((anonymous namespace)::Args)", "flash_attention_bwd"),
    ("flash_bwd_dkv_fp32_kernel<float, 2>((anonymous namespace)::Args, int)",
     "flash_attention_bwd"),
    ("flash_bwd_dq_mma_kernel<64, true>((anonymous namespace)::Args)",
     "flash_attention_bwd_dbias"),
    ("flash_bwd_dbias_kernel<64, true>((anonymous namespace)::DbParams)",
     "flash_attention_bwd_dbias"),
    ("flash_bwd_dbias_kernel<96, false>((anonymous namespace)::DbParams)",
     "flash_attention_bwd_dbias"),
    ("flash_bwd_dq_fp32_kernel<float, 2, true>((anonymous namespace)::Args, int)",
     "flash_attention_bwd_dbias"),
])
def test_profile_groups_of_the_backward(name, group):
    """The LM train step's device time files every kernel of the call under
    ``flash_attention_bwd`` and #9's under its own group."""
    assert _chip_smoke().kernel_group(f"void (anonymous namespace)::{name}") == group


@pytest.mark.parametrize("sk,pitch", [(301, 304), (300, 300), (1, 4), (8192, 8192)])
def test_dbias_out_rows_start_16_bytes_apart(sk, pitch):
    """#9's output: the ``[..., :Sk]`` view of a (B, H, Sq, Sk_pad) fp32
    buffer, Sk_pad a multiple of 4 (TMA's 16-byte stride rule), heads and
    batches packed, as ``_flash_bwd_dbias_launch`` requires."""
    q = torch.zeros(2, 3, 5, 64, dtype=torch.bfloat16)
    ds = tfa._dbias_out(q, sk)
    assert ds.shape == (2, 3, 5, sk) and ds.dtype == torch.float32
    assert ds.stride() == (3 * 5 * pitch, 5 * pitch, pitch, 1)


def test_dbias_launch_refuses_what_the_kernel_cannot_write():
    q, k, v, do, lse, delta = _args(sq=96, sk=130)
    kw = dict(causal=True, sm_scale=None)
    with pytest.raises(ValueError, match="ds must be"):  # rows 130 floats apart
        tfa._flash_bwd_dbias_launch(q, k, v, do, lse, delta, None,
                                    torch.zeros(2, 3, 96, 130), **kw)
    with pytest.raises(ValueError, match="ds must be"):  # not fp32
        tfa._flash_bwd_dbias_launch(q, k, v, do, lse, delta, None,
                                    tfa._dbias_out(q, 130, torch.float64), **kw)


@pytest.mark.parametrize("bias_shape", ["full", "1h1k"])
def test_dbias_padded_view_and_zeros_match_jax(bias_shape):
    """#9's CPU route at a ragged Sk = 301, causal with Sq = 40 (rows see
    keys up to i + 261): ``flash_attention_bwd_dbias`` returns the padded
    view (pitch 304), exactly 0 above the diagonal, and through
    ``_reduce_dbias`` it matches the JAX package's ``_flash_backward(...,
    need_dbias=True)`` (Pallas in interpret mode) for a full (B, H, Sq, Sk)
    bias and an ALiBi-style (1, H, 1, Sk) one, fp32, to 1e-5 of the largest
    gradient."""
    b, h, sq, sk, d = 1, 2, 40, 301, 32
    r = np.random.RandomState(301)
    q, k, v = (r.randn(b, h, n, d).astype(np.float32) for n in (sq, sk, sk))
    do = r.randn(b, h, sq, d).astype(np.float32)
    bias = (r.randn(b, h, sq, sk) if bias_shape == "full"
            else -0.05 * r.rand(1, h, 1, 1) * np.arange(sk)[None, None, None, :])
    bias = bias.astype(np.float32)
    jq, jk, jv, jdo, jb = (jnp.asarray(a) for a in (q, k, v, do, bias))
    out, lse = jfa.flash_attention_forward(jq, jk, jv, jb, causal=True, return_lse=True)
    want = jfa._flash_backward(jq, jk, jv, out, lse, jdo, causal=True, sm_scale=None, bias=jb,
                               need_dbias=True)[3]
    tq, tk, tv, tdo, tb = (torch.from_numpy(a) for a in (q, k, v, do, bias))
    tout, tlse = tfa.flash_attention_forward(tq, tk, tv, tb, causal=True, return_lse=True)
    ds = tfa.flash_attention_bwd_dbias(tq, tk, tv, tdo, tlse, tfa._delta(tout, tdo, None), tb,
                                       causal=True)
    assert ds.shape == (b, h, sq, sk) and ds.stride(2) == 304
    above = torch.ones(sq, sk, dtype=torch.bool).triu(sk - sq + 1)
    assert bool((ds[..., above] == 0).all()) and bool((ds[..., ~above] != 0).any())
    got = tfa._reduce_dbias(ds, tb).numpy()
    want = np.asarray(want)
    assert got.shape == want.shape == bias.shape
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max(), rtol=0)

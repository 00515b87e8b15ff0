"""Kernel #6, the flash attention forward (multimodal_tpu_torch/ops/flash_attention.py),
at the edges of the Hopper kernel's 128-query and 128-key tiles.

On the CPU the port's wrapper runs its plain version; the JAX package's
``flash_attention_forward`` runs its Pallas kernel in interpret mode (as
tests/ops/test_flash_attention.py does). Inputs come from a numpy seed and go
to both as the same arrays; the lse is compared in log2 space, the JAX
kernel's ``lse[..., :Sq, 0]``. Also here: the launch helper's refusals, the
C entry points' ctypes signatures, the route that each bf16 head width
takes in the source, head width 32 with key padding over whole key tiles,
and the names under which ``chip_smoke.py`` files the kernel's device
time.
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

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "multimodal_tpu_torch" / "csrc"
# The tolerances of tests/test_torch_flash_attention.py. fp32: the same
# log2-space arithmetic in two frameworks, sums in another order and exp2
# from two libraries over up to 1000 keys. bf16: both round the
# probabilities and the output to bf16 at the same points; an exp2 an ulp
# apart can move a rounding across a tie: two bf16 ulps of the output.
ATOL_F32 = 2e-5
ATOL_BF16 = 2.0 ** -7
LSE_ATOL = 2e-5  # log2-space lse of fp32 scores (|lse| < 16)

# (name, sq, sk, causal, segments): one row short of a 128-query tile, a
# whole one, one row into the next, a tile and a half, and a ragged 1000;
# causal with Sq != Sk (bottom-right aligned: every row sees a key).
EDGE_CASES = [
    ("sq127_causal", 127, 127, True, False),
    ("sq128_causal", 128, 128, True, False),
    ("sq129_causal", 129, 129, True, False),
    ("sq191_non_causal", 191, 191, False, False),
    ("sq1000_causal", 1000, 1000, True, False),
    ("sq127_sk1000_causal", 127, 1000, True, False),
    ("sq129_sk191_causal", 129, 191, True, False),
    ("sq191_sk129_non_causal", 191, 129, False, False),
    ("sq129_segment_ids", 129, 129, True, True),
    ("sq191_segment_ids_non_causal", 191, 191, False, True),
]


def _inputs(sq, sk, segments, seed, b=1, h=2, d=64):
    r = np.random.RandomState(seed)
    q = r.randn(b, h, sq, d).astype(np.float32)
    k = r.randn(b, h, sk, d).astype(np.float32)
    v = r.randn(b, h, sk, d).astype(np.float32)
    qseg = kvseg = None
    if segments:  # packed documents: every query sees at least its own key
        cuts = np.sort(r.choice(np.arange(1, sq), size=(b, 3), replace=False), axis=1)
        qseg = np.stack([np.searchsorted(c, np.arange(sq), side="right") for c in cuts])
        qseg = qseg.astype(np.int32)
        kvseg = qseg.copy()
    return q, k, v, qseg, kvseg


def _jax(q, k, v, causal, qseg, kvseg, dtype):
    c = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    out, lse = jfa.flash_attention_forward(
        jnp.asarray(q, dtype), jnp.asarray(k, dtype), jnp.asarray(v, dtype), None,
        causal=causal, return_lse=True, q_segment_ids=c(qseg), kv_segment_ids=c(kvseg))
    return np.asarray(out.astype(jnp.float32)), np.asarray(lse)[:, :, : q.shape[2], 0]


def _port(q, k, v, causal, qseg, kvseg, dtype):
    c = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    out, lse = tfa.flash_attention_forward(
        torch.from_numpy(q).to(dtype), torch.from_numpy(k).to(dtype),
        torch.from_numpy(v).to(dtype), causal=causal, return_lse=True,
        q_segment_ids=c(qseg), kv_segment_ids=c(kvseg))
    return out.float().numpy(), lse.numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,sq,sk,causal,segments", EDGE_CASES, ids=[c[0] for c in EDGE_CASES])
def test_flash_forward_at_tile_edges_matches_jax(name, sq, sk, causal, segments, dtype):
    q, k, v, qseg, kvseg = _inputs(sq, sk, segments, seed=sq + 7 * sk)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16,
                                                                        torch.bfloat16)
    want, want_lse = _jax(q, k, v, causal, qseg, kvseg, jdt)
    got, got_lse = _port(q, k, v, causal, qseg, kvseg, tdt)
    assert got.shape == (1, 2, sq, 64) and got_lse.shape == (1, 2, sq)
    np.testing.assert_allclose(got, want, atol=ATOL_F32 if dtype == "float32" else ATOL_BF16)
    np.testing.assert_allclose(got_lse, want_lse, atol=LSE_ATOL, rtol=1e-6)


def test_launch_refuses_outputs_it_cannot_write():
    """``_flash_fwd_launch`` (the kernel's launch, which checks also use to
    relaunch into NaN-filled outputs) refuses an output of another shape or
    with unaligned rows, and an lse that is not contiguous fp32, before it
    reaches the library."""
    q = torch.zeros(1, 2, 129, 64, dtype=torch.bfloat16)
    kw = dict(causal=True, sm_scale=None)
    with pytest.raises(ValueError, match="out must match q"):
        tfa._flash_fwd_launch(q, q, q, None, torch.zeros(1, 2, 128, 64, dtype=torch.bfloat16),
                              None, **kw)
    with pytest.raises(ValueError, match="out must match q"):
        tfa._flash_fwd_launch(q, q, q, None, torch.zeros(1, 2, 129, 68, dtype=torch.bfloat16)
                              [..., :64], None, **kw)
    with pytest.raises(ValueError, match="lse be contiguous fp32"):
        tfa._flash_fwd_launch(q, q, q, None, tfa._grad_like(q),
                              torch.zeros(1, 2, 129, dtype=torch.bfloat16), **kw)


def test_argtypes_match_the_entry_point():
    """The wrapper's ctypes signature has one argument per parameter of
    ``mm_flash_attention_fwd``: pointers and stride arrays as pointers, the
    segment ids' batch strides as long long, the scale as float."""
    params = re.search(r"int mm_flash_attention_fwd\(([^)]*)\)",
                       (CSRC / "flash_attention_fwd.cu").read_text()).group(1).split(",")
    py = Path(tfa.__file__).read_text()
    argtypes = re.search(r"lib\.mm_flash_attention_fwd\.argtypes = \[([^\]]*)\]",
                         py).group(1).split(",")
    assert len(params) == len(argtypes) == 24
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


def test_bf16_head_widths_64_and_96_take_the_wgmma_kernel_with_or_without_bias():
    """The route is decided by dtype and head width, never after a failure:
    bf16 at 32, 64 and 96 launches the `wgmma` kernel, with or without a
    bias (its BIAS lane), in blocks of one warpgroup up to ``kShortQueries``
    queries and of two past them; 128 keeps the `mma.sync` kernel (its only
    instance), fp32 and other widths the FP32 pipes."""
    text = (CSRC / "flash_attention_fwd.cu").read_text()
    entry = text[text.index("int mm_flash_attention_fwd("):]
    assert "if (dtype == 0) return (int)dispatch_fp32<float>(a, D, st);" in entry
    assert "if (D == 64) return (int)dispatch_wgmma<64>(a, st);" in entry
    assert "if (D == 96) return (int)dispatch_wgmma<96>(a, st);" in entry
    assert "if (D == 32) return (int)dispatch_wgmma<32>(a, st);" in entry
    assert set(re.findall(r"launch_mma<(\d+)>\(a, st\)", entry)) == {"128"}
    assert set(re.findall(r"launch_mma<(\d+)>", text)) == {"128"}
    assert entry.index("dispatch_wgmma<96>") < entry.index("dispatch_fp32<__nv_bfloat16>")
    assert ("return a.bias ? dispatch_blocks<D, true>(a, stream) : "
            "dispatch_blocks<D, false>(a, stream);") in text
    assert re.search(r"a\.Sq <= kShortQueries \? launch_wgmma<D, BIAS, 1>\(a, stream\)\s*"
                     r": launch_wgmma<D, BIAS, 2>\(a, stream\)", text)
    assert re.search(r"if constexpr \(D == 32\)\s*return launch_wgmma<D, BIAS, 1>\(a, stream\);",
                     text)
    assert "constexpr int kShortQueries = 64;" in text


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("key", [
    "(anonymous namespace)::flash_fwd_wgmma_kernel((anonymous namespace)::WgParams)",
    "void (anonymous namespace)::flash_fwd_wgmma_kernel<96, true, 1>((anonymous "
    "namespace)::WgParams)",
    "void (anonymous namespace)::flash_fwd_mma_kernel<64>((anonymous namespace)::Args)",
    "void (anonymous namespace)::flash_fwd_fp32_kernel<float, 2>((anonymous namespace)::Args, "
    "int)",
])
def test_profile_groups_file_the_forward_under_flash_attention(key):
    assert _chip_smoke().kernel_group(key) == "flash_attention"


def test_chip_smoke_cases_cover_the_tile_edges_and_the_train_shape():
    """``chip_smoke.py`` checks #6 at the LM train shape (with and without
    segment ids, with lse) and at Sq 127, 129 and 191 on the card."""
    cases = {c[0]: c for c in _chip_smoke().FLASH_CASES}
    assert cases["train"][1:5] == (8, 12, 8192, 8192) and cases["train"][7]["lse"]
    assert cases["train_segment_ids"][7] == {"lse": True, "segments": True}
    assert {c[3] for c in cases.values()} >= {127, 129, 191}


# The `wgmma` kernel's bias lane and head width 96: the
# port's plain version against the JAX package's Pallas forward in interpret
# mode. (name, b, h, sq, sk, d, bias kind, lse). "masked_row": a (B, 1, Sq,
# Sk) key-padding bias with query row 40 masked wholly (-1e30 at every key:
# every score is -1e30, the softmax is uniform, the row is the mean of V);
# "broadcast": a (1, 1, Sq, Sk) bias (a causal bool mask as -1e30 plus a
# ramp), read at its broadcast shape; D = 96 without a bias, with lse. Sk
# fits one JAX key block, so the JAX kernel pads no key for the wholly
# masked row to average over.
BIAS_LANE_CASES = [
    ("masked_row", 2, 2, 77, 100, 64, "masked_row", True),
    ("broadcast_1_1_sq_sk", 2, 3, 76, 76, 64, "broadcast", False),
    ("head_width_96_lse", 2, 2, 77, 200, 96, None, True),
]


def _bias(kind, b, sq, sk, r):
    if kind == "masked_row":
        keys = np.arange(sk)[None, :] < r.randint(sk // 2, sk + 1, size=(b, 1))
        bias = np.where(keys, 0.0, -1e30)[:, None, None, :].repeat(sq, axis=2)
        bias[:, :, 40] = -1e30
        return bias.astype(np.float32)
    if kind == "broadcast":
        causal = np.tril(np.ones((sq, sk), dtype=bool))
        return (np.where(causal, 0.0, -1e30) - 0.01 * np.arange(sk)[None, :])[None, None].astype(
            np.float32)
    return None


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,b,h,sq,sk,d,kind,lse", BIAS_LANE_CASES,
                         ids=[c[0] for c in BIAS_LANE_CASES])
def test_bias_lane_and_head_width_96_match_jax(name, b, h, sq, sk, d, kind, lse, dtype):
    """The plain version's semantics of the `wgmma` kernel's new lanes
    against the JAX forward (interpret mode), with the tolerances above; a
    row the bias masks wholly averages V (its lse finite, about -1.44e30
    in log2 units) and does not come back 0."""
    r = np.random.RandomState(sq + sk + d)
    q = r.randn(b, h, sq, d).astype(np.float32)
    k = r.randn(b, h, sk, d).astype(np.float32)
    v = r.randn(b, h, sk, d).astype(np.float32)
    bias = _bias(kind, b, sq, sk, r)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16,
                                                                        torch.bfloat16)
    want, want_lse = jfa.flash_attention_forward(
        jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt),
        None if bias is None else jnp.asarray(bias), return_lse=True)
    want = np.asarray(want.astype(jnp.float32))
    want_lse = np.asarray(want_lse)[:, :, :sq, 0]
    got, got_lse = tfa.flash_attention_forward(
        torch.from_numpy(q).to(tdt), torch.from_numpy(k).to(tdt), torch.from_numpy(v).to(tdt),
        None if bias is None else torch.from_numpy(bias), return_lse=True)
    got, got_lse = got.float().numpy(), got_lse.numpy()
    assert got.shape == (b, h, sq, d)
    np.testing.assert_allclose(got, want, atol=ATOL_F32 if dtype == "float32" else ATOL_BF16)
    if lse:
        np.testing.assert_allclose(got_lse, want_lse, atol=LSE_ATOL, rtol=1e-6)
    if kind == "masked_row":  # every key of row 40 is -1e30: the mean of all Sk values
        mean = v.mean(axis=2) if dtype == "float32" else torch.from_numpy(v).to(
            torch.bfloat16).float().numpy().mean(axis=2)
        np.testing.assert_allclose(got[:, :, 40], mean, atol=ATOL_F32 if dtype == "float32"
                                   else ATOL_BF16)
        assert np.isfinite(got_lse[:, :, 40]).all() and (got_lse[:, :, 40] < -1e29).all()


@pytest.mark.parametrize("variant", sorted(kernel_variants.FWD_VARIANTS))
def test_kernel_variants_apply_to_the_forward(variant):
    """Each default forward variant of tools/kernel_variants.py edits text
    that the forward's source holds once, so the tool still measures what
    PERF.md reports."""
    text = (CSRC / kernel_variants.FWD_SOURCE).read_text()
    for old, _ in kernel_variants.FWD_VARIANTS[variant]:
        assert text.count(old) == 1


@pytest.mark.parametrize("d,dtype,route", [
    (32, 1, "wgmma"), (64, 1, "wgmma"), (96, 1, "wgmma"), (128, 1, "mma.sync"),
    (48, 1, "fp32 pipes"), (32, 0, "fp32 pipes"), (64, 0, "fp32 pipes")])
def test_route_by_dtype_and_head_width(d, dtype, route):
    """``mm_flash_attention_fwd_route`` (which ``chip_smoke`` prints beside
    each case) as its source decides it: 2 `wgmma` for bf16 at 32, 64 and
    96, 1 `mma.sync` for bf16 at 128, 0 the FP32 pipes."""
    text = (CSRC / "flash_attention_fwd.cu").read_text()
    body = text[text.index("int mm_flash_attention_fwd_route("):]
    body = body[:body.index("\n}\n")]
    assert "if (dtype == 1 && (D == 32 || D == 64 || D == 96)) return 2;" in body
    assert "return dtype == 1 && D == 128 ? 1 : 0;" in body
    got = 2 if dtype == 1 and d in (32, 64, 96) else 1 if dtype == 1 and d == 128 else 0
    assert ("fp32 pipes", "mma.sync", "wgmma")[got] == route


def test_argtypes_of_the_route_entry():
    params = re.search(r"int mm_flash_attention_fwd_route\(([^)]*)\)",
                       (CSRC / "flash_attention_fwd.cu").read_text()).group(1).split(",")
    argtypes = re.search(r"lib\.mm_flash_attention_fwd_route\.argtypes = \[([^\]]*)\]",
                         Path(tfa.__file__).read_text()).group(1).split(",")
    assert len(params) == len(argtypes) == 2
    assert all(p.strip().startswith("int ") for p in params)
    assert all(a.strip() == "_I" for a in argtypes)


def test_head_width_32_key_padding_over_whole_tiles_matches_jax():
    """Head width 32 (the `wgmma` kernel's one-warpgroup route on the card)
    at (2, 2, 40, 300, 32) fp32, MDETR-style key padding as segment ids
    (queries 1, keys 1 where real) that masks the whole second 128-key tile
    and batch 1's tail, and a query row whose segment id no key carries: o
    and lse against the JAX forward in interpret mode, with this file's
    tolerances; the row that sees no key has o = 0 and lse = -inf (the
    port's contract, which the JAX kernel does not state: it is left out of
    the comparison)."""
    r = np.random.RandomState(40)
    q = r.randn(2, 2, 40, 32).astype(np.float32)
    k = r.randn(2, 2, 300, 32).astype(np.float32)
    v = r.randn(2, 2, 300, 32).astype(np.float32)
    qseg = np.ones((2, 40), dtype=np.int32)
    qseg[0, 3] = 7
    kvseg = np.ones((2, 300), dtype=np.int32)
    kvseg[:, 128:256] = 0
    kvseg[1, 280:] = 0
    want, want_lse = _jax(q, k, v, False, qseg, kvseg, jnp.float32)
    got, got_lse = _port(q, k, v, False, qseg, kvseg, torch.float32)
    assert (got[0, :, 3] == 0).all() and (got_lse[0, :, 3] == -np.inf).all()
    seen = np.ones((2, 40), dtype=bool)
    seen[0, 3] = False
    np.testing.assert_allclose(got.transpose(0, 2, 1, 3)[seen],
                               want.transpose(0, 2, 1, 3)[seen], atol=ATOL_F32)
    np.testing.assert_allclose(got_lse.transpose(0, 2, 1)[seen],
                               want_lse.transpose(0, 2, 1)[seen], atol=LSE_ATOL, rtol=1e-6)

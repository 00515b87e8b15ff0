"""The port's int8 KV cache (multimodal_tpu_torch/ops/kv_cache.py) and its
decode attention (ops/quantized_attention.py, kernel #10) held against the
JAX package's.

On the CPU the port's wrapper runs its plain PyTorch version; the JAX
``quantized_cache_attention`` runs its Pallas kernel in interpret mode (as
tests/serving/test_kv_quant.py does through the engine). Inputs come from a
numpy seed and go to both as the same arrays; cache lengths are multiples of
128, the lengths the TPU kernel takes.
"""

import importlib.util
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_tpu.ops import kv_cache as jkv
from multimodal_tpu.ops import quantized_attention as jqa
from multimodal_tpu_torch.ops import kv_cache as tkv
from multimodal_tpu_torch.ops import quantized_attention as tqa
from multimodal_tpu_torch.tools import kernel_variants

ROOT = Path(__file__).resolve().parents[1]

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
    # no cap on the cache's length: the kernel splits it into runs
    assert tqa.supports_quantized_attention(q, torch.ones(1, 1, 1, 50_000, dtype=torch.bool), 0.0)
    assert tqa.supports_quantized_attention(q, torch.ones(1, 1, 1, 60_000, dtype=torch.bool), 0.0)
    assert tqa.supports_quantized_attention(torch.zeros(1, 8, 1, 64),
                                            torch.ones(1, 1, 1, 60_000, dtype=torch.bool), 0.0,
                                            kv_heads=1)  # 8 rows


@pytest.mark.parametrize("cache_len,runs", [
    (1, 1), (128, 1), (256, 1), (257, 2), (4096, 16), (8192, 32), (32768, 128),
    (60_000, 235)])
def test_runs(cache_len, runs):
    """A (kv head, batch row)'s positions cut into runs of ``_RUN_LEN``, the
    kernel's item, whatever the cache's length."""
    assert tqa._runs(cache_len) == runs
    assert (runs - 1) * tqa._RUN_LEN < cache_len <= runs * tqa._RUN_LEN


def test_run_length_is_the_kernels():
    """The wrapper's run is the kernel's kRun (the scratch is sized by it)."""
    src = (ROOT / "multimodal_tpu_torch" / "csrc" / "quantized_cache_attention.cu").read_text()
    assert int(re.search(r"constexpr int kRun = (\d+);", src).group(1)) == tqa._RUN_LEN


@pytest.mark.parametrize("b,hkv,rows,cache_len,d,want", [
    # the decode tick: 33 slots x 12 heads, one row, 4096 positions
    (33, 12, 1, 4096, 64, 1584 + 4 * 396 * (4096 + 16 * 66)),
    # a verify window of 5 rows; 8 rows of a GQA group at 8192 positions
    (8, 12, 5, 4096, 64, 384 + 4 * 96 * 5 * (4096 + 16 * 66)),
    (8, 3, 8, 8192, 64, 96 + 4 * 24 * 8 * (8192 + 32 * 66)),
    (8, 8, 1, 2048, 128, 256 + 4 * 64 * (2048 + 8 * 130)),
    (1, 3, 1, 300, 32, 16 + 4 * 3 * (300 + 2 * 34)),
])
def test_workspace_bytes(b, hkv, rows, cache_len, d, want):
    """The scratch: one counter for each of the G = b x h_kv groups, padded
    to 16 bytes (4 G rounded up), then fp32 scores (rows x L), each run's max
    and sum and its partial output (rows x d), for each group."""
    assert tqa._workspace_bytes(b, hkv, rows, cache_len, d) == want
    assert want % 4 == 0


def test_launch_refuses_short_scratch_and_outputs():
    q = torch.zeros(2, 4, 1, 64)
    (kq, ks), (vq, vs) = _caches(2, 4, 256, 64, seed=3)
    kc = tqa.QuantizedKV(torch.from_numpy(kq), torch.from_numpy(ks))
    vc = tqa.QuantizedKV(torch.from_numpy(vq), torch.from_numpy(vs))
    mask = torch.ones(2, 1, 1, 256, dtype=torch.bool)
    need = tqa._workspace_bytes(2, 4, 1, 256, 64)
    with pytest.raises(ValueError, match="scratch"):
        tqa._launch(q, kc, vc, mask, torch.empty_like(q), torch.empty(need - 16, dtype=torch.uint8))
    with pytest.raises(ValueError, match="out"):
        tqa._launch(q, kc, vc, mask, torch.empty(2, 4, 2, 64), torch.empty(need, dtype=torch.uint8))


def test_argtypes_match_the_entry_point():
    """The wrapper's ctypes signature has one argument per parameter of
    ``mm_quantized_cache_attention``: pointers (strides, scratch, stream)
    as pointers, the scale as a float, sizes and codes as ints."""
    src = (ROOT / "multimodal_tpu_torch" / "csrc" / "quantized_cache_attention.cu").read_text()
    params = re.search(r"int mm_quantized_cache_attention\(([^)]*)\)", src).group(1).split(",")
    py = Path(tqa.__file__).read_text()
    argtypes = re.search(r"lib\.mm_quantized_cache_attention\.argtypes = \[([^\]]*)\]",
                         py).group(1).split(",")
    assert len(params) == len(argtypes) == 20
    for param, arg in zip(params, argtypes):
        param, arg = param.strip(), arg.strip()
        if "*" in param:
            assert arg == "_V", param
        elif param.startswith("float"):
            assert arg == "ctypes.c_float", param
        else:
            assert arg == "_I", param


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def _run_split(q, k_cache, v_cache, mask, run_len):
    """The kernel's arithmetic over runs of ``run_len`` positions, in
    PyTorch: each run's max and sum of exp(s - max) per row (a row that sees
    none of the run: -1e30 and the run's length), the row's max and sum from
    the runs' pairs in run order, p = exp(s - max) / sum and p' = bf16(p x
    v_scale) as the whole-row body forms them, each run's fp32 partial
    output, and the partials summed in run order."""
    b, hq, s, d = q.shape
    h, cache_len = k_cache.q.shape[1], k_cache.q.shape[2]
    group = hq // h
    qb = tqa._group_rows(q.to(torch.bfloat16).float(), h)
    scores = torch.einsum("bhrd,bhld->bhrl", qb, k_cache.q.float())
    scores = scores * (k_cache.scale[:, :, None, :] * (1.0 / d ** 0.5))
    m = mask.expand(b, 1, s, cache_len)[:, 0]
    m = m[:, None].expand(b, group, s, cache_len).reshape(b, 1, group * s, cache_len)
    m = m.expand_as(scores)
    cuts = list(range(0, cache_len, run_len))
    stats = []
    for j in cuts:
        sl, ml = scores[..., j:j + run_len], m[..., j:j + run_len]
        seen = ml.any(-1)
        mr = torch.where(seen, sl.masked_fill(~ml, -torch.inf).amax(-1), -1e30)
        lr = torch.where(seen, (torch.exp(sl - mr[..., None]) * ml).sum(-1),
                         float(sl.shape[-1]))
        stats.append((mr, lr))
    row_max = torch.stack([mr for mr, _ in stats]).amax(0)
    row_sum = torch.zeros_like(row_max)
    for mr, lr in stats:
        row_sum = row_sum + lr * torch.exp(mr - row_max)
    p = torch.exp(torch.where(m, scores, -1e30) - row_max[..., None]) / row_sum[..., None]
    p = (p * v_cache.scale[:, :, None, :]).to(torch.bfloat16).float()
    out = torch.zeros(b, h, group * s, d)
    for j in cuts:
        out = out + torch.einsum("bhrl,bhld->bhrd", p[..., j:j + run_len],
                                 v_cache.q[:, :, j:j + run_len].float())
    return out.reshape(b, hq, s, d).to(q.dtype)


# (name, b, h_q, h_kv, S, L, d, run_len): the decode tick's shape scaled
# down (positions 600-3200 of a 4096 cache -> 150-800 of 1024), over 4
# runs of the kernel's 256 positions and at the full 4096 (16 runs), and
# the verify-window and GQA rows
RUN_CASES = [
    ("decode", 9, 4, 4, 1, 1024, 64, 256),
    ("decode_16_runs", 4, 4, 4, 1, 4096, 64, 256),
    ("verify_window", 4, 4, 4, 5, 1024, 64, 256),
    ("gqa_group4", 4, 8, 2, 2, 1024, 64, 256),
    ("head_width_128", 4, 2, 2, 1, 512, 128, 256),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name,b,hq,hkv,s,length,d,run_len", RUN_CASES,
                         ids=[c[0] for c in RUN_CASES])
def test_run_split_arithmetic_matches_plain(name, b, hq, hkv, s, length, d, run_len, dtype):
    """The kernel's split over runs keeps the body's rounding point (p
    normalised by the row's max and sum before p x v_scale is rounded), so
    it meets the card's bar against the plain version
    (``chip_smoke.ROW_RELATIVE_BAR``), also for a slot that sees only the
    last run (the engine's idle slot, pinned at L - S) and for a query row
    that sees nothing (uniform p, as -1e30 scores give)."""
    cs = _chip_smoke()
    r = np.random.RandomState(4)
    q = torch.from_numpy(r.randn(b, hq, s, d).astype(np.float32)).to(dtype)
    (kq, ks), (vq, vs) = _caches(b, hkv, length, d, seed=5)
    kc = tqa.QuantizedKV(torch.from_numpy(kq), torch.from_numpy(ks))
    vc = tqa.QuantizedKV(torch.from_numpy(vq), torch.from_numpy(vs))
    pos = r.randint(length * 600 // 4096, length * 3200 // 4096, size=b)
    pos[-1] = length - s
    mask = torch.from_numpy(
        np.arange(length)[None, None, None, :] <= (pos[:, None] + np.arange(s))[:, None, :, None])
    mask[0, 0, 0] = False  # a row that sees no position
    got = _run_split(q, kc, vc, mask, run_len)
    want = tqa.quantized_cache_attention_plain(q, kc, vc, mask)
    err = cs.row_relative_error(got, want)
    assert err <= cs.ROW_RELATIVE_BAR["quantized_cache_attention", dtype], err
    # the split is a different summation, not a different function
    assert -(-length // run_len) > 1


def test_kernels_are_filed_under_quantized_attention():
    """A profile files both of the kernel's launches (scores, then values)
    under #10."""
    cs = _chip_smoke()
    names = re.findall(r"__global__ void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\(",
                       (ROOT / "multimodal_tpu_torch" / "csrc" /
                        "quantized_cache_attention.cu").read_text())
    assert len(names) == 2
    for name in names:
        assert cs.kernel_group(f"void (anonymous namespace)::{name}<64, 1>(...)") == \
            "quantized_cache_attention"


@pytest.mark.parametrize("variant", sorted(kernel_variants.DECODE_VARIANTS))
def test_kernel_variants_apply_to_the_decode_kernels(variant):
    """Each default ``--decode`` variant of tools/kernel_variants.py edits
    text that is in the kernel's source, once."""
    text = (ROOT / "multimodal_tpu_torch" / "csrc" / kernel_variants.DECODE_SOURCE).read_text()
    for old, _ in kernel_variants.DECODE_VARIANTS[variant]:
        assert text.count(old) == 1, old
    assert kernel_variants.KEEP[kernel_variants.DECODE_SOURCE] == (kernel_variants.DECODE_SOURCE,)

"""The port's fused encoder kernels (multimodal_tpu_torch/ops/fused_encoder.py)
held against the JAX package's Pallas kernels.

On the CPU each port wrapper runs its plain PyTorch version; the JAX
functions run their Pallas kernels in interpret mode (as
tests/ops/test_fused_encoder.py does) and their XLA references. Inputs come
from a numpy seed and go to both as the same arrays.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_tpu.ops import fused_encoder as jfe
from multimodal_tpu_torch.ops import fused_encoder as tfe
from multimodal_tpu_torch.tools import kernel_variants

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
    widths not a multiple of 8, and blocks over the shared-memory budget;
    at head width 64 a shape is admitted only where both kernels' blocks
    (the FP32 pipes' and the bf16 `wgmma` kernel's) fit."""
    assert tfe.fused_attention_supported(seq, width, heads) is ok
    if ok and width // heads == 64:
        assert tfe._attention_smem_bytes(seq, 64) <= tfe._SMEM_LIMIT
        assert tfe._attention_wgmma_smem_bytes(seq) <= tfe._SMEM_LIMIT


def test_attention_wgmma_smem_mirrors_the_source():
    """The `wgmma` route's shared memory, as ``wg_smem`` in
    csrc/fused_qkv_attention.cu lays it out: 1,024 alignment bytes, a 64 x 64
    bf16 box of Q, S / 64 (rounded up) of K and of V, the key bias (64 floats
    a chunk) and an mbarrier a K box and one for V."""
    text = (Path(tfe.__file__).parents[1] / "csrc" / "fused_qkv_attention.cu").read_text()
    assert ("return 1024 + (1 + 2 * NC) * (size_t)kBox + 64 * NC * sizeof(float) + "
            "(NC + 1) * sizeof(uint64_t);") in " ".join(text.split())
    for seq, chunks in ((1, 1), (50, 1), (64, 1), (65, 2), (193, 4), (256, 4)):
        assert tfe._attention_wgmma_smem_bytes(seq) == (
            1024 + (1 + 2 * chunks) * 8192 + 256 * chunks + 8 * (chunks + 1))


def test_attention_forward_takes_the_wgmma_kernel_at_head_width_64():
    """The forward's kernel by dtype and head width alone, never after a
    failure: bf16 at head width 64 runs the `wgmma` kernel at every S (it
    beat the `mma.sync` kernel it replaces at every path's S on the card,
    PERF.md), fp32 and the other widths the FP32 pipes; the C entry takes no
    route."""
    text = (Path(tfe.__file__).parents[1] / "csrc" / "fused_qkv_attention.cu").read_text()
    entry = text[text.index("int mm_qkv_attention("):]
    assert "int dtype, void* stream)" in entry[:300]
    assert ("if (dtype == 0) return (int)dispatch<float>(qkv, key_bias, out, B, S, D, H, "
            "scale, causal, st);") in entry
    assert "if (D / H == kHd)\n    return (int)dispatch_wgmma(" in entry
    assert "mm::mma_bf16(" not in text and "mm::ldsm_x4" not in text  # no `mma.sync` kernel
    assert "constexpr int kHd = 64;" in text
    params = entry[entry.index("(") + 1:entry.index(")")].split(",")
    py = Path(tfe.__file__).read_text()
    argtypes = py[py.index("lib.mm_qkv_attention.argtypes = ["):].split("]")[0].split(",")
    assert len(params) == len(argtypes) == 11


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_attention_at_256_with_key_bias_and_causal_matches_jax(dtype):
    """#1's longest rows (the `wgmma` route's four key chunks) with a key
    bias under the causal mask, at a narrow width (two heads of 64): the
    plain version against ``_qkv_attention_impl`` in interpret mode. Batch
    row 0's bias masks keys [0, 100), so its queries 0-99 see masked keys
    only: every score of theirs is -1e30 (causal keys too), and the TPU
    kernel's softmax is uniform over all S keys, the mean of V (the
    `wgmma` route's query tiles skip the key chunks past their rows, whose
    keys count there). fp32 to ``ATTN_ATOL``; bf16: both round p and the
    output to bf16 at the same points, so two bf16 units in the last place
    of the output scale."""
    r = np.random.RandomState(5)
    b, s, d, h = 2, 256, 128, 2
    qkv = r.randn(b, s, 3 * d).astype(np.float32)
    kb = np.where(r.rand(b, s) < 0.3, -1e30, 0.0).astype(np.float32)
    kb[0, :100] = -1e30
    kb[1, 0] = 0.0  # every causal row of batch row 1 keeps a visible key
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16,
                                                                        torch.bfloat16)
    want = np.asarray(jfe._qkv_attention_impl(jnp.asarray(qkv, jdt), h, True, None,
                                              jnp.asarray(kb)).astype(jnp.float32))
    got = tfe.fused_qkv_attention(torch.from_numpy(qkv).to(tdt), h, True, None,
                                  torch.from_numpy(kb)).float().numpy()
    assert got.shape == (b, s, d)
    atol = ATTN_ATOL if dtype == "float32" else 2 * 2.0 ** -7 * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=atol)
    v = torch.from_numpy(qkv[0, :, 2 * d:]).to(tdt).float().numpy()
    np.testing.assert_allclose(got[0, :100], np.broadcast_to(v.mean(axis=0), (100, d)),
                               atol=atol)


@pytest.mark.parametrize("variant", sorted(kernel_variants.QKV_VARIANTS))
def test_kernel_variants_apply_to_the_qkv_attention(variant):
    """Each default ``--qkv`` variant of tools/kernel_variants.py edits text
    that #1's source holds once, so the tool still measures what PERF.md
    reports."""
    text = (Path(tfe.__file__).parents[1] / "csrc" / kernel_variants.QKV_SOURCE).read_text()
    for old, _ in kernel_variants.QKV_VARIANTS[variant]:
        assert text.count(old) == 1


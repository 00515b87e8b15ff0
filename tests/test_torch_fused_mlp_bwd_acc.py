"""Kernel #5 of the port (``fused_mlp_bwd_acc``, the MLP backward with its
weight gradients, multimodal_tpu_torch/ops/fused_encoder.py) held against
the JAX package.

On the CPU the port's wrapper runs its plain version, ``mlp_bwd_acc_plain``,
which follows the TPU kernel body ``_mlp_bwd_acc_kernel`` step by step; the
JAX side runs ``_mlp_bwd_acc_pallas`` in interpret mode, as
tests/ops/test_fused_encoder.py does. ``_MLP``'s backward takes #5 or #4 by
``fused_mlp_bwd_acc_supported``, a rule on shapes that the CPU follows too:
both branches are held against ``jax.vjp`` of the JAX ``fused_mlp`` with
the Pallas backward tiers on. Inputs come from a numpy seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_tpu.ops import fused_encoder as jfe
from multimodal_tpu_torch.ops import fused_encoder as tfe

ACTS = ["quick_gelu", "gelu", "gelu_exact", "relu", "silu"]
# fp32: the same products summed in another order over up to 300 rows (dW)
# or 256 terms (dx); the Pallas gelu_exact uses an erf polynomial 1.5e-7 off
# where the port uses torch.erf.
ATOL = 1e-4


def _bf16_atol(want: np.ndarray) -> float:
    """Two bf16 units in the last place of the output's scale: da and h are
    rounded to bf16 before the products, and an fp32 value computed in
    another order can round to the neighbouring bf16 value."""
    return 2 * 2.0 ** -7 * max(1.0, float(np.abs(want).max()))


def _inputs(seed, rows=300, din=128, dff=256, dout=128):
    r = np.random.RandomState(seed)
    x = r.randn(rows, din).astype(np.float32)
    g = (r.randn(rows, dout) * 0.5).astype(np.float32)
    w1 = (r.randn(din, dff) * din ** -0.5).astype(np.float32)
    b1 = (r.randn(dff) * 0.1).astype(np.float32)
    w2 = (r.randn(dff, dout) * dff ** -0.5).astype(np.float32)
    b2 = (r.randn(dout) * 0.1).astype(np.float32)
    return x, g, w1, b1, w2, b2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ACTS)
def test_mlp_bwd_acc_plain_matches_pallas(act, dtype):
    """300 rows: two full 128-row blocks of the TPU kernel and a ragged
    tail of 44, whose padding rows must not reach dW or db."""
    x, g, w1, b1, w2, _ = _inputs(22)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    want = jfe._mlp_bwd_acc_pallas(*(jnp.asarray(a, jdt) for a in (x, g, w1, b1, w2)), act)
    assert want is not None
    got = tfe.mlp_bwd_acc_plain(*(torch.from_numpy(a).to(tdt) for a in (x, g, w1, b1, w2)),
                                act)
    for name, gv, wv in zip(("dx", "dw1", "dw2", "db1"), got, want):
        wv = np.asarray(wv, np.float32).reshape(gv.shape)
        assert gv.dtype == (tdt if name == "dx" else torch.float32), name
        if dtype == "float32":
            atol = ATOL
        elif name == "dx":
            atol = _bf16_atol(wv)
        else:
            # fp32 sums over 300 rows of bf16-rounded da / h: one rounding
            # step of da or h moves a term by 2^-8 of itself
            atol = 2.0 ** -8 * float(np.abs(wv).max()) + 1e-3
        np.testing.assert_allclose(gv.float().numpy(), wv, atol=atol, err_msg=name)


def test_mlp_bwd_acc_db1_sums_unrounded_da():
    """#5's db1 sums the fp32 da (``_mlp_bwd_acc_kernel``), #4's route the
    bf16-rounded one: in bf16 the two differ, and each matches its own TPU
    arithmetic."""
    x, g, w1, b1, w2, _ = _inputs(23)
    ts = [torch.from_numpy(a).bfloat16() for a in (x, g, w1, b1, w2)]
    db1_acc = tfe.mlp_bwd_acc_plain(*ts, "gelu_exact")[3]
    da = tfe.mlp_bwd_plain(*ts, "gelu_exact")[1]
    assert not torch.equal(db1_acc, da.float().sum(0))
    want = np.asarray(jfe._mlp_bwd_acc_pallas(
        *(jnp.asarray(a, jnp.bfloat16) for a in (x, g, w1, b1, w2)), "gelu_exact")[3])[0]
    np.testing.assert_allclose(db1_acc.numpy(), want, atol=1e-3)


def _port_mlp_grads(x, g, w1, b1, w2, b2, act):
    ts = [torch.from_numpy(a).requires_grad_() for a in (x, w1, b1, w2, b2)]
    out = tfe.fused_mlp(*ts, act)
    return [t.numpy() for t in torch.autograd.grad(out, ts, torch.from_numpy(g))]


@pytest.mark.parametrize("rows,acc", [(76, False), (tfe._ACC_MIN_ROWS, True)])
@pytest.mark.parametrize("act", ["quick_gelu", "gelu_exact"])
def test_mlp_function_grads_match_jax_both_routes(rows, acc, act, monkeypatch):
    """(dx, dW1, db1, dW2, db2) of ``_MLP`` on each branch of the predicate
    (#4 at 76 rows, #5 from the threshold up) against ``jax.vjp`` of the JAX
    ``fused_mlp`` with its Pallas backward tiers on, which try the
    dW-accumulating kernel first."""
    monkeypatch.setenv("MMTPU_FORCE_FUSED_ENCODER", "1")
    monkeypatch.setenv("MMTPU_FUSED_MLP_BWD", "1")
    x, g, w1, b1, w2, b2 = _inputs(24, rows=rows)
    assert tfe.fused_mlp_bwd_acc_supported(rows, 128, 256, 128) is acc
    got = _port_mlp_grads(x, g, w1, b1, w2, b2, act)
    _, vjp = jax.vjp(lambda *a: jfe.fused_mlp(*a, act), *map(jnp.asarray, (x, w1, b1, w2, b2)))
    want = vjp(jnp.asarray(g))
    for name, gv, wv in zip(("dx", "dW1", "db1", "dW2", "db2"), got, want):
        assert gv.shape == wv.shape, name
        # dW sums over up to 16,385 rows in another order
        atol = ATOL * (1 + rows / 256)
        np.testing.assert_allclose(gv, np.asarray(wv), atol=atol, err_msg=name)


def test_mlp_function_acc_route_matches_plain_autograd():
    """``_MLP``'s #5 branch against autograd through the plain forward, the
    weights passed as the column-major views an nn.Linear gives: each
    gradient comes back in its input's shape and layout."""
    x, g, w1, b1, w2, b2 = _inputs(25, rows=tfe._ACC_MIN_ROWS)
    lin1 = torch.from_numpy(np.ascontiguousarray(w1.T)).requires_grad_()
    lin2 = torch.from_numpy(np.ascontiguousarray(w2.T)).requires_grad_()
    xs, b1s, b2s = (torch.from_numpy(a).requires_grad_() for a in (x, b1, b2))
    leaves = (xs, lin1, b1s, lin2, b2s)
    got = torch.autograd.grad(tfe.fused_mlp(xs, lin1.t(), b1s, lin2.t(), b2s, "silu"),
                              leaves, torch.from_numpy(g))
    want = torch.autograd.grad(tfe.mlp_plain(xs, lin1.t(), b1s, lin2.t(), b2s, "silu"),
                               leaves, torch.from_numpy(g))
    for leaf, gv, wv in zip(leaves, got, want):
        assert gv.shape == leaf.shape
        np.testing.assert_allclose(gv.numpy(), wv.numpy(), atol=1e-3)


@pytest.mark.parametrize(
    "rows,din,dff,dout,ok",
    [
        (256 * 50, 768, 3072, 768, False),   # CLIP vision, batch 256: #4 + library dW
        (256 * 77, 512, 2048, 512, True),    # CLIP text, batch 256
        (8 * 8192, 768, 3072, 768, True),    # LM train, 8 x 8192
        (64 * 197, 768, 3072, 768, False),   # FLAVA image, batch 64: #4 + library dW
        (64 * 77, 768, 3072, 768, False),    # FLAVA text, batch 64: #4 + library dW
        (64 * 275, 768, 3072, 768, True),    # FLAVA multimodal, batch 64
        (8 * 50, 768, 3072, 768, False),     # CLIP gradient check, 8 pairs
        (8 * 77, 512, 2048, 512, False),
        (1024, 768, 3072, 768, False),       # LM gradient check, 1 row
        (2 * 197, 768, 3072, 768, False),    # FLAVA gradient check, batch 2
        (64 * 275, 1024, 4096, 1024, True),  # wider than 768: the GEMMs take any width
        (tfe._ACC_MIN_ROWS, 768, 3072, 768, True),       # the threshold
        (tfe._ACC_MIN_ROWS - 1, 768, 3072, 768, False),
        (64 * 197, 96, 3072, 768, False),    # not a fused MLP width
    ],
)
def test_acc_predicate_choice(rows, din, dff, dout, ok):
    """#5 from 16,385 rows (CLIP's text, FLAVA's multimodal and the LM's
    train-step MLPs), at any fused MLP width; #4 below (the other train
    steps' MLPs and the small-batch gradient checks'), where the card timed
    #4 plus the library's dW faster. The rule reads shapes only."""
    assert tfe.fused_mlp_bwd_acc_supported(rows, din, dff, dout) is ok


@pytest.mark.parametrize(
    "rows,din,dff,dout,splits",
    [
        (64 * 197, 768, 3072, 768, 4),   # 288 tiles: 9 waves of 132 for 4 runs
        (8 * 8192, 768, 3072, 768, 4),
        (256 * 77, 512, 2048, 512, 2),   # 128 tiles: one wave a run
        (1000, 768, 3072, 768, 4),
        (100, 768, 3072, 768, 2),        # two 64-row k-blocks
        (64, 768, 3072, 768, 1),         # one k-block: one run
    ],
)
def test_acc_splits(rows, din, dff, dout, splits):
    """The dW products' row runs: 2-4, the fewest waves of the card's SMs
    per run, never more runs than 64-row k-blocks."""
    assert tfe._acc_splits(rows, din, dff, dout) == splits


def test_acc_wrapper_refuses_other_devices():
    x, g, w1, b1, w2, _ = _inputs(26, rows=8)
    meta = [torch.from_numpy(a).to("meta") for a in (x, g, w1, b1, w2)]
    with pytest.raises(ValueError, match="no kernel"):
        tfe.fused_mlp_bwd_acc(*meta, "gelu")
    with pytest.raises(ValueError, match="unknown activation"):
        tfe.fused_mlp_bwd_acc(*map(torch.from_numpy, (x, g, w1, b1, w2)), "tanh")

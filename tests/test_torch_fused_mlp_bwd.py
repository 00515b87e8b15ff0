"""Kernel #4, stage 1 of the MLP backward (``fused_mlp_bwd``,
multimodal_tpu_torch/ops/fused_encoder.py): its plain version against the
JAX package's ``_mlp_bwd_pallas`` (the Pallas kernel in interpret mode) at
the gradient checks' few rows; the rule that splits its dx product over Dff
and the workspace the wrapper allocates for it; the C entry point's ctypes
signature; and the names of its CUDA kernels, which ``chip_smoke.py``
files under #4's device time.

Inputs come from a numpy seed and go to both frameworks as the same arrays.
"""

import importlib.util
import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_tpu.ops import fused_encoder as jfe
from multimodal_tpu_torch.ops import fused_encoder as tfe

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "multimodal_tpu_torch" / "csrc"
ACTS = ["quick_gelu", "gelu", "gelu_exact", "relu", "silu"]
# fp32: the same products summed in another order over up to 256 terms; the
# Pallas gelu_exact uses an erf polynomial 1.5e-7 off where the port uses
# torch.erf.
ATOL = 1e-4


def _bf16_atol(want: np.ndarray) -> float:
    """Two bf16 units in the last place of the output's scale: da and h are
    rounded to bf16, and an fp32 value computed in another order can round
    to the neighbouring bf16 value."""
    return 2 * 2.0 ** -7 * max(1.0, float(np.abs(want).max()))


def _inputs(seed, rows, din=128, dff=256, dout=128):
    r = np.random.RandomState(seed)
    x = r.randn(rows, din).astype(np.float32)
    g = (r.randn(rows, dout) * 0.5).astype(np.float32)
    w1 = (r.randn(din, dff) * din ** -0.5).astype(np.float32)
    b1 = (r.randn(dff) * 0.1).astype(np.float32)
    w2 = (r.randn(dff, dout) * dff ** -0.5).astype(np.float32)
    return x, g, w1, b1, w2


@pytest.fixture
def _force_fused(monkeypatch):
    monkeypatch.setenv("MMTPU_FORCE_FUSED_ENCODER", "1")


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("rows", [154, 300])  # FLAVA's text gradient check; a ragged 300
def test_fused_mlp_bwd_cpu_route_matches_pallas(rows, act, _force_fused):
    """The wrapper on CPU tensors (its plain version) against the TPU
    kernel: (dx, da, h)."""
    args = _inputs(rows + len(act), rows)
    want = jfe._mlp_bwd_pallas(*map(jnp.asarray, args), act)
    got = tfe.fused_mlp_bwd(*map(torch.from_numpy, args), act)
    for name, gv, wv in zip(("dx", "da", "h"), got, want):
        assert gv.shape == wv.shape, name
        np.testing.assert_allclose(gv.numpy(), np.asarray(wv), atol=ATOL, err_msg=name)


@pytest.mark.parametrize("rows", [154, 300])
def test_fused_mlp_bwd_bf16_cpu_route_matches_pallas(rows, _force_fused):
    args = _inputs(rows, rows)
    want = jfe._mlp_bwd_pallas(*(jnp.asarray(a, jnp.bfloat16) for a in args), "gelu_exact")
    got = tfe.fused_mlp_bwd(*(torch.from_numpy(a).bfloat16() for a in args), "gelu_exact")
    for name, gv, wv in zip(("dx", "da", "h"), got, want):
        assert gv.dtype == torch.bfloat16, name
        wv = np.asarray(wv).astype(np.float32)
        np.testing.assert_allclose(gv.float().numpy(), wv, atol=_bf16_atol(wv), err_msg=name)


@pytest.mark.parametrize(
    "rows,din,dff,splits",
    [
        (2 * 197, 768, 3072, 5),    # FLAVA's image gradient check: 24 dx tiles
        (2 * 77, 768, 3072, 10),    # its text rows: 12 tiles
        (2 * 275, 768, 3072, 4),    # its multimodal rows: 30 tiles
        (1024, 768, 3072, 2),       # the LM's packed row: 48 tiles
        (300, 256, 512, 2),         # 8 k-blocks: at least 4 a run
        (256 * 50, 768, 3072, 1),   # CLIP's vision MLP: 600 tiles fill the card
        (256 * 77, 512, 2048, 1),
        (33, 768, 3072, 12),        # a decode tick's rows: 6 tiles
        (1, 64, 64, 1),             # one k-block
    ],
)
def test_dx_splits(rows, din, dff, splits):
    """Runs of Dff in dx's product: as many as fill the 132 SMs once with
    the 128 x 128 dx tiles, at least 4 k-blocks of 64 a run, none empty."""
    assert tfe._mlp_bwd_splits(rows, din, dff) == splits
    kblocks = dff // 64
    per = -(-kblocks // splits)
    assert (splits - 1) * per < kblocks  # the C entry point's rule: no empty run


@pytest.mark.parametrize("rows,din,dff", [(394, 768, 3072), (154, 768, 3072), (300, 256, 512),
                                          (12_800, 768, 3072), (1, 64, 64)])
def test_workspace_holds_the_dx_partials(rows, din, dff):
    """bf16: fp32 (splits, rows, Din) where dx's product is split, else
    none; fp32 never splits."""
    splits = tfe._mlp_bwd_splits(rows, din, dff)
    want = (splits, rows, din) if splits > 1 else None
    assert tfe._mlp_bwd_workspace(rows, din, dff, torch.bfloat16) == want
    assert tfe._mlp_bwd_workspace(rows, din, dff, torch.float32) is None


def test_workspace_at_flavas_gradient_check():
    """394 image rows at 768 -> 3072: five fp32 partials of dx, 6.05 MB."""
    ws = tfe._mlp_bwd_workspace(394, 768, 3072, torch.bfloat16)
    assert math.prod(ws) * 4 == 6_051_840


def test_argtypes_match_the_entry_point():
    """The wrapper's ctypes signature has one argument per parameter of
    ``mm_fused_mlp_bwd``: pointers (the workspace among them) as pointers,
    sizes, the run count and the codes as ints."""
    params = re.search(r"int mm_fused_mlp_bwd\(([^)]*)\)",
                       (CSRC / "fused_mlp_bwd.cu").read_text()).group(1).split(",")
    py = Path(tfe.__file__).read_text()
    argtypes = re.search(r"lib\.mm_fused_mlp_bwd\.argtypes = \[([^\]]*)\]",
                         py).group(1).split(",")
    assert len(params) == len(argtypes) == 17
    for param, arg in zip(params, argtypes):
        param, arg = param.strip(), arg.strip()
        assert arg == ("_V" if "*" in param else "_I"), param


def _kernel_names(source):
    """The `__global__` functions of a source."""
    return re.findall(r"__global__ void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\(",
                      (CSRC / source).read_text())


def test_kernel_names_are_filed_under_their_kernel():
    """#4's CUDA kernels are named ``fused_mlp_bwd_*`` and never
    ``fused_mlp_bwd_acc*``, so a profile files them under #4; #5's keep
    theirs."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    mine = _kernel_names("fused_mlp_bwd.cu")
    assert sorted(mine) == ["fused_mlp_bwd_dx_f32_kernel", "fused_mlp_bwd_dx_kernel",
                            "fused_mlp_bwd_dx_sum_kernel", "fused_mlp_bwd_zdh_f32_kernel",
                            "fused_mlp_bwd_zdh_kernel"]
    for name in mine:
        key = f"void (anonymous namespace)::{name}<2>(mm::ZdhParams)"
        assert cs.kernel_group(key) == "fused_mlp_bwd", name
    for name in _kernel_names("fused_mlp_bwd_acc.cu"):
        assert name.startswith("fused_mlp_bwd_acc_")
        assert cs.kernel_group(f"void (anonymous namespace)::{name}<2>(float const*)") \
            == "fused_mlp_bwd_acc", name


def test_the_stages_are_shared_not_copied():
    """#4 and #5 run one z/dh and one dx body (csrc/mlp_bwd_common.cuh),
    #4's without the db1 partials."""
    mine = (CSRC / "fused_mlp_bwd.cu").read_text()
    acc = (CSRC / "fused_mlp_bwd_acc.cu").read_text()
    assert "mm::zdh_stage<ACT, false>(p, smem_raw);" in mine
    assert "mm::zdh_stage<ACT, true>(p, smem_raw);" in acc
    assert mine.count("mm::dx_stage(p, smem_raw);") == acc.count("mm::dx_stage(p, smem_raw);") == 1
    for text in (mine, acc):
        assert "act_and_grad<ACT>(" not in text and "wg::mma_step" not in text.split(
            "fused_mlp_bwd_acc_dw_kernel")[0]


def test_wrapper_refuses_other_devices():
    x, g, w1, b1, w2 = (torch.from_numpy(a).to("meta") for a in _inputs(1, rows=8))
    with pytest.raises(ValueError, match="no kernel"):
        tfe.fused_mlp_bwd(x, g, w1, b1, w2, "gelu")
    with pytest.raises(ValueError, match="unknown activation"):
        tfe.fused_mlp_bwd(x, g, w1, b1, w2, "tanh")

"""Kernel #3, the MLP forward (multimodal_tpu_torch/ops/fused_encoder.py):
its plain version against the JAX package's ``_mlp_impl`` (the Pallas kernel
in interpret mode) at a decode tick's few rows, a ragged row count and a
Dff that is a multiple of 64 but not of 128; the workspace the wrapper
allocates for the CUDA kernels; and the names under which ``chip_smoke.py``
files the kernels' entries and plants its faults.

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
ACTIVATIONS = ("quick_gelu", "gelu", "gelu_exact", "relu", "silu")
# fp32: the same fp32 arithmetic in two frameworks, sums in another order;
# the Pallas gelu_exact's erf polynomial is 1.5e-7 off, far inside this.
ATOL = 1e-5


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _inputs(seed, rows, din, dff, dout):
    r = np.random.RandomState(seed)
    x = r.randn(rows, din).astype(np.float32)
    w1 = (r.randn(din, dff) * din ** -0.5).astype(np.float32)
    b1 = (r.randn(dff) * 0.02).astype(np.float32)
    w2 = (r.randn(dff, dout) * dff ** -0.5).astype(np.float32)
    b2 = (r.randn(dout) * 0.02).astype(np.float32)
    return x, w1, b1, w2, b2


@pytest.mark.parametrize("act", ACTIVATIONS)
@pytest.mark.parametrize("rows,din,dff,dout", [
    (33, 128, 256, 128),   # a decode tick's rows
    (129, 128, 256, 128),  # one row past a 128-row tile
    (33, 128, 192, 64),    # Dff a multiple of 64, not of 128
    (129, 64, 192, 192),
])
def test_plain_mlp_matches_pallas(rows, din, dff, dout, act):
    args = _inputs(rows + dff, rows, din, dff, dout)
    want = np.asarray(jfe._mlp_impl(*map(jnp.asarray, args), act))
    got = tfe.mlp_plain(*map(torch.from_numpy, args), act).numpy()
    assert got.shape == want.shape == (rows, dout)
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("act", ACTIVATIONS)
def test_plain_mlp_bf16_matches_pallas(act):
    """bf16: both round h and the output to bf16 once; a value landing on
    the other side of a rounding tie moves by a bf16 unit in the last place
    (2^-7 relative), so the bound is two such units of the output scale."""
    args = _inputs(7, 33, 128, 192, 64)
    want = np.asarray(jfe._mlp_impl(*(jnp.asarray(a, jnp.bfloat16) for a in args), act))
    got = tfe.mlp_plain(*(torch.from_numpy(a).to(torch.bfloat16) for a in args), act)
    want = want.astype(np.float32)
    atol = 2 * 2.0 ** -7 * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.float().numpy(), want, atol=atol)


def test_fused_mlp_on_the_cpu_takes_no_rows():
    x = torch.zeros(0, 3, 64)
    w1, b1 = torch.zeros(64, 128), torch.zeros(128)
    w2, b2 = torch.zeros(128, 64), torch.zeros(64)
    assert tfe.fused_mlp(x, w1, b1, w2, b2, "gelu").shape == (0, 3, 64)


@pytest.mark.parametrize("rows", [0, 1, 33, 48, 127, 128, 129, 512, 65536])
def test_workspace_bf16(rows):
    """bf16 runs the two GEMMs at every row count: its workspace is h,
    (rows, Dff), which at 0 rows is empty (the wrapper launches nothing)."""
    shape = tfe._mlp_fwd_workspace(rows, 3072, torch.bfloat16)
    assert shape == (rows, 3072)
    assert (math.prod(shape) == 0) == (rows == 0)


@pytest.mark.parametrize("rows", [0, 33, 129, 65536])
def test_workspace_fp32_is_none(rows):
    assert tfe._mlp_fwd_workspace(rows, 3072, torch.float32) is None


def test_workspace_sizes_of_the_paths():
    """h at a decode tick's 33 rows and at the LM train step's 65,536 rows,
    768 -> 3072 -> 768 in bf16: 203 KB and 403 MB, freed when the call
    returns."""
    for rows, nbytes in ((33, 202_752), (65536, 402_653_184)):
        assert math.prod(tfe._mlp_fwd_workspace(rows, 3072, torch.bfloat16)) * 2 == nbytes


def test_argtypes_match_the_entry_point():
    """The wrapper's ctypes signature has one argument per parameter of
    ``mm_fused_mlp`` in csrc/fused_mlp.cu."""
    src = (CSRC / "fused_mlp.cu").read_text()
    params = re.search(r"int mm_fused_mlp\(([^)]*)\)", src).group(1).split(",")
    py = Path(tfe.__file__).read_text()
    argtypes = re.search(r"lib\.mm_fused_mlp\.argtypes = \[([^\]]*)\]", py).group(1).split(",")
    assert len(params) == len(argtypes) == 14


def _entry_names():
    src = (CSRC / "fused_mlp.cu").read_text()
    names = re.findall(r"^(fused_mlp\w*_kernel)\(", src, flags=re.M)
    assert len(names) == 3, names  # fp32, stages H and O
    return names


@pytest.mark.parametrize("name", _entry_names())
@pytest.mark.parametrize("act", range(5))
def test_profile_groups_file_entries_under_fused_mlp(name, act):
    """Every kernel of csrc/fused_mlp.cu, as the profiler names it, is filed
    under #3's group, so the paths' device time by group counts it there."""
    cs = _chip_smoke()
    key = f"void (anonymous namespace)::{name}<{act}>((anonymous namespace)::GemmParams)"
    assert cs.kernel_group(key) == "fused_mlp"
    assert cs.kernel_group(f"void (anonymous namespace)::{name}<float, {act}, 4>(float const*)") \
        == "fused_mlp"


@pytest.mark.parametrize("name,group", [
    ("fused_mlp_bwd_acc_zdh_kernel<2>", "fused_mlp_bwd_acc"),
    ("fused_mlp_bwd_acc_sum_kernel", "fused_mlp_bwd_acc"),
    ("fused_mlp_bwd_kernel<__nv_bfloat16, 2, 12>", "fused_mlp_bwd"),
    ("fused_mlp_bwd_zdh_kernel<2>", "fused_mlp_bwd"),
    ("fused_mlp_bwd_dx_kernel", "fused_mlp_bwd"),
    ("fused_mlp_bwd_dx_sum_kernel", "fused_mlp_bwd"),
    ("fused_mlp_bwd_zdh_f32_kernel<2>", "fused_mlp_bwd"),
    ("fused_mlp_bwd_acc_dx_kernel", "fused_mlp_bwd_acc"),
])
def test_profile_groups_keep_the_backward_apart(name, group):
    assert _chip_smoke().kernel_group(f"void (anonymous namespace)::{name}(float const*)") \
        == group


@pytest.mark.parametrize("fault", sorted(_chip_smoke().PLANTED_FAULTS))
def test_planted_fault_matches_once_in_its_kernel(fault):
    """Each planted fault's text is in the body of the function it names
    exactly once, as ``chip_smoke.planted_faults`` requires before it
    builds the faulty copy on the card."""
    source, signature, old, _ = _chip_smoke().PLANTED_FAULTS[fault]
    text = (CSRC / source).read_text()
    start = text.index(signature)
    end = text.index("\n}\n", start)
    assert text[start:end].count(old) == 1

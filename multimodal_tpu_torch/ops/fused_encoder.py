"""Fused encoder-block kernels: attention off the fused QKV projection, and
the two-layer MLP, each with its backward.

Counterpart of ``multimodal_tpu/ops/fused_encoder.py``. Each function here
takes the JAX function's layouts:

- ``fused_qkv_attention``: ``qkv`` is ``(B, S, 3D)`` laid out ``[q | k | v]``
  with heads contiguous; the output is ``(B, S, D)``; the gradient comes
  back in ``qkv``'s fused layout.
- ``fused_mlp``: ``x`` is ``(..., Din)``, weights ``(Din, Dff)`` and
  ``(Dff, Dout)``. The kernels read the weights column-major, as
  ``linear.weight.t()`` of an ``nn.Linear`` gives them, so the layer passes
  its weights without a copy.

Both are ``torch.autograd.Function``s, as the JAX functions are
``custom_vjp``s: the forward saves its inputs only, and the backward
recomputes what it needs. On a CUDA tensor each wrapper launches its
hand-written kernel (forward ``csrc/fused_qkv_attention.cu`` and
``csrc/fused_mlp.cu`` (two GEMMs on the core of ``csrc/wgmma_gemm.cuh``),
backward ``csrc/fused_qkv_attention_bwd.cu`` and,
for the MLP by a rule on shapes, ``csrc/fused_mlp_bwd_acc.cu`` or
``csrc/fused_mlp_bwd.cu``, which share their first two stages on the GEMM
core of ``csrc/wgmma_gemm.cuh``) or raises;
it never falls back. On a CPU tensor it runs the plain PyTorch version,
which follows the TPU kernel body's arithmetic (where it rounds to the
compute type and where it stays in fp32). Each kernel wrapper counts its
launches in its ``launches`` attribute.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from multimodal_tpu_torch.ops import _build

_SMEM_LIMIT = 232_448  # bytes of shared memory a block may use on sm_90
_MAX_SEQ = 256         # score row kept in registers: 8 values per lane
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# Activation codes of the `act` templates in csrc/fused_mlp*.cu.
_ACT_CODES = {"quick_gelu": 0, "gelu": 1, "gelu_exact": 2, "relu": 3, "silu": 4}
_ACTIVATIONS = {
    "quick_gelu": lambda z: z * torch.sigmoid(1.702 * z),
    "gelu": lambda z: torch.nn.functional.gelu(z, approximate="tanh"),
    "gelu_exact": lambda z: 0.5 * z * (1.0 + torch.erf(z * 2.0 ** -0.5)),
    "relu": torch.relu,
    "silu": torch.nn.functional.silu,
}

# Generic-module activation names (modules/layers/activation.ACT2FN) -> the
# fused kernel's activation table. NOTE the "gelu" flip: the library's
# "gelu" is exact (erf) while the kernel table's "gelu" is the tanh
# approximation; map through this, never pass ACT2FN names directly.
FUSED_ACT_FOR = {
    "gelu": "gelu_exact",
    "gelu_tanh": "gelu",
    "quick_gelu": "quick_gelu",
    "relu": "relu",
    "silu": "silu",
    "swish": "silu",
}

_V = ctypes.c_void_p
_I = ctypes.c_int
_lib: Optional[ctypes.CDLL] = None


def _kernels() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load_library()
        lib.mm_qkv_attention.argtypes = [
            _V, _V, _V, _I, _I, _I, _I, ctypes.c_float, _I, _I, _V]
        lib.mm_qkv_attention.restype = _I
        lib.mm_qkv_attention_bwd.argtypes = [
            _V, _V, _V, _V, _I, _I, _I, _I, ctypes.c_float, _I, _I, _I, _V]
        lib.mm_qkv_attention_bwd.restype = _I
        lib.mm_fused_mlp.argtypes = [
            _V, _V, _V, _V, _V, _V, _V, _I, _I, _I, _I, _I, _I, _V]
        lib.mm_fused_mlp.restype = _I
        lib.mm_fused_mlp_bwd.argtypes = [
            _V, _V, _V, _V, _V, _V, _V, _V, _V, _I, _I, _I, _I, _I, _I, _I, _V]
        lib.mm_fused_mlp_bwd.restype = _I
        lib.mm_fused_mlp_bwd_acc.argtypes = [
            _V, _V, _V, _V, _V, _V, _V, _V, _V, _I, _I, _I, _I, _I, _I, _I, _V]
        lib.mm_fused_mlp_bwd_acc.restype = _I
        _lib = lib
    return _lib


def _attention_wgmma_smem_bytes(seq: int) -> int:
    """Mirror of ``wg_smem`` in csrc/fused_qkv_attention.cu (bf16 at head
    width 64): the 1,024 bytes that align the swizzled boxes, a 64 x 64 bf16
    box of Q and S / 64 (rounded up) of K and of V each, the key bias and an
    mbarrier a K box and one for V."""
    chunks = -(-seq // 64)
    return 1024 + (1 + 2 * chunks) * 64 * 64 * 2 + 4 * 64 * chunks + 8 * (chunks + 1)


def _attention_smem_bytes(seq: int, head_dim: int) -> int:
    """Mirror of ``smem_floats`` in csrc/fused_qkv_attention.cu (the FP32
    pipes): K^T and V of one head in fp32, plus per-warp q rows and
    probability rows."""
    sp = -(-seq // 32) * 32
    warps, rows = 8, 4
    return 4 * (head_dim * (sp + 1) + seq * head_dim
                + warps * rows * head_dim + warps * sp * rows)


def fused_attention_supported(seq: int, embed_dim: int, num_heads: int) -> bool:
    """Shape predicate of the attention kernel: a clean head split with
    ``head_dim % 8 == 0`` and ``<= 128``, ``seq <= 256``, and the block of
    every kernel the shape can take within a block's shared memory: the FP32
    pipes' (``_attention_smem_bytes``, fp32 and every width) and, at head
    width 64, the bf16 `wgmma` kernel's (``_attention_wgmma_smem_bytes``),
    so that no shape is admitted that a kernel refuses."""
    if num_heads <= 0 or embed_dim % num_heads:
        return False
    dh = embed_dim // num_heads
    if dh % 8 or dh > 128 or not 0 < seq <= _MAX_SEQ:
        return False
    return _attention_smem_bytes(seq, dh) <= _SMEM_LIMIT and (
        dh != 64 or _attention_wgmma_smem_bytes(seq) <= _SMEM_LIMIT)


def fused_mlp_available(in_dim: int, hidden_dim: int, out_dim: int) -> bool:
    """Shape predicate of the MLP kernels: every width a multiple of 64."""
    return in_dim % 64 == 0 and hidden_dim % 64 == 0 and out_dim % 64 == 0


_SM_COUNT = 132  # streaming multiprocessors of an H100 SXM
_ACC_TILE = 128  # rows and columns of an output tile of kernel #5's products
# Rows from which the MLP backward takes kernel #5: set from the card's
# measurement of #5 against #4 plus the library's dW products (PERF.md).
_ACC_MIN_ROWS = 16_385


def _acc_splits(rows: int, din: int, dff: int, dout: int) -> int:
    """Row runs of kernel #5's weight-gradient products (one launch over the
    128 x 128 tiles of dW1^T and dW2^T, each tile once per run): the count
    in 2..4 whose blocks fill the H100's SMs in the fewest waves per run
    (the smallest on a tie), and never more runs than 64-row k-blocks. Each
    run writes an fp32 partial that a fixed-order pass sums."""
    t = -(-dff // _ACC_TILE)
    tiles = t * -(-din // _ACC_TILE) + -(-dout // _ACC_TILE) * t
    best = min(range(2, 5), key=lambda s: -(-tiles * s // _SM_COUNT) / s)
    return max(1, min(best, -(-rows // 64)))


def _mlp_bwd_splits(rows: int, din: int, dff: int) -> int:
    """Runs of K = Dff in kernel #4's dx product (``da . W1^T``), from the
    shapes alone: as many as fill the H100's SMs once with the 128 x 128 dx
    tiles times the runs, each run at least 4 of Dff's 64-wide k-blocks, and
    every run non-empty. 1 where the tiles alone fill the card (CLIP's
    12,800 rows); 5 at FLAVA's gradient check's 394 image rows (24 tiles).
    Each run writes an fp32 partial that a fixed-order pass sums."""
    tiles = -(-rows // _ACC_TILE) * -(-din // _ACC_TILE)
    kblocks = dff // 64
    runs = max(1, min(_SM_COUNT // tiles, kblocks // 4))
    per = -(-kblocks // runs)
    return -(-kblocks // per)


def _mlp_bwd_workspace(rows: int, din: int, dff: int, dtype: torch.dtype):
    """Shape of kernel #4's fp32 workspace: the dx partials of its runs,
    ``(splits, rows, Din)``, in bf16 where ``_mlp_bwd_splits`` gives more
    than one run; else None (fp32 runs without a split)."""
    if dtype != torch.bfloat16:
        return None
    splits = _mlp_bwd_splits(rows, din, dff)
    return (splits, rows, din) if splits > 1 else None


def fused_mlp_bwd_acc_supported(rows: int, din: int, dff: int, dout: int) -> bool:
    """Whether the MLP backward takes kernel #5 (``fused_mlp_bwd_acc``, dW
    summed by the kernel) rather than kernel #4 (``fused_mlp_bwd``) plus the
    library's dW products: the fused MLP's widths and at least
    ``_ACC_MIN_ROWS`` rows. A rule on shapes alone, so the CPU makes the
    same choice as the card.

    #5 and #4 share their first two stages (z/dh into da and h, then dx);
    #5 then sums dW1, dW2 and db1 itself, #4 leaves them to two library
    products and a sum. The threshold comes from the card
    (``chip_smoke.py``'s ``acc_threshold``, 768 -> 3072 -> 768 in bf16,
    ``PERF.md`` §6): #4 plus the library's dW beats #5 at every row
    count timed, 256 to 65,536 (0.99 against 1.11 ms at 16,384, 3.99
    against 4.51 at 65,536). Below 16,385 rows the rule takes #4; above, #5
    stays, because a threshold past every path's rows would put the
    library's dW products in place of the hand-written #5 on every path,
    which the port does not do: #5 is to be redesigned (ROADMAP.md, B).
    FLAVA's image and text MLPs and CLIP's vision MLP take #4; FLAVA's
    multimodal MLP (17,600 rows), ALBEF's ViT at 384 (18,464), CLIP's text
    MLP (19,712) and the LM's (65,536) #5."""
    return fused_mlp_available(din, dff, dout) and rows >= _ACC_MIN_ROWS


def fused_attention_bwd_supported(seq: int, embed_dim: int, num_heads: int,
                                  dtype: torch.dtype) -> bool:
    """Shape predicate of the attention backward kernels: the forward's
    domain, in either dtype (``_attention_bwd_route`` picks the kernel).
    None keeps an S x S matrix in shared memory past ``seq`` 128, and each
    fits wherever the forward's block does."""
    return fused_attention_supported(seq, embed_dim, num_heads)


# Kernels of the attention backward (the `route` of mm_qkv_attention_bwd).
_BWD_FP32_PIPES, _BWD_MMA, _BWD_WGMMA = 0, 1, 2
# Sequence length from which bf16 at head width 64 takes the `wgmma`
# kernel instead of the `mma.sync` one, set from the card (PERF.md).
_BWD_WGMMA_MIN_SEQ = 81


def _attention_bwd_route(seq: int, head_dim: int, dtype: torch.dtype) -> int:
    """The backward kernel of a shape of ``fused_attention_bwd_supported``:
    bf16 at head width 64 on the tensor cores, the `mma.sync` kernel below
    ``_BWD_WGMMA_MIN_SEQ`` and the `wgmma` kernel from it; every other shape
    on the FP32 pipes."""
    if dtype != torch.bfloat16 or head_dim != 64:
        return _BWD_FP32_PIPES
    return _BWD_WGMMA if seq >= _BWD_WGMMA_MIN_SEQ else _BWD_MMA


def _check_cuda(name: str, device: torch.device, dtype: torch.dtype,
                *tensors: torch.Tensor) -> None:
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"{name}: dtype {dtype} not supported (fp32 or bf16)")
    for t in tensors:
        if t.device != device:
            raise ValueError(f"{name}: tensors on {t.device} and {device}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: all operands must be {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: tensors must be 16-byte aligned")


# --------------------------------------------------------------------------
# fused QKV self-attention
# --------------------------------------------------------------------------


def _split_heads(qkv: torch.Tensor, num_heads: int):
    b, s, three_d = qkv.shape
    d = three_d // 3
    return (t.reshape(b, s, num_heads, d // num_heads).transpose(1, 2)
            for t in qkv.split(d, dim=-1))


def _attention_probs(q, k, scale, is_causal, key_bias) -> torch.Tensor:
    """fp32 softmax probabilities of ``(B, H, S, Dh)`` q and k."""
    s = q.shape[2]
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if key_bias is not None:
        logits = logits + key_bias.float()[:, None, None, :]
    if is_causal:
        keep = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
        logits = logits.masked_fill(~keep, -1e30)
    return torch.softmax(logits, dim=-1)


def qkv_attention_plain(
    qkv: torch.Tensor,
    num_heads: int,
    is_causal: bool = False,
    sm_scale: Optional[float] = None,
    key_bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel (the TPU kernel's
    ``_attn_head_loop``): fp32 scores and softmax, ``p`` rounded to the
    compute type before ``p . v``, fp32 sum."""
    b, s, three_d = qkv.shape
    d = three_d // 3
    scale = sm_scale if sm_scale is not None else (d // num_heads) ** -0.5
    q, k, v = _split_heads(qkv, num_heads)
    p = _attention_probs(q, k, scale, is_causal, key_bias).to(qkv.dtype).float()
    o = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    return o.transpose(1, 2).reshape(b, s, d).to(qkv.dtype)


def qkv_attention_bwd_plain(
    qkv: torch.Tensor,
    g: torch.Tensor,
    num_heads: int,
    is_causal: bool = False,
    sm_scale: Optional[float] = None,
    key_bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain PyTorch version of the backward kernel (the TPU kernel's
    ``_qkv_attn_bwd_loop``): ``p`` recomputed in fp32; ``dv = T(p)^T g``;
    ``dp = g v^T`` in fp32; ``ds = p (dp - rowsum(dp p)) scale`` from the
    fp32 ``p``; ``dq = T(ds) k`` and ``dk = T(ds)^T q``; fp32 sums, each
    result rounded to the compute type T and laid out as ``qkv``."""
    b, s, three_d = qkv.shape
    d = three_d // 3
    scale = sm_scale if sm_scale is not None else (d // num_heads) ** -0.5
    q, k, v = _split_heads(qkv, num_heads)
    gh = g.reshape(b, s, num_heads, d // num_heads).transpose(1, 2).float()
    p = _attention_probs(q, k, scale, is_causal, key_bias)
    dv = torch.einsum("bhqk,bhqd->bhkd", p.to(qkv.dtype).float(), gh)
    dp = torch.einsum("bhqd,bhkd->bhqk", gh, v.float())
    ds = p * (dp - (dp * p).sum(-1, keepdim=True)) * scale
    dsb = ds.to(qkv.dtype).float()
    dq = torch.einsum("bhqk,bhkd->bhqd", dsb, k.float())
    dk = torch.einsum("bhqk,bhqd->bhkd", dsb, q.float())
    return torch.cat(
        [t.transpose(1, 2).reshape(b, s, d) for t in (dq, dk, dv)], dim=-1
    ).to(qkv.dtype)


def _check_attention(name: str, qkv: torch.Tensor, num_heads: int,
                     key_bias: Optional[torch.Tensor]) -> None:
    if qkv.dim() != 3 or qkv.shape[-1] % 3:
        raise ValueError(f"{name}: qkv must be (B, S, 3D), got {tuple(qkv.shape)}")
    b, s, three_d = qkv.shape
    if not fused_attention_supported(s, three_d // 3, num_heads):
        raise ValueError(
            f"{name}: no kernel for seq={s}, embed_dim={three_d // 3}, "
            f"num_heads={num_heads}"
        )
    _check_cuda(name, qkv.device, qkv.dtype, qkv)
    if key_bias is not None:
        if key_bias.shape != (b, s):
            raise ValueError(f"{name}: key_bias must be (B, S)")
        _check_cuda(name, qkv.device, torch.float32, key_bias)


def _attention_fwd(qkv, num_heads, is_causal, sm_scale, key_bias) -> torch.Tensor:
    """Kernel #1 on CUDA, its plain version on the CPU."""
    if qkv.device.type == "cpu":
        return qkv_attention_plain(qkv, num_heads, is_causal, sm_scale, key_bias)
    if qkv.device.type != "cuda":
        raise ValueError(f"fused_qkv_attention: no kernel for {qkv.device}")
    _check_attention("fused_qkv_attention", qkv, num_heads, key_bias)
    b, s, three_d = qkv.shape
    out = torch.empty((b, s, three_d // 3), dtype=qkv.dtype, device=qkv.device)
    _attention_fwd_launch(qkv, num_heads, is_causal, sm_scale, key_bias, out)
    fused_qkv_attention.launches += 1
    return out


def _attention_fwd_launch(qkv, num_heads, is_causal, sm_scale, key_bias, out) -> None:
    """Launches kernel #1 into ``out`` ``(B, S, D)`` on operands that
    ``_check_attention`` accepted. ``_attention_fwd`` calls it with a fresh
    output; a check may pass its own, filled with NaN, so that an element
    the kernel leaves unwritten shows."""
    b, s, three_d = qkv.shape
    d = three_d // 3
    scale = sm_scale if sm_scale is not None else (d // num_heads) ** -0.5
    err = _kernels().mm_qkv_attention(
        qkv.data_ptr(), key_bias.data_ptr() if key_bias is not None else None,
        out.data_ptr(), b, s, d, num_heads, float(scale), int(is_causal),
        _DTYPE_CODES[qkv.dtype], _build.stream_of(qkv),
    )
    _build.raise_on(err, "fused_qkv_attention")


def fused_qkv_attention_bwd(
    qkv: torch.Tensor,
    g: torch.Tensor,
    num_heads: int,
    is_causal: bool = False,
    sm_scale: Optional[float] = None,
    key_bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``dqkv`` ``(B, S, 3D)`` of ``fused_qkv_attention`` given its output
    gradient ``g`` ``(B, S, D)``: kernel #2 on CUDA, its plain version on
    the CPU."""
    if qkv.device.type == "cpu":
        return qkv_attention_bwd_plain(qkv, g, num_heads, is_causal, sm_scale, key_bias)
    if qkv.device.type != "cuda":
        raise ValueError(f"fused_qkv_attention_bwd: no kernel for {qkv.device}")
    _check_attention("fused_qkv_attention_bwd", qkv, num_heads, key_bias)
    b, s, three_d = qkv.shape
    d = three_d // 3
    if g.shape != (b, s, d):
        raise ValueError(f"fused_qkv_attention_bwd: g must be {(b, s, d)}, got {tuple(g.shape)}")
    _check_cuda("fused_qkv_attention_bwd", qkv.device, qkv.dtype, g)
    dqkv = torch.empty_like(qkv)
    _attention_bwd_launch(qkv, g, num_heads, is_causal, sm_scale, key_bias, dqkv,
                          _attention_bwd_route(s, d // num_heads, qkv.dtype))
    fused_qkv_attention_bwd.launches += 1
    return dqkv


def _attention_bwd_launch(qkv, g, num_heads, is_causal, sm_scale, key_bias, dqkv,
                          route: int) -> None:
    """Kernel #2's launch alone, on the kernel ``route`` names, into
    ``dqkv`` (``qkv``'s shape, dtype and layout); checks
    ``fused_qkv_attention_bwd`` does not repeat."""
    b, s, three_d = qkv.shape
    d = three_d // 3
    if dqkv.shape != qkv.shape or dqkv.dtype != qkv.dtype or not dqkv.is_contiguous():
        raise ValueError("fused_qkv_attention_bwd: dqkv must be like qkv")
    scale = sm_scale if sm_scale is not None else (d // num_heads) ** -0.5
    err = _kernels().mm_qkv_attention_bwd(
        qkv.data_ptr(), g.data_ptr(),
        key_bias.data_ptr() if key_bias is not None else None, dqkv.data_ptr(),
        b, s, d, num_heads, float(scale), int(is_causal), _DTYPE_CODES[qkv.dtype], route,
        _build.stream_of(qkv),
    )
    _build.raise_on(err, "fused_qkv_attention_bwd")


class _QKVAttention(torch.autograd.Function):
    """Kernel #1 forward, kernel #2 backward (``_qkv_attn_fwd`` /
    ``_qkv_attn_bwd``): only ``qkv`` and ``key_bias`` are saved; the
    scores and probabilities are recomputed. ``key_bias`` is data and gets
    no gradient."""

    @staticmethod
    def forward(ctx, qkv, key_bias, num_heads, is_causal, sm_scale):
        ctx.save_for_backward(qkv, key_bias)
        ctx.args = (num_heads, is_causal, sm_scale)
        return _attention_fwd(qkv, num_heads, is_causal, sm_scale, key_bias)

    @staticmethod
    def backward(ctx, g):
        qkv, key_bias = ctx.saved_tensors
        dqkv = fused_qkv_attention_bwd(qkv, g.contiguous(), *ctx.args, key_bias)
        return dqkv, None, None, None, None


def fused_qkv_attention(
    qkv: torch.Tensor,
    num_heads: int,
    is_causal: bool = False,
    sm_scale: Optional[float] = None,
    key_bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Self-attention straight off the fused QKV projection, differentiable
    in ``qkv``.

    Args:
        qkv: ``(B, S, 3*D)``, laid out ``[q | k | v]`` along the last axis,
            heads contiguous within each part.
        key_bias: optional ``(B, S)`` fp32 additive key-padding bias
            (0 = attend, large negative = masked), added to every query row.
    Returns:
        ``(B, S, D)`` attention output in ``qkv``'s dtype.
    """
    return _QKVAttention.apply(qkv, key_bias, num_heads, is_causal, sm_scale)


fused_qkv_attention.launches = 0
fused_qkv_attention_bwd.launches = 0


def key_padding_bias(attn_mask: torch.Tensor, batch: int, seq: int) -> Optional[torch.Tensor]:
    """A broadcast key-padding mask, bool (True = attend) or additive float
    ``(b|1, 1, 1, S)`` as BERT-style towers build it, as the ``(B, S)`` fp32
    key-bias lane of ``fused_qkv_attention`` (masked keys at -1e30). None
    for a mask the kernel cannot express (per-query structure, per-head
    bias): the caller then keeps the split-head path. The bias is data and
    carries no gradient."""
    if (attn_mask.dim() != 4 or attn_mask.shape[1] != 1 or attn_mask.shape[2] != 1
            or attn_mask.shape[3] != seq):
        return None
    if attn_mask.dtype == torch.bool:
        kb = torch.where(attn_mask[:, 0, 0, :], 0.0, -1e30).to(torch.float32)
    elif attn_mask.is_floating_point():
        kb = attn_mask[:, 0, 0, :].to(torch.float32)
    else:
        return None
    if kb.shape[0] == 1 and batch > 1:
        kb = kb.expand(batch, seq)
    elif kb.shape[0] != batch:
        return None
    return kb.detach().contiguous()


# --------------------------------------------------------------------------
# fused MLP
# --------------------------------------------------------------------------


def mlp_plain(x, w1, b1, w2, b2, activation: str = "gelu") -> torch.Tensor:
    """Plain PyTorch version of the kernel (the TPU kernel's ``_mlp_kernel``,
    not its XLA fallback): fp32 sums and fp32 bias, activation in fp32, the
    intermediate rounded to the compute type before the second product."""
    act = _ACTIVATIONS[activation]
    h = x.float() @ w1.float() + b1.float()
    h = act(h).to(x.dtype)
    return (h.float() @ w2.float() + b2.float()).to(x.dtype)


def _act_and_grad(name: str, z: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp32 ``(act(z), act'(z))``: the analytic forms of the JAX package's
    ``_act_and_grad``, with ``torch.erf`` for ``gelu_exact``."""
    if name == "quick_gelu":
        s = torch.sigmoid(1.702 * z)
        return z * s, s * (1.0 + 1.702 * z * (1.0 - s))
    if name == "silu":
        s = torch.sigmoid(z)
        return z * s, s * (1.0 + z * (1.0 - s))
    if name == "relu":
        return torch.clamp_min(z, 0.0), (z > 0.0).to(z.dtype)
    if name == "gelu":  # tanh approximation
        c = 0.7978845608028654  # sqrt(2/pi)
        t = torch.tanh(c * (z + 0.044715 * z ** 3))
        du = c * (1.0 + 3 * 0.044715 * z * z)
        return 0.5 * z * (1.0 + t), 0.5 * (1.0 + t) + 0.5 * z * (1.0 - t * t) * du
    if name == "gelu_exact":
        erf = torch.erf(z * 2.0 ** -0.5)
        pdf = torch.exp(-0.5 * z * z) * 0.3989422804014327  # 1/sqrt(2*pi)
        return 0.5 * z * (1.0 + erf), 0.5 * (1.0 + erf) + z * pdf
    raise ValueError(f"unknown activation {name!r}")


def mlp_bwd_plain(x, g, w1, b1, w2, activation: str = "gelu"):
    """Plain PyTorch version of the backward kernel (the TPU kernel's
    ``_mlp_bwd_kernel``), on ``x`` ``(rows, Din)`` and ``g`` ``(rows, Dout)``:
    ``z = x W1 + b1`` in fp32, ``da = (g W2^T) act'(z)`` rounded to the
    compute type, ``dx = da W1^T``. Returns ``(dx, da, h)``, all in the
    compute type."""
    z = x.float() @ w1.float() + b1.float()
    h, dact = _act_and_grad(activation, z)
    da = ((g.float() @ w2.float().t()) * dact).to(x.dtype)
    dx = da.float() @ w1.float().t()
    return dx.to(x.dtype), da, h.to(x.dtype)


def mlp_bwd_acc_plain(x, g, w1, b1, w2, activation: str = "gelu"):
    """Plain PyTorch version of kernel #5 (the TPU kernel's
    ``_mlp_bwd_acc_kernel``), on ``x`` ``(rows, Din)`` and ``g``
    ``(rows, Dout)``: ``z = x W1 + b1`` and ``da = (g W2^T) act'(z)`` in
    fp32; ``dx = T(da) W1^T`` in the compute type T; in fp32 over all rows
    ``dW1 = x^T T(da)``, ``dW2 = T(act(z))^T g`` and ``db1`` the sum of the
    unrounded ``da`` (kernel #4's route sums the rounded one). Returns
    ``(dx, dw1, dw2, db1)``."""
    z = x.float() @ w1.float() + b1.float()
    h, dact = _act_and_grad(activation, z)
    da = (g.float() @ w2.float().t()) * dact
    da_c = da.to(x.dtype).float()
    dx = (da_c @ w1.float().t()).to(x.dtype)
    dw1 = x.float().t() @ da_c
    dw2 = h.to(x.dtype).float().t() @ g.float()
    return dx, dw1, dw2, da.sum(0)


def _check_mlp(name: str, x, w1, b1, w2, b2, activation: str) -> None:
    if activation not in _ACT_CODES:
        raise ValueError(f"{name}: unknown activation {activation!r}")
    din, dff = w1.shape
    dout = w2.shape[-1]
    if (x.shape[-1] != din or w2.shape != (dff, dout) or b1.shape != (dff,)
            or (b2 is not None and b2.shape != (dout,))):
        raise ValueError(f"{name}: inconsistent shapes")
    if din % 64 or dff % 64 or dout % 64:
        raise ValueError(
            f"{name}: no kernel for widths {din}->{dff}->{dout} "
            "(needs Din, Dff and Dout multiples of 64)"
        )
    # w1.t() / w2.t() are the row-major (Dff, Din) / (Dout, Dff) the kernels read
    _check_cuda(name, x.device, x.dtype, x, w1.t(), b1, w2.t(),
                *(() if b2 is None else (b2,)))


def _mlp_fwd_workspace(rows: int, dff: int, dtype: torch.dtype):
    """Shape of kernel #3's workspace for ``rows`` rows of ``dtype``: in
    bf16 h, ``(rows, Dff)`` of bf16, between its two GEMMs; fp32 has one
    kernel and none (None)."""
    return (rows, dff) if dtype == torch.bfloat16 else None


def _mlp_fwd(x, w1, b1, w2, b2, activation: str) -> torch.Tensor:
    """Kernel #3 on CUDA, its plain version on the CPU."""
    if activation not in _ACT_CODES:
        raise ValueError(f"fused_mlp: unknown activation {activation!r}")
    if x.device.type == "cpu":
        return mlp_plain(x, w1, b1, w2, b2, activation)
    if x.device.type != "cuda":
        raise ValueError(f"fused_mlp: no kernel for {x.device}")
    _check_mlp("fused_mlp", x, w1, b1, w2, b2, activation)
    rows = math.prod(x.shape[:-1])
    out = torch.empty((*x.shape[:-1], w2.shape[-1]), dtype=x.dtype, device=x.device)
    if rows == 0:
        return out
    ws_shape = _mlp_fwd_workspace(rows, w1.shape[1], x.dtype)
    # a fresh workspace each call (from the caching allocator), never a
    # buffer kept between calls: a recomputed forward (remat) gets its own
    ws = None if ws_shape is None else torch.empty(ws_shape, dtype=x.dtype, device=x.device)
    _mlp_fwd_launch(x, w1, b1, w2, b2, activation, out, ws)
    fused_mlp.launches += 1
    return out


def _mlp_fwd_launch(x, w1, b1, w2, b2, activation: str, out, ws) -> None:
    """Launches kernel #3 into ``out`` with ``ws`` as its workspace
    (``_mlp_fwd_workspace``'s shape, or None), on operands that
    ``_check_mlp`` accepted and at least one row. ``_mlp_fwd`` calls it with
    fresh tensors; a check may pass its own, filled with NaN, so that an
    element the kernel leaves unwritten shows."""
    din, dff = w1.shape
    err = _kernels().mm_fused_mlp(
        x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
        out.data_ptr(), None if ws is None else ws.data_ptr(), math.prod(x.shape[:-1]), din,
        dff, w2.shape[-1], _ACT_CODES[activation], _DTYPE_CODES[x.dtype], _build.stream_of(x),
    )
    _build.raise_on(err, "fused_mlp")


def fused_mlp_bwd(x, g, w1, b1, w2, activation: str = "gelu"):
    """Stage 1 of the MLP backward on ``x`` ``(rows, Din)`` and the output
    gradient ``g`` ``(rows, Dout)``: ``(dx, da, h)`` in the compute type.
    Kernel #4 on CUDA (in bf16 kernel #5's z/dh and dx stages, dx's product
    split over Dff at few rows: one launch counted), its plain version on
    the CPU."""
    if activation not in _ACT_CODES:
        raise ValueError(f"fused_mlp_bwd: unknown activation {activation!r}")
    if x.device.type == "cpu":
        return mlp_bwd_plain(x, g, w1, b1, w2, activation)
    if x.device.type != "cuda":
        raise ValueError(f"fused_mlp_bwd: no kernel for {x.device}")
    _check_mlp("fused_mlp_bwd", x, w1, b1, w2, None, activation)
    rows, din = x.shape
    dff, dout = w2.shape
    if g.shape != (rows, dout):
        raise ValueError(f"fused_mlp_bwd: g must be {(rows, dout)}, got {tuple(g.shape)}")
    _check_cuda("fused_mlp_bwd", x.device, x.dtype, g)
    dx = torch.empty_like(x)
    da = torch.empty((rows, dff), dtype=x.dtype, device=x.device)
    h = torch.empty_like(da)
    if rows == 0:
        return dx, da, h
    ws_shape = _mlp_bwd_workspace(rows, din, dff, x.dtype)
    part = None if ws_shape is None else torch.empty(ws_shape, dtype=torch.float32,
                                                      device=x.device)
    _mlp_bwd_launch(x, g, w1, b1, w2, activation, dx, da, h, part)
    fused_mlp_bwd.launches += 1
    return dx, da, h


def _mlp_bwd_launch(x, g, w1, b1, w2, activation: str, dx, da, h, part) -> None:
    """Launches kernel #4 into ``dx``, ``da`` and ``h`` with ``part`` as its
    workspace (``_mlp_bwd_workspace``'s shape, or None), on operands that
    ``fused_mlp_bwd`` accepted and at least one row. A check may pass its
    own outputs and workspace, filled with NaN, so that an element the
    kernel leaves unwritten shows."""
    rows, din = x.shape
    dff, dout = w2.shape
    splits = 1 if part is None else part.shape[0]
    err = _kernels().mm_fused_mlp_bwd(
        x.data_ptr(), g.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
        dx.data_ptr(), da.data_ptr(), h.data_ptr(), None if part is None else part.data_ptr(),
        rows, din, dff, dout, splits, _ACT_CODES[activation], _DTYPE_CODES[x.dtype],
        _build.stream_of(x),
    )
    _build.raise_on(err, "fused_mlp_bwd")


def fused_mlp_bwd_acc(x, g, w1, b1, w2, activation: str = "gelu"):
    """The MLP backward with its weight gradients on ``x`` ``(rows, Din)``
    and the output gradient ``g`` ``(rows, Dout)``: ``(dx, dw1, dw2, db1)``,
    ``dx`` in the compute type, the others fp32. ``dw1`` ``(Din, Dff)`` and
    ``dw2`` ``(Dff, Dout)`` are views whose ``.t()`` is contiguous. Kernel
    #5 on CUDA (its z/dh, dx and dW stages and the fixed-order sum: one
    launch counted), its plain version on the CPU.

    On CUDA it allocates a workspace: da_c and h_c, ``2 x (rows, Dff)`` of
    the compute type (805 MB in bf16 at the LM step's 65,536 rows of Dff
    3072), and the fp32 partials of the dW runs and of db1."""
    if activation not in _ACT_CODES:
        raise ValueError(f"fused_mlp_bwd_acc: unknown activation {activation!r}")
    if x.device.type == "cpu":
        return mlp_bwd_acc_plain(x, g, w1, b1, w2, activation)
    if x.device.type != "cuda":
        raise ValueError(f"fused_mlp_bwd_acc: no kernel for {x.device}")
    _check_mlp("fused_mlp_bwd_acc", x, w1, b1, w2, None, activation)
    rows, din = x.shape
    dff, dout = w2.shape
    if g.shape != (rows, dout):
        raise ValueError(f"fused_mlp_bwd_acc: g must be {(rows, dout)}, got {tuple(g.shape)}")
    _check_cuda("fused_mlp_bwd_acc", x.device, x.dtype, g)
    n1, n2 = dff * din, dout * dff
    out = torch.empty(n1 + n2 + dff, dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)
    if rows == 0:
        out.zero_()
    else:
        splits = _acc_splits(rows, din, dff, dout)
        dah = torch.empty((2, rows, dff), dtype=x.dtype, device=x.device)
        part = torch.empty((splits * (n1 + n2) if splits > 1 else 0)
                           + -(-rows // _ACC_TILE) * dff, dtype=torch.float32, device=x.device)
        err = _kernels().mm_fused_mlp_bwd_acc(
            x.data_ptr(), g.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
            dx.data_ptr(), dah.data_ptr(), part.data_ptr(), out.data_ptr(), rows, din, dff,
            dout, splits, _ACT_CODES[activation], _DTYPE_CODES[x.dtype], _build.stream_of(x),
        )
        _build.raise_on(err, "fused_mlp_bwd_acc")
        fused_mlp_bwd_acc.launches += 1
    return (dx, out[:n1].view(dff, din).t(), out[n1:n1 + n2].view(dout, dff).t(),
            out[n1 + n2:])


class _MLP(torch.autograd.Function):
    """Kernel #3 forward; the backward follows ``_mlp_bwd``'s order: kernel
    #5 where ``fused_mlp_bwd_acc_supported`` holds (dW and db from the
    kernel), else kernel #4 with the weight and bias gradients as plain
    large products and sums over ``da``, ``h`` and ``g`` outside the
    kernel. fp32 accumulation; each gradient is returned in its input's
    dtype and shape."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, activation):
        ctx.save_for_backward(x, w1, b1, w2)
        ctx.activation = activation
        ctx.b2_dtype = b2.dtype
        return _mlp_fwd(x, w1, b1, w2, b2, activation)

    @staticmethod
    def backward(ctx, g):
        x, w1, b1, w2 = ctx.saved_tensors
        x2 = x.reshape(-1, x.shape[-1])
        g2 = g.reshape(-1, g.shape[-1]).contiguous()
        db2 = g2.sum(0, dtype=torch.float32).to(ctx.b2_dtype)
        if fused_mlp_bwd_acc_supported(x2.shape[0], *w1.shape, w2.shape[1]):
            dx, dw1, dw2, db1 = fused_mlp_bwd_acc(x2, g2, w1, b1, w2, ctx.activation)
            return (dx.reshape(x.shape), dw1.to(w1.dtype), db1.to(b1.dtype),
                    dw2.to(w2.dtype), db2, None)
        dx, da, h = fused_mlp_bwd(x2, g2, w1, b1, w2, ctx.activation)
        # (Dff, Din) and (Dout, Dff) products, handed back as the (Din, Dff)
        # and (Dff, Dout) views: nn.Linear's weights get contiguous grads.
        dw1 = torch.matmul(da.t(), x2).t() if ctx.needs_input_grad[1] else None
        dw2 = torch.matmul(g2.t(), h).t() if ctx.needs_input_grad[3] else None
        # fp32 accumulation without an fp32 copy of the (rows, Dff) da
        db1 = da.sum(0, dtype=torch.float32).to(b1.dtype)
        return dx.reshape(x.shape), dw1, db1, dw2, db2, None


def fused_mlp(x, w1, b1, w2, b2, activation: str = "gelu") -> torch.Tensor:
    """``act(x @ w1 + b1) @ w2 + b2``, differentiable in every operand. All
    operands share the compute dtype; ``x`` is ``(..., Din)``, ``w1``
    ``(Din, Dff)``, ``w2`` ``(Dff, Dout)``. ``activation`` is one of
    quick_gelu, gelu (tanh form), gelu_exact, relu and silu. On CUDA the
    weights must be column-major (``w1.t()`` and ``w2.t()`` contiguous), as
    ``nn.Linear`` weights transposed are."""
    return _MLP.apply(x, w1, b1, w2, b2, activation)


fused_mlp.launches = 0
fused_mlp_bwd.launches = 0
fused_mlp_bwd_acc.launches = 0


def reset_launch_counts() -> None:
    fused_qkv_attention.launches = 0
    fused_qkv_attention_bwd.launches = 0
    fused_mlp.launches = 0
    fused_mlp_bwd.launches = 0
    fused_mlp_bwd_acc.launches = 0

"""Fused encoder-block kernels: attention off the fused QKV projection, and
the two-layer MLP with its intermediate kept on chip.

Counterpart of ``multimodal_tpu/ops/fused_encoder.py``. Each function here
takes the JAX function's layouts:

- ``fused_qkv_attention``: ``qkv`` is ``(B, S, 3D)`` laid out ``[q | k | v]``
  with heads contiguous; the output is ``(B, S, D)``.
- ``fused_mlp``: ``x`` is ``(..., Din)``, weights ``(Din, Dff)`` and
  ``(Dff, Dout)``. The kernel reads the weights column-major, as
  ``linear.weight.t()`` of an ``nn.Linear`` gives them, so the layer passes
  its weights without a copy.

On a CUDA tensor each wrapper launches its hand-written kernel
(``csrc/fused_qkv_attention.cu``, ``csrc/fused_mlp.cu``) or raises; it never
falls back. On a CPU tensor it runs the plain PyTorch version, which follows
the TPU kernel body's arithmetic (where it rounds to the compute type and
where it stays in fp32). Each wrapper counts its kernel launches in its
``launches`` attribute.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from multimodal_tpu_torch.ops import _build

_SMEM_LIMIT = 232_448  # bytes of shared memory a block may use on sm_90
_MAX_SEQ = 256         # score row kept in registers: 8 values per lane
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# Activation codes of csrc/fused_mlp.cu's `act` template.
_ACT_CODES = {"quick_gelu": 0, "gelu": 1, "gelu_exact": 2, "relu": 3, "silu": 4}
_ACTIVATIONS = {
    "quick_gelu": lambda z: z * torch.sigmoid(1.702 * z),
    "gelu": lambda z: torch.nn.functional.gelu(z, approximate="tanh"),
    "gelu_exact": lambda z: 0.5 * z * (1.0 + torch.erf(z * 2.0 ** -0.5)),
    "relu": torch.relu,
    "silu": torch.nn.functional.silu,
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
        lib.mm_fused_mlp.argtypes = [
            _V, _V, _V, _V, _V, _V, _I, _I, _I, _I, _I, _I, _V]
        lib.mm_fused_mlp.restype = _I
        _lib = lib
    return _lib


def _attention_smem_bytes(seq: int, head_dim: int) -> int:
    """Mirror of ``smem_floats`` in csrc/fused_qkv_attention.cu: K^T and V
    of one head in fp32, plus per-warp q rows and probability rows."""
    sp = -(-seq // 32) * 32
    warps, rows = 8, 4
    return 4 * (head_dim * (sp + 1) + seq * head_dim
                + warps * rows * head_dim + warps * sp * rows)


def fused_attention_supported(seq: int, embed_dim: int, num_heads: int) -> bool:
    """Shape predicate of the attention kernel: a clean head split with
    ``head_dim % 8 == 0`` and ``<= 128``, ``seq <= 256``, and one head's K and
    V (fp32) plus the warps' row buffers within a block's shared memory."""
    if num_heads <= 0 or embed_dim % num_heads:
        return False
    dh = embed_dim // num_heads
    if dh % 8 or dh > 128 or not 0 < seq <= _MAX_SEQ:
        return False
    return _attention_smem_bytes(seq, dh) <= _SMEM_LIMIT


def _check_no_grad(*tensors: Optional[torch.Tensor]) -> None:
    if torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors
    ):
        raise RuntimeError(
            "the CUDA kernel has no backward yet; call it under "
            "torch.no_grad() or torch.inference_mode()"
        )


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


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


# --------------------------------------------------------------------------
# fused QKV self-attention
# --------------------------------------------------------------------------


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
    dh = d // num_heads
    scale = sm_scale if sm_scale is not None else dh ** -0.5
    q, k, v = (
        t.reshape(b, s, num_heads, dh).transpose(1, 2)
        for t in qkv.split(d, dim=-1)
    )
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if key_bias is not None:
        logits = logits + key_bias.float()[:, None, None, :]
    if is_causal:
        keep = torch.ones(s, s, dtype=torch.bool, device=qkv.device).tril()
        logits = logits.masked_fill(~keep, -1e30)
    p = torch.softmax(logits, dim=-1).to(qkv.dtype).float()
    o = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    return o.transpose(1, 2).reshape(b, s, d).to(qkv.dtype)


def fused_qkv_attention(
    qkv: torch.Tensor,
    num_heads: int,
    is_causal: bool = False,
    sm_scale: Optional[float] = None,
    key_bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Self-attention straight off the fused QKV projection.

    Args:
        qkv: ``(B, S, 3*D)``, laid out ``[q | k | v]`` along the last axis,
            heads contiguous within each part.
        key_bias: optional ``(B, S)`` fp32 additive key-padding bias
            (0 = attend, large negative = masked), added to every query row.
    Returns:
        ``(B, S, D)`` attention output in ``qkv``'s dtype.
    """
    if qkv.device.type == "cpu":
        return qkv_attention_plain(qkv, num_heads, is_causal, sm_scale, key_bias)
    if qkv.device.type != "cuda":
        raise ValueError(f"fused_qkv_attention: no kernel for {qkv.device}")
    if qkv.dim() != 3 or qkv.shape[-1] % 3:
        raise ValueError(f"fused_qkv_attention: qkv must be (B, S, 3D), got {tuple(qkv.shape)}")
    b, s, three_d = qkv.shape
    d = three_d // 3
    if not fused_attention_supported(s, d, num_heads):
        raise ValueError(
            f"fused_qkv_attention: no kernel for seq={s}, embed_dim={d}, "
            f"num_heads={num_heads}"
        )
    _check_no_grad(qkv)
    _check_cuda("fused_qkv_attention", qkv.device, qkv.dtype, qkv)
    if key_bias is not None:
        if key_bias.shape != (b, s):
            raise ValueError("fused_qkv_attention: key_bias must be (B, S)")
        _check_cuda("fused_qkv_attention", qkv.device, torch.float32, key_bias)
    scale = sm_scale if sm_scale is not None else (d // num_heads) ** -0.5
    out = torch.empty((b, s, d), dtype=qkv.dtype, device=qkv.device)
    err = _kernels().mm_qkv_attention(
        qkv.data_ptr(), key_bias.data_ptr() if key_bias is not None else None,
        out.data_ptr(), b, s, d, num_heads, float(scale), int(is_causal),
        _DTYPE_CODES[qkv.dtype], torch.cuda.current_stream(qkv.device).cuda_stream,
    )
    _raise_on(err, "fused_qkv_attention")
    fused_qkv_attention.launches += 1
    return out


fused_qkv_attention.launches = 0


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


def fused_mlp(x, w1, b1, w2, b2, activation: str = "gelu") -> torch.Tensor:
    """``act(x @ w1 + b1) @ w2 + b2`` with the ``(rows, Dff)`` intermediate
    kept on chip. All operands share the compute dtype; ``x`` is
    ``(..., Din)``, ``w1`` ``(Din, Dff)``, ``w2`` ``(Dff, Dout)``.
    ``activation`` is one of quick_gelu, gelu (tanh form), gelu_exact, relu
    and silu. On CUDA the weights must be column-major (``w1.t()`` and
    ``w2.t()`` contiguous), as ``nn.Linear`` weights transposed are."""
    if activation not in _ACT_CODES:
        raise ValueError(f"fused_mlp: unknown activation {activation!r}")
    if x.device.type == "cpu":
        return mlp_plain(x, w1, b1, w2, b2, activation)
    if x.device.type != "cuda":
        raise ValueError(f"fused_mlp: no kernel for {x.device}")
    din, dff = w1.shape
    dout = w2.shape[-1]
    if (x.shape[-1] != din or w2.shape != (dff, dout) or b1.shape != (dff,)
            or b2.shape != (dout,)):
        raise ValueError("fused_mlp: inconsistent shapes")
    if din % 64 or dff % 64 or dout % 64:
        raise ValueError(
            f"fused_mlp: no kernel for widths {din}->{dff}->{dout} "
            "(needs Din, Dff and Dout multiples of 64)"
        )
    _check_no_grad(x, w1, b1, w2, b2)
    # w1.t() / w2.t() are the row-major (Dff, Din) / (Dout, Dff) the kernel reads
    _check_cuda("fused_mlp", x.device, x.dtype, x, w1.t(), b1, w2.t(), b2)
    rows = math.prod(x.shape[:-1])
    out = torch.empty((*x.shape[:-1], dout), dtype=x.dtype, device=x.device)
    if rows == 0:
        return out
    err = _kernels().mm_fused_mlp(
        x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
        out.data_ptr(), rows, din, dff, dout, _ACT_CODES[activation],
        _DTYPE_CODES[x.dtype], torch.cuda.current_stream(x.device).cuda_stream,
    )
    _raise_on(err, "fused_mlp")
    fused_mlp.launches += 1
    return out


fused_mlp.launches = 0


def reset_launch_counts() -> None:
    fused_qkv_attention.launches = 0
    fused_mlp.launches = 0

"""Flash attention forward: blockwise online softmax, the ``(Sq, Sk)``
scores never in device memory.

Counterpart of ``multimodal_tpu/ops/flash_attention.py``, forward only.
Layout: ``q (B, H, Sq, D)``, ``k``/``v`` ``(B, H, Sk, D)``. Masking, all of
which composes:

- ``causal``: bottom-right aligned, query ``i`` sees key ``j`` iff
  ``j <= i + Sk - Sq``; key tiles wholly above the diagonal are skipped.
- ``q_segment_ids`` / ``kv_segment_ids`` (``(B, Sq)`` / ``(B, Sk)``
  integers): positions attend iff their ids match.
- ``bias``: an additive float bias broadcastable to ``(B, H, Sq, Sk)``
  (ALiBi-style ``(1, H, 1, Sk)``, per-batch ``(B, 1, Sq, Sk)``), read at its
  broadcast shape: the kernel takes its strides, 0 on the size-1 dims.

With ``return_lse`` the per-row logsumexp in log2 space (``(B, H, Sq)``
fp32) comes back too, for the backward and lse merges. A row that sees no
key returns 0 and lse ``-inf`` (the TPU kernel, masking with ``-1e30``,
returns there the mean of V over whatever its padded block held).

On a CUDA tensor ``flash_attention_forward`` launches
``csrc/flash_attention_fwd.cu`` or raises; on a CPU tensor it runs
:func:`flash_attention_plain`, the same arithmetic in one pass: log2-space
fp32 scores, the probabilities rounded to the compute type before ``p . v``,
the row sums in fp32. It counts launches in
``flash_attention_forward.launches``.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from multimodal_tpu_torch.ops import _build

LOG2E = 1.4426950408889634
DEFAULT_MASK_VALUE = -1e30
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_V = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_lib: Optional[ctypes.CDLL] = None


def _kernels() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load_library()
        lib.mm_flash_attention_fwd.argtypes = [
            _V, _V, _V, _V, _V, _V, _V, _V, _V, _V, _V, _L, _V, _L, _V,
            _I, _I, _I, _I, _I, ctypes.c_float, _I, _I, _V]
        lib.mm_flash_attention_fwd.restype = _I
        _lib = lib
    return _lib


def _as_4d_bias(bias: torch.Tensor) -> torch.Tensor:
    if bias.dim() > 4:
        raise ValueError(f"bias must be broadcastable to 4-d, got {tuple(bias.shape)}")
    return bias.reshape((1,) * (4 - bias.dim()) + tuple(bias.shape)).float()


def flash_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    *,
    causal: bool = False,
    sm_scale: Optional[float] = None,
    return_lse: bool = False,
    q_segment_ids: Optional[torch.Tensor] = None,
    kv_segment_ids: Optional[torch.Tensor] = None,
):
    """Plain PyTorch version of the kernel (the TPU kernel's
    ``_flash_kernel``), the whole row at once."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    scale = sm_scale if sm_scale is not None else d ** -0.5
    s2 = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * (scale * LOG2E)
    if bias is not None:
        s2 = s2 + _as_4d_bias(bias) * LOG2E
    visible = torch.ones(sq, sk, dtype=torch.bool, device=q.device)
    if causal:
        visible = visible.tril(sk - sq)
    visible = visible[None, None]
    if q_segment_ids is not None:
        visible = visible & (q_segment_ids[:, None, :, None] == kv_segment_ids[:, None, None, :])
    s2 = s2.masked_fill(~visible, -math.inf)
    m = s2.amax(dim=-1, keepdim=True)
    m = torch.where(m == -math.inf, 0.0, m)  # a row that sees no key: p = 0
    p = torch.exp2(s2 - m)
    lsum = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhqk,bhkd->bhqd", p.to(q.dtype).float(), v.float())
    o = (o / torch.where(lsum == 0, 1.0, lsum)).to(q.dtype)
    if not return_lse:
        return o
    lse = torch.where(lsum == 0, -math.inf, m + torch.log2(lsum))[..., 0]
    return o, lse


def _check(q, k, v, bias, q_segment_ids, kv_segment_ids) -> None:
    name = "flash_attention_forward"
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name}: dtype {q.dtype} not supported (fp32 or bf16)")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"{name}: q (B,H,Sq,D), k and v (B,H,Sk,D), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, h, sq, d = q.shape
    if k.shape[:2] != (b, h) or k.shape[3] != d:
        raise ValueError(f"{name}: k {tuple(k.shape)} does not fit q {tuple(q.shape)}")
    if d % 8 or d > 128:
        raise ValueError(f"{name}: no kernel for head width {d} (a multiple of 8, <= 128)")
    align = 16 // q.element_size()
    for t in (q, k, v):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"{name}: q, k and v must share device and dtype")
        if t.stride(-1) != 1 or any(st % align for st in t.stride()[:3]) or t.data_ptr() % 16:
            raise ValueError(f"{name}: rows must be contiguous and 16-byte aligned")
    if bias is not None and bias.device != q.device:
        raise ValueError(f"{name}: bias on {bias.device}, q on {q.device}")
    for ids in (q_segment_ids, kv_segment_ids):
        if ids is not None and ids.device != q.device:
            raise ValueError(f"{name}: segment ids on {ids.device}, q on {q.device}")


def flash_attention_forward(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    *,
    causal: bool = False,
    sm_scale: Optional[float] = None,
    return_lse: bool = False,
    q_segment_ids: Optional[torch.Tensor] = None,
    kv_segment_ids: Optional[torch.Tensor] = None,
):
    """Blockwise fused attention. Returns ``(B, H, Sq, D)`` in ``q``'s
    dtype, and with ``return_lse`` also the log2-space logsumexp
    ``(B, H, Sq)`` fp32. ``q``, ``k`` and ``v`` may be strided views (the
    head split of a ``(B, S, H*D)`` projection) as long as their last
    dimension is contiguous; the output's storage is ``(B, Sq, H, D)``, so
    merging its heads is a view."""
    if (q_segment_ids is None) != (kv_segment_ids is None):
        raise ValueError("pass both q_segment_ids and kv_segment_ids or neither")
    if q.device.type == "cpu":
        return flash_attention_plain(
            q, k, v, bias, causal=causal, sm_scale=sm_scale, return_lse=return_lse,
            q_segment_ids=q_segment_ids, kv_segment_ids=kv_segment_ids)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_forward: no kernel for {q.device}")
    _check(q, k, v, bias, q_segment_ids, kv_segment_ids)
    b, h, sq, d = q.shape
    sk = k.shape[2]
    scale = sm_scale if sm_scale is not None else d ** -0.5
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device).transpose(1, 2)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device) if return_lse else None
    bias_ptr, bias_strides = None, None
    if bias is not None:
        bias = _as_4d_bias(bias)
        bias_strides = _build.int64s(*bias.expand(b, h, sq, sk).stride())
        bias_ptr = bias.data_ptr()
    qseg = kvseg = None
    qseg_b = kvseg_b = 0
    if q_segment_ids is not None:
        qseg = q_segment_ids.to(torch.int32).expand(b, sq).contiguous()
        kvseg = kv_segment_ids.to(torch.int32).expand(b, sk).contiguous()
        qseg_b, kvseg_b = sq, sk
    err = _kernels().mm_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        _build.int64s(*q.stride()[:3]), _build.int64s(*k.stride()[:3]),
        _build.int64s(*v.stride()[:3]), _build.int64s(*out.stride()[:3]),
        bias_ptr, bias_strides,
        None if qseg is None else qseg.data_ptr(), qseg_b,
        None if kvseg is None else kvseg.data_ptr(), kvseg_b,
        None if lse is None else lse.data_ptr(),
        b, h, sq, sk, d, float(scale), int(causal), _DTYPE_CODES[q.dtype], _build.stream_of(q),
    )
    _build.raise_on(err, "flash_attention_forward")
    flash_attention_forward.launches += 1
    return (out, lse) if return_lse else out


flash_attention_forward.launches = 0


class _FlashAttention(torch.autograd.Function):
    """Kernel #6 forward. The blockwise backward (the TPU kernels
    ``_bwd_dq_kernel``, ``_bwd_dkv_kernel`` and ``_bwd_dbias_kernel``) is not
    ported yet: it is the LM-training slice of ROADMAP.md (queue B, #7-#9)."""

    @staticmethod
    def forward(ctx, q, k, v, bias, causal, sm_scale, q_segment_ids, kv_segment_ids):
        return flash_attention_forward(q, k, v, bias, causal=causal, sm_scale=sm_scale,
                                       q_segment_ids=q_segment_ids,
                                       kv_segment_ids=kv_segment_ids)

    @staticmethod
    def backward(ctx, g):
        raise NotImplementedError(
            "flash_attention has no backward yet: kernels #7-#9 (the blockwise dq, "
            "dk/dv and dbias kernels) come with the LM-training slice (ROADMAP.md, queue B)"
        )


def flash_attention(q, k, v, bias=None, causal: bool = False, sm_scale: Optional[float] = None,
                    q_segment_ids=None, kv_segment_ids=None) -> torch.Tensor:
    """Fused attention as an autograd Function: kernel #6 forward; its
    backward raises until the LM-training slice ports #7-#9."""
    return _FlashAttention.apply(q, k, v, bias, causal, sm_scale, q_segment_ids,
                                 kv_segment_ids)


def reset_launch_counts() -> None:
    flash_attention_forward.launches = 0

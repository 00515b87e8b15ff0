"""Flash attention, forward and backward: blockwise, the ``(Sq, Sk)``
scores never in device memory (except the bias gradient, which is that
matrix).

Counterpart of ``multimodal_tpu/ops/flash_attention.py``. Layout: ``q (B, H,
Sq, D)``, ``k``/``v`` ``(B, H, Sk, D)``. Masking, all of which composes:

- ``causal``: bottom-right aligned, query ``i`` sees key ``j`` iff
  ``j <= i + Sk - Sq``; key tiles wholly above the diagonal are skipped.
- ``q_segment_ids`` / ``kv_segment_ids`` (``(B, Sq)`` / ``(B, Sk)``
  integers): positions attend iff their ids match.
- ``bias``: an additive float bias broadcastable to ``(B, H, Sq, Sk)``
  (ALiBi-style ``(1, H, 1, Sk)``, per-batch ``(B, 1, Sq, Sk)``), read at its
  broadcast shape: the kernels take its strides, 0 on the size-1 dims.

With ``return_lse`` the per-row logsumexp in log2 space (``(B, H, Sq)``
fp32) comes back too, for the backward and lse merges. A row that sees no
key returns 0 and lse ``-inf`` (the TPU kernel, masking with ``-1e30``,
returns there the mean of V over whatever its padded block held).

The backward (the TPU's ``_flash_backward``) recomputes the probabilities
blockwise from ``q``, ``k`` and the forward's lse: ``p = exp2(s2 - lse)``
(0 where a pair is not visible or the row's lse is ``-inf``), ``dp = do .
v^T``, ``ds = p (dp - delta)`` with ``delta = rowsum(do * o)`` in fp32, then
``dq = ds k scale``, ``dk = ds^T q scale`` and ``dv = p^T do`` (the TPU's
kernels #7 and #8, here one call), and, only when the caller
differentiates the bias, ``ds`` itself as the fp32 ``(B, H, Sq, Sk)`` bias
gradient (kernel #9), summed back to the bias's shape. ``ds`` is rounded to
the inputs' dtype before its products and ``p`` to ``do``'s before ``p^T
do``; the sums are fp32.

On a CUDA tensor each wrapper (``flash_attention_forward``,
``flash_attention_bwd``, ``flash_attention_bwd_dbias``) launches its
kernels in ``csrc/flash_attention_{fwd,bwd}.cu`` or raises, and counts its
calls in its ``launches``; on a CPU tensor it runs its part of the plain
versions (:func:`flash_attention_plain`, :func:`flash_attention_bwd_plain`),
the same arithmetic a whole row at a time. In bf16 at head widths 64 and
96 both directions run `wgmma` kernels fed by TMA (the forward also with a
bias): the forward keeps the probabilities in registers between its two
products; ``flash_attention_bwd`` is one pass over each key block that adds
dq into an fp32 workspace, in no fixed order: its dq is not bitwise
repeatable from call to call, its dk and dv are.
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
        lib.mm_flash_attention_fwd_route.argtypes = [_I, _I]
        lib.mm_flash_attention_fwd_route.restype = _I
        lib.mm_flash_attention_bwd.argtypes = [
            _V, _V, _V, _V, _V, _V, _V, _V, _V, _V, _V, _V, _V, _L, _V, _L, _V, _V,
            _I, _I, _I, _I, _I, ctypes.c_float, _I, _I, _V]
        lib.mm_flash_attention_bwd.restype = _I
        lib.mm_flash_attention_bwd_dbias.argtypes = [
            _V, _V, _V, _V, _V, _L, _V, _V, _V, _V, _L, _V, _L, _V, _V,
            _I, _I, _I, _I, _I, ctypes.c_float, _I, _I, _V]
        lib.mm_flash_attention_bwd_dbias.restype = _I
        lib.mm_flash_attention_bwd_route.argtypes = [_I, _I]
        lib.mm_flash_attention_bwd_route.restype = _I
        _lib = lib
    return _lib


def _as_4d_bias(bias: torch.Tensor) -> torch.Tensor:
    if bias.dim() > 4:
        raise ValueError(f"bias must be broadcastable to 4-d, got {tuple(bias.shape)}")
    return bias.reshape((1,) * (4 - bias.dim()) + tuple(bias.shape)).float()


def _acc(t: torch.Tensor) -> torch.dtype:
    """The plain versions' accumulation type: fp32 for fp32 and bf16 inputs
    (the kernels' arithmetic), float64 for float64 ones (a reference)."""
    return torch.promote_types(t.dtype, torch.float32)


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
    ``_flash_kernel``), the whole row at once; in float64 throughout when
    ``q``, ``k`` and ``v`` are float64."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    acc = _acc(q)
    scale = sm_scale if sm_scale is not None else d ** -0.5
    s2 = torch.einsum("bhqd,bhkd->bhqk", q.to(acc), k.to(acc)) * (scale * LOG2E)
    if bias is not None:
        s2 = s2 + _as_4d_bias(bias) * LOG2E
    visible = _visible(sq, sk, causal, q_segment_ids, kv_segment_ids, q.device)
    s2 = s2.masked_fill(~visible, -math.inf)
    m = s2.amax(dim=-1, keepdim=True)
    m = torch.where(m == -math.inf, 0.0, m)  # a row that sees no key: p = 0
    p = torch.exp2(s2 - m)
    lsum = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhqk,bhkd->bhqd", p.to(q.dtype).to(acc), v.to(acc))
    o = (o / torch.where(lsum == 0, 1.0, lsum)).to(q.dtype)
    if not return_lse:
        return o
    lse = torch.where(lsum == 0, -math.inf, m + torch.log2(lsum))[..., 0]
    return o, lse


def _rows_ok(t: torch.Tensor) -> bool:
    """Whether the kernels can read ``t``'s rows: the last dimension
    contiguous, rows 16-byte aligned."""
    align = 16 // t.element_size()
    return t.stride(-1) == 1 and not any(st % align for st in t.stride()[:3]) \
        and t.data_ptr() % 16 == 0


def _check(q, k, v, bias, q_segment_ids, kv_segment_ids,
           name: str = "flash_attention_forward") -> None:
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
    for t in (q, k, v):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"{name}: q, k and v must share device and dtype")
        if not _rows_ok(t):
            raise ValueError(f"{name}: rows must be contiguous and 16-byte aligned")
    if bias is not None and bias.device != q.device:
        raise ValueError(f"{name}: bias on {bias.device}, q on {q.device}")
    for ids in (q_segment_ids, kv_segment_ids):
        if ids is not None and ids.device != q.device:
            raise ValueError(f"{name}: segment ids on {ids.device}, q on {q.device}")


_WG_KEYS = 128  # keys a tile of the forward's `wgmma` kernel holds


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
    out = _grad_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device) if return_lse else None
    _flash_fwd_launch(q, k, v, bias, out, lse, causal=causal, sm_scale=sm_scale,
                      q_segment_ids=q_segment_ids, kv_segment_ids=kv_segment_ids)
    flash_attention_forward.launches += 1
    return (out, lse) if return_lse else out


def _flash_fwd_launch(q, k, v, bias, out, lse, *, causal: bool, sm_scale: Optional[float],
                      q_segment_ids=None, kv_segment_ids=None) -> None:
    """Launches kernel #6 into ``out`` (q's shape and dtype, 16-byte aligned
    rows) and, unless None, ``lse`` (contiguous fp32 ``(B, H, Sq)``), on
    operands that ``_check`` accepted. Counts nothing:
    :func:`flash_attention_forward` is the counted entry point; a check may
    pass outputs filled with NaN, so that an element the kernel leaves
    unwritten shows."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if out.shape != q.shape or out.dtype != q.dtype or not _rows_ok(out) or (
            lse is not None and (lse.shape != (b, h, sq) or lse.dtype != torch.float32
                                 or not lse.is_contiguous())):
        raise ValueError("flash_attention_forward: out must match q with 16-byte aligned "
                         "rows, lse be contiguous fp32 (B, H, Sq)")
    bias_ptr, bias_strides = None, None
    if bias is not None:
        bias = _as_4d_bias(bias)
        bias_strides = _build.int64s(*bias.expand(b, h, sq, sk).stride())
        bias_ptr = bias.data_ptr()
    qseg = kvseg = None
    qseg_b = kvseg_b = 0
    if q_segment_ids is not None:
        qseg = q_segment_ids.to(torch.int32).expand(b, sq).contiguous()
        qseg_b = sq
        if q.dtype == torch.bfloat16 and d == 32:
            # key ids in rows of whole 128-key tiles (zeros past Sk): the
            # `wgmma` kernel at head width 32 copies a tile's ids with its K and V
            kvseg_b = -(-sk // _WG_KEYS) * _WG_KEYS
            kvseg = torch.zeros((b, kvseg_b), dtype=torch.int32, device=q.device)
            kvseg[:, :sk] = kv_segment_ids.to(torch.int32).expand(b, sk)
        else:
            kvseg = kv_segment_ids.to(torch.int32).expand(b, sk).contiguous()
            kvseg_b = sk
    err = _kernels().mm_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        _build.int64s(*q.stride()[:3]), _build.int64s(*k.stride()[:3]),
        _build.int64s(*v.stride()[:3]), _build.int64s(*out.stride()[:3]),
        bias_ptr, bias_strides,
        None if qseg is None else qseg.data_ptr(), qseg_b,
        None if kvseg is None else kvseg.data_ptr(), kvseg_b,
        None if lse is None else lse.data_ptr(),
        b, h, sq, sk, d, _scale(q, sm_scale), int(causal), _DTYPE_CODES[q.dtype],
        _build.stream_of(q),
    )
    _build.raise_on(err, "flash_attention_forward")


flash_attention_forward.launches = 0


def _visible(sq: int, sk: int, causal: bool, q_segment_ids, kv_segment_ids, device):
    """Bool ``(1 or B, 1, Sq, Sk)``: which (query, key) pairs attend."""
    visible = torch.ones(sq, sk, dtype=torch.bool, device=device)
    if causal:
        visible = visible.tril(sk - sq)
    visible = visible[None, None]
    if q_segment_ids is not None:
        visible = visible & (q_segment_ids[:, None, :, None] == kv_segment_ids[:, None, None, :])
    return visible


def _bwd_plain_parts(q, k, v, do, lse, delta, bias, causal, sm_scale, q_segment_ids,
                     kv_segment_ids, parts):
    """The parts (``"dq"``, ``"dk"``, ``"dv"``, ``"ds"``) of the plain
    backward, from the forward's log2-space ``lse`` and ``delta``; in
    float64 throughout when ``q``, ``k``, ``v`` and ``do`` are float64."""
    d = q.shape[-1]
    acc = _acc(q)
    scale = sm_scale if sm_scale is not None else d ** -0.5
    s2 = torch.einsum("bhqd,bhkd->bhqk", q.to(acc), k.to(acc)) * (scale * LOG2E)
    if bias is not None:
        s2 = s2 + _as_4d_bias(bias) * LOG2E
    visible = _visible(q.shape[2], k.shape[2], causal, q_segment_ids, kv_segment_ids, q.device)
    # a row that saw no key (lse -inf) gives p = 0, not exp2(-inf + inf)
    lse = torch.where(lse == -math.inf, math.inf, lse.to(acc))
    p = torch.where(visible, torch.exp2(s2 - lse[..., None]), 0.0)
    dp = torch.einsum("bhqd,bhkd->bhqk", do.to(acc), v.to(acc))
    ds = p * (dp - delta.to(acc)[..., None])
    out = {}
    if "dq" in parts:
        out["dq"] = (torch.einsum("bhqk,bhkd->bhqd", ds.to(k.dtype).to(acc), k.to(acc))
                     * scale).to(q.dtype)
    if "dk" in parts:
        out["dk"] = (torch.einsum("bhqk,bhqd->bhkd", ds.to(q.dtype).to(acc), q.to(acc))
                     * scale).to(k.dtype)
    if "dv" in parts:
        out["dv"] = torch.einsum("bhqk,bhqd->bhkd", p.to(do.dtype).to(acc),
                                 do.to(acc)).to(v.dtype)
    if "ds" in parts:
        out["ds"] = ds
    return out


def _delta(out: torch.Tensor, do: torch.Tensor, dlse: Optional[torch.Tensor]) -> torch.Tensor:
    """``rowsum(do * o)`` in fp32 (float64 for float64 inputs), ``(B, H,
    Sq)``; an lse cotangent folds in as ``delta - dlse * log2(e)``:
    ``d lse2 / d s_ij = p_ij log2(e)``."""
    acc = _acc(out)
    delta = (do.to(acc) * out.to(acc)).sum(-1)
    if dlse is not None:
        delta = delta - dlse.to(acc) * LOG2E
    return delta.contiguous()


def _reduce_dbias(ds: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """The full ``(B, H, Sq, Sk)`` fp32 bias gradient summed over the
    bias's broadcast dims, in its shape and dtype."""
    b4 = _as_4d_bias(bias)
    axes = tuple(i for i in range(4) if b4.shape[i] == 1 and ds.shape[i] > 1)
    red = ds.sum(dim=axes, keepdim=True) if axes else ds
    return red.reshape(bias.shape).to(bias.dtype)


def flash_attention_bwd_plain(
    q, k, v, out, lse, do, bias=None, *, causal: bool = False,
    sm_scale: Optional[float] = None, q_segment_ids=None, kv_segment_ids=None,
    dlse=None, need_dbias: bool = False,
):
    """Plain PyTorch version of the backward (the TPU's ``_flash_backward``
    and its three kernel bodies), the whole ``(Sq, Sk)`` matrix at once.
    Returns ``(dq, dk, dv)``, and the bias gradient when ``need_dbias``."""
    parts = _bwd_plain_parts(q, k, v, do, lse, _delta(out, do, dlse), bias, causal, sm_scale,
                             q_segment_ids, kv_segment_ids,
                             ("dq", "dk", "dv") + (("ds",) if need_dbias else ()))
    grads = (parts["dq"], parts["dk"], parts["dv"])
    return grads + (_reduce_dbias(parts["ds"], bias),) if need_dbias else grads


def _dq_workspace(q: torch.Tensor):
    """The shape of the fp32 workspace of the one-pass `wgmma` route (bf16
    at head widths 64 and 96, route 2 of ``mm_flash_attention_bwd_route``),
    or None on the other routes, which take none: dq's sum over key blocks,
    ``(B, H, Sq, D)``, then the rows of lse and delta that the kernel copies
    a query tile at a time, ``(B, H, Sq_pad)`` each with ``Sq_pad`` Sq
    rounded up to a multiple of 64; flat."""
    b, h, sq, d = q.shape
    if q.dtype != torch.bfloat16 or d not in (64, 96):
        return None
    sq_pad = -(-sq // 64) * 64
    return (b * h * (d * sq + 2 * sq_pad),)


def _check_bwd(name, q, k, v, do, lse, delta, bias, q_segment_ids, kv_segment_ids,
               outs=None, dq_acc=None) -> None:
    """Raises on what the backward's kernels cannot take: ``_check``'s
    rules for q, k and v (the TMA maps of the one-pass route read rows,
    heads and batches at 16-byte aligned strides); ``do`` of q's shape,
    dtype and row alignment; contiguous fp32 ``lse`` and ``delta``; and,
    given ``outs`` (dq, dk, dv), outputs of their inputs' shapes and dtype
    with 16-byte aligned rows and, where the route sums dq in a workspace, a
    contiguous fp32 ``dq_acc`` of :func:`_dq_workspace`'s shape."""
    _check(q, k, v, bias, q_segment_ids, kv_segment_ids, name)
    if do.shape != q.shape or do.dtype != q.dtype or do.device != q.device:
        raise ValueError(f"{name}: do must match q {tuple(q.shape)} {q.dtype}")
    if not _rows_ok(do):
        raise ValueError(f"{name}: rows of do must be contiguous and 16-byte aligned")
    b, h, sq, d = q.shape
    for t in (lse, delta):
        if t.shape != (b, h, sq) or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name}: lse and delta must be contiguous fp32 {(b, h, sq)}")
    if outs is None:
        return
    for out, like in zip(outs, (q, k, v)):
        if out.shape != like.shape or out.dtype != like.dtype or out.device != q.device \
                or not _rows_ok(out):
            raise ValueError(f"{name}: outputs must be {tuple(like.shape)} {like.dtype} on "
                             f"{q.device} with 16-byte aligned rows")
    want = _dq_workspace(q)
    if want is not None and (dq_acc is None or tuple(dq_acc.shape) != want
                             or dq_acc.dtype != torch.float32 or not dq_acc.is_contiguous()
                             or dq_acc.device != q.device or dq_acc.data_ptr() % 16):
        raise ValueError(f"{name}: the dq workspace must be a contiguous, 16-byte aligned "
                         f"fp32 {want} on {q.device}")


def _bwd_args(q, k, v, do, lse, delta, bias, q_segment_ids, kv_segment_ids):
    """The arguments that the backward's two C entry points share after
    the inputs' pointers: their strides, the bias's, the segment ids'."""
    b, h, sq, _ = q.shape
    sk = k.shape[2]
    bias_ptr, bias_strides = None, None
    if bias is not None:
        bias = _as_4d_bias(bias)
        bias_strides = _build.int64s(*bias.expand(b, h, sq, sk).stride())
        bias_ptr = bias.data_ptr()
    qseg = kvseg = None
    if q_segment_ids is not None:
        qseg = q_segment_ids.to(torch.int32).expand(b, sq).contiguous()
        kvseg = kv_segment_ids.to(torch.int32).expand(b, sk).contiguous()
    keep = (bias, qseg, kvseg)  # referenced by the caller until the launch is enqueued
    strides = _build.int64s(*q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *do.stride()[:3])
    return keep, strides, (bias_ptr, bias_strides,
                           None if qseg is None else qseg.data_ptr(), sq,
                           None if kvseg is None else kvseg.data_ptr(), sk,
                           lse.data_ptr(), delta.data_ptr())


def _scale(q, sm_scale) -> float:
    return float(sm_scale if sm_scale is not None else q.shape[-1] ** -0.5)


def _flash_bwd_launch(q, k, v, do, lse, delta, bias, dq, dk, dv, dq_acc, *, causal: bool,
                      sm_scale: Optional[float], q_segment_ids=None,
                      kv_segment_ids=None) -> None:
    """Launches the backward's kernels into ``dq``, ``dk`` and ``dv`` (CUDA
    tensors of q's, k's and v's shapes and dtype, any 16-byte aligned row
    strides), with ``dq_acc`` the dq workspace where the route takes one
    (:func:`_dq_workspace`; the launch zero-fills it), else None. Counts
    nothing: :func:`flash_attention_bwd` is the counted entry point."""
    name = "flash_attention_bwd"
    _check_bwd(name, q, k, v, do, lse, delta, bias, q_segment_ids, kv_segment_ids,
               (dq, dk, dv), dq_acc)
    b, h, sq, d = q.shape
    keep, strides, rest = _bwd_args(q, k, v, do, lse, delta, bias, q_segment_ids,
                                    kv_segment_ids)
    err = _kernels().mm_flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), None if dq_acc is None else dq_acc.data_ptr(), strides,
        _build.int64s(*dq.stride()[:3], *dk.stride()[:3], *dv.stride()[:3]), *rest,
        b, h, sq, k.shape[2], d, _scale(q, sm_scale), int(causal), _DTYPE_CODES[q.dtype],
        _build.stream_of(q),
    )
    _build.raise_on(err, name)


def _grad_like(t: torch.Tensor) -> torch.Tensor:
    """A ``(B, H, S, D)`` gradient of ``t``'s shape and dtype with storage
    ``(B, S, H, D)``: merging its heads is a view."""
    b, h, s, d = t.shape
    return torch.empty((b, s, h, d), dtype=t.dtype, device=t.device).transpose(1, 2)


def flash_attention_bwd(q, k, v, do, lse, delta, bias=None, *, causal: bool = False,
                        sm_scale: Optional[float] = None, q_segment_ids=None,
                        kv_segment_ids=None):
    """``(dq, dk, dv)``, each of its input's shape and dtype with storage
    ``(B, S, H, D)``: the TPU's kernels #7 and #8 as one call on CUDA, the
    plain version's on the CPU. ``lse`` is the forward's log2-space lse,
    ``delta`` :func:`_delta`'s rows, both ``(B, H, Sq)`` fp32."""
    if q.device.type == "cpu":
        parts = _bwd_plain_parts(q, k, v, do, lse, delta, bias, causal, sm_scale,
                                 q_segment_ids, kv_segment_ids, ("dq", "dk", "dv"))
        return parts["dq"], parts["dk"], parts["dv"]
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd: no kernel for {q.device}")
    dq, dk, dv = _grad_like(q), _grad_like(k), _grad_like(v)
    ws = _dq_workspace(q)
    dq_acc = None if ws is None else torch.empty(ws, dtype=torch.float32, device=q.device)
    _flash_bwd_launch(q, k, v, do, lse, delta, bias, dq, dk, dv, dq_acc, causal=causal,
                      sm_scale=sm_scale, q_segment_ids=q_segment_ids,
                      kv_segment_ids=kv_segment_ids)
    flash_attention_bwd.launches += 1
    return dq, dk, dv


def _dbias_out(q: torch.Tensor, sk: int, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """A ``(B, H, Sq, Sk)`` bias gradient for kernel #9 to write: the
    ``[..., :Sk]`` view of a contiguous ``(B, H, Sq, Sk_pad)`` buffer,
    ``Sk_pad`` Sk rounded up to a multiple of 4, so that its fp32 rows start
    16 bytes apart (TMA's stride rule); the columns past Sk are never
    written."""
    b, h, sq, _ = q.shape
    pitch = -(-sk // 4) * 4
    return torch.empty((b, h, sq, pitch), dtype=dtype, device=q.device)[..., :sk]


def _flash_bwd_dbias_launch(q, k, v, do, lse, delta, bias, ds, *, causal: bool,
                            sm_scale: Optional[float], q_segment_ids=None,
                            kv_segment_ids=None) -> None:
    """Launches kernel #9 into ``ds``, an fp32 ``(B, H, Sq, Sk)`` view of
    :func:`_dbias_out`'s layout (rows 16-byte aligned, heads and batches
    packed). Counts nothing: :func:`flash_attention_bwd_dbias` is the counted
    entry point; a check may pass a ``ds`` filled with NaN, so that an
    element the kernel leaves unwritten shows."""
    name = "flash_attention_bwd_dbias"
    _check_bwd(name, q, k, v, do, lse, delta, bias, q_segment_ids, kv_segment_ids)
    b, h, sq, d = q.shape
    sk = k.shape[2]
    pitch = ds.stride(2)
    if ds.shape != (b, h, sq, sk) or ds.dtype != torch.float32 or ds.device != q.device \
            or ds.stride() != (h * sq * pitch, sq * pitch, pitch, 1) or pitch % 4 \
            or ds.data_ptr() % 16:
        raise ValueError(f"{name}: ds must be an fp32 {(b, h, sq, sk)} view of rows 16 bytes "
                         f"apart, heads and batches packed, on {q.device}")
    keep, strides, rest = _bwd_args(q, k, v, do, lse, delta, bias, q_segment_ids,
                                    kv_segment_ids)
    err = _kernels().mm_flash_attention_bwd_dbias(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), ds.data_ptr(), pitch, strides,
        *rest, b, h, sq, sk, d, _scale(q, sm_scale), int(causal), _DTYPE_CODES[q.dtype],
        _build.stream_of(q),
    )
    _build.raise_on(err, name)


def flash_attention_bwd_dbias(q, k, v, do, lse, delta, bias, *, causal: bool = False,
                              sm_scale: Optional[float] = None, q_segment_ids=None,
                              kv_segment_ids=None) -> torch.Tensor:
    """``ds``, the full fp32 ``(B, H, Sq, Sk)`` bias gradient before its sum
    over the bias's broadcast dims (0 on causally skipped tiles), in
    :func:`_dbias_out`'s layout: kernel #9 on CUDA, the plain version's
    ``ds`` on the CPU."""
    ds = _dbias_out(q, k.shape[2], _acc(q) if q.device.type == "cpu" else torch.float32)
    kw = dict(causal=causal, sm_scale=sm_scale, q_segment_ids=q_segment_ids,
              kv_segment_ids=kv_segment_ids)
    if q.device.type == "cpu":
        ds.copy_(_bwd_plain_parts(q, k, v, do, lse, delta, bias, causal, sm_scale,
                                  q_segment_ids, kv_segment_ids, ("ds",))["ds"])
        return ds
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd_dbias: no kernel for {q.device}")
    _flash_bwd_dbias_launch(q, k, v, do, lse, delta, bias, ds, **kw)
    flash_attention_bwd_dbias.launches += 1
    return ds


flash_attention_bwd.launches = 0
flash_attention_bwd_dbias.launches = 0


def _flash_backward(q, k, v, out, lse, do, *, causal, sm_scale, q_segment_ids=None,
                    kv_segment_ids=None, dlse=None, bias=None, need_dbias=False):
    """``(dq, dk, dv[, dbias])`` through :func:`flash_attention_bwd` (and
    kernel #9), or their plain versions on the CPU. ``do`` may arrive as any view (a summed loss
    hands back a broadcast one): rows that the kernels cannot read are made
    contiguous first."""
    if do.device.type != "cpu" and not _rows_ok(do):
        do = do.contiguous()
    delta = _delta(out, do, dlse)
    kw = dict(causal=causal, sm_scale=sm_scale, q_segment_ids=q_segment_ids,
              kv_segment_ids=kv_segment_ids)
    dq, dk, dv = flash_attention_bwd(q, k, v, do, lse, delta, bias, **kw)
    if not need_dbias:
        return dq, dk, dv
    ds = flash_attention_bwd_dbias(q, k, v, do, lse, delta, bias, **kw)
    return dq, dk, dv, _reduce_dbias(ds, bias)


class _FlashAttention(torch.autograd.Function):
    """Kernel #6 forward; :func:`flash_attention_bwd` backward, and #9 only
    when the bias is differentiated (the TPU's symbolic-zeros test)."""

    @staticmethod
    def forward(ctx, q, k, v, bias, causal, sm_scale, q_segment_ids, kv_segment_ids):
        out, lse = flash_attention_forward(q, k, v, bias, causal=causal, sm_scale=sm_scale,
                                           return_lse=True, q_segment_ids=q_segment_ids,
                                           kv_segment_ids=kv_segment_ids)
        ctx.save_for_backward(q, k, v, out, lse, bias, q_segment_ids, kv_segment_ids)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse, bias, qseg, kvseg = ctx.saved_tensors
        need_dbias = bias is not None and ctx.needs_input_grad[3]
        grads = _flash_backward(q, k, v, out, lse, g, causal=ctx.causal, sm_scale=ctx.sm_scale,
                                q_segment_ids=qseg, kv_segment_ids=kvseg, bias=bias,
                                need_dbias=need_dbias)
        dbias = grads[3] if need_dbias else None
        return grads[0], grads[1], grads[2], dbias, None, None, None, None


def flash_attention(q, k, v, bias=None, causal: bool = False, sm_scale: Optional[float] = None,
                    q_segment_ids=None, kv_segment_ids=None) -> torch.Tensor:
    """Differentiable fused attention: kernel #6 forward,
    :func:`flash_attention_bwd` (and #9) backward."""
    return _FlashAttention.apply(q, k, v, bias, causal, sm_scale, q_segment_ids,
                                 kv_segment_ids)


class _FlashAttentionLse(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale):
        out, lse = flash_attention_forward(q, k, v, causal=causal, sm_scale=sm_scale,
                                           return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        return out, lse

    @staticmethod
    def backward(ctx, g_out, g_lse):
        q, k, v, out, lse = ctx.saved_tensors
        # rows that saw no key carry lse -inf and output 0: their lse
        # cotangent must not reach delta
        g_lse = torch.where(torch.isfinite(lse), g_lse, 0.0)
        dq, dk, dv = _flash_backward(q, k, v, out, lse, g_out, causal=ctx.causal,
                                     sm_scale=ctx.sm_scale, dlse=g_lse)
        return dq, dk, dv, None, None


def flash_attention_lse(q, k, v, causal: bool = False, sm_scale: Optional[float] = None):
    """``(out, lse2)``, ``lse2`` ``(B, H, Sq)`` the log2-space logsumexp of
    the scaled scores, differentiable in both (the lse cotangent folds into
    the backward's delta): the block of ring attention, whose partial
    results merge in lse space. Rows with no visible key give lse2 = -inf and
    out = 0."""
    return _FlashAttentionLse.apply(q, k, v, causal, sm_scale)


def reset_launch_counts() -> None:
    flash_attention_forward.launches = 0
    flash_attention_bwd.launches = 0
    flash_attention_bwd_dbias.launches = 0

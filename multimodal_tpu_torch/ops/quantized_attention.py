"""Decode attention over an int8 KV cache.

Counterpart of ``multimodal_tpu/ops/quantized_attention.py``. An int8 cache
(``ops/kv_cache.py``) only pays if the dense cache never round-trips
through device memory: dequantizing first writes and reads a bf16 copy of
the whole cache every layer of every tick. The kernel
(``csrc/quantized_cache_attention.cu``) reads the int8 rows, converts them
in registers, and applies the per-position scales to the small score and
probability rows after the products (``q . (k s) = (q . k) s`` per key
position, ``p . (v s) = (p s) . v`` per value position).

On a CUDA tensor ``quantized_cache_attention`` launches that kernel or
raises; on a CPU tensor it runs :func:`quantized_cache_attention_plain`,
which follows the TPU kernel body's rounding points: ``q`` cast to bf16
(also for fp32 inputs), fp32 scores, the probabilities times the value
scales rounded to bf16 before the second product, fp32 sums. It counts its
launches in ``quantized_cache_attention.launches``.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from multimodal_tpu_torch.ops import _build
from multimodal_tpu_torch.ops.kv_cache import QuantizedKV

_MAX_ROWS = 8               # query rows a kv head's block serves (group x S)
_HEAD_DIMS = (32, 64, 128)  # head widths the kernel is built for
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MASKED = -1e30
# Cache positions of a run, a block's item in each of the kernel's two
# launches (scores, then p' . v): kRun in csrc/quantized_cache_attention.cu,
# set from the card (PERF.md).
_RUN_LEN = 256

_V = ctypes.c_void_p
_I = ctypes.c_int
_lib: Optional[ctypes.CDLL] = None


def _kernels() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load_library()
        lib.mm_quantized_cache_attention.argtypes = [
            _V, _V, _V, _V, _V, _V, _V, _V, _V, _V, _V,
            _I, _I, _I, _I, _I, _I, ctypes.c_float, _I, _V]
        lib.mm_quantized_cache_attention.restype = _I
        _lib = lib
    return _lib


def _runs(cache_len: int) -> int:
    """Runs of ``_RUN_LEN`` positions a (kv head, batch row) is cut into."""
    return -(-cache_len // _RUN_LEN)


def _workspace_bytes(batch: int, kv_heads: int, rows: int, cache_len: int,
                     head_dim: int) -> int:
    """Bytes of the kernel's scratch (csrc/quantized_cache_attention.cu):
    one counter for each of the G (kv head, batch row) groups, padded to 16
    bytes, then fp32 scores (rows x L), each run's max and sum per row and
    each run's partial output per row, for every group."""
    groups = batch * kv_heads
    counters = -(-4 * groups // 16) * 16
    return counters + 4 * groups * rows * (cache_len + _runs(cache_len) * (2 + head_dim))


def supports_quantized_attention(q: torch.Tensor, attn_mask: Optional[torch.Tensor],
                                 dropout_rate: float, is_causal: bool = False,
                                 kv_heads: int = 0) -> bool:
    """Kernel applicability, the JAX package's rule: a tiny query block (a kv
    head's whole query group, group x S <= 8 rows), a bool head-broadcast
    mask as the sole mask (the kernel adds no causal masking), no attention
    dropout, and a head width the kernel is built for. The cache's length
    has no cap: the kernel splits it into runs."""
    if dropout_rate > 0.0 or attn_mask is None or is_causal:
        return False
    if attn_mask.dtype != torch.bool or attn_mask.dim() != 4 or attn_mask.shape[1] != 1:
        return False
    group = q.shape[1] // kv_heads if kv_heads else 1
    return group * q.shape[2] <= _MAX_ROWS and q.shape[-1] in _HEAD_DIMS


def _group_rows(x: torch.Tensor, kv_heads: int) -> torch.Tensor:
    """(b, h_q, S, ...) -> (b, kv_heads, group * S, ...): each kv head's
    query group stacked into rows, as the kernel serves them."""
    b, hq, s = x.shape[:3]
    return x.reshape(b, kv_heads, (hq // kv_heads) * s, *x.shape[3:])


def quantized_cache_attention_plain(q: torch.Tensor, k_cache: QuantizedKV,
                                    v_cache: QuantizedKV, mask: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel (the TPU kernel's ``_kernel``)."""
    b, hq, s, d = q.shape
    h, cache_len = k_cache.q.shape[1], k_cache.q.shape[2]
    group = hq // h
    qb = _group_rows(q.to(torch.bfloat16).float(), h)
    scores = torch.einsum("bhrd,bhld->bhrl", qb, k_cache.q.float())
    scores = scores * (k_cache.scale[:, :, None, :] * (1.0 / d ** 0.5))
    m = mask.expand(b, 1, s, cache_len)[:, 0]
    m = m[:, None].expand(b, group, s, cache_len).reshape(b, 1, group * s, cache_len)
    scores = torch.where(m, scores, _MASKED)
    scores = scores - scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores)
    p = p / p.sum(dim=-1, keepdim=True)
    p = (p * v_cache.scale[:, :, None, :]).to(torch.bfloat16).float()
    out = torch.einsum("bhrl,bhld->bhrd", p, v_cache.q.float())
    return out.reshape(b, hq, s, d).to(q.dtype)


def _check(q: torch.Tensor, k_cache: QuantizedKV, v_cache: QuantizedKV,
           mask: torch.Tensor) -> None:
    name = "quantized_cache_attention"
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name}: q must be fp32 or bf16, got {q.dtype}")
    b, hq, s, d = q.shape
    for c in (k_cache, v_cache):
        if c.q.dtype != torch.int8 or c.scale.dtype != torch.float32:
            raise TypeError(f"{name}: the cache must be int8 with fp32 scales")
        if c.q.dim() != 4 or c.q.shape[0] != b or c.q.shape[-1] != d:
            raise ValueError(f"{name}: cache {tuple(c.q.shape)} does not fit q {tuple(q.shape)}")
        if c.q.shape != k_cache.q.shape or c.scale.shape != c.q.shape[:3]:
            raise ValueError(f"{name}: inconsistent cache shapes")
        if not (c.q.is_contiguous() and c.scale.is_contiguous()):
            raise ValueError(f"{name}: the cache must be contiguous")
        for t in (c.q, c.scale):
            if t.device != q.device:
                raise ValueError(f"{name}: tensors on {t.device} and {q.device}")
    h, cache_len = k_cache.q.shape[1], k_cache.q.shape[2]
    if hq % h or (hq // h) * s > _MAX_ROWS or d not in _HEAD_DIMS:
        raise ValueError(f"{name}: no kernel for {hq} query heads over {h} kv heads, "
                         f"{s} rows, head width {d}")
    if q.stride(-1) != 1:
        raise ValueError(f"{name}: q's last dimension must be contiguous")
    if mask.dtype != torch.bool or mask.device != q.device:
        raise ValueError(f"{name}: mask must be bool on {q.device}")


def quantized_cache_attention(q: torch.Tensor, k_cache: QuantizedKV, v_cache: QuantizedKV,
                              mask: torch.Tensor) -> torch.Tensor:
    """Attention of a small query block against an int8 KV cache.

    Args:
        q: ``(b, h_q, S, d)`` with small S (a decode tick, a verify window);
            ``h_q`` a multiple of the cache's heads (grouped-query attention).
        k_cache / v_cache: ``QuantizedKV`` with ``q`` ``(b, h, L, d)`` int8
            and ``scale`` ``(b, h, L)`` fp32.
        mask: bool, broadcastable to ``(b, 1, S, L)``; True = attend.
    Returns:
        ``(b, h_q, S, d)`` in ``q``'s dtype.
    """
    if q.device.type == "cpu":
        return quantized_cache_attention_plain(q, k_cache, v_cache, mask)
    if q.device.type != "cuda":
        raise ValueError(f"quantized_cache_attention: no kernel for {q.device}")
    _check(q, k_cache, v_cache, mask)
    b, hq, s, d = q.shape
    h, cache_len = k_cache.q.shape[1], k_cache.q.shape[2]
    # (b, S, h_q, d) storage: merging the heads afterwards is a view
    out = torch.empty((b, s, hq, d), dtype=q.dtype, device=q.device).transpose(1, 2)
    ws = torch.empty(_workspace_bytes(b, h, (hq // h) * s, cache_len, d), dtype=torch.uint8,
                     device=q.device)
    _launch(q, k_cache, v_cache, mask, out, ws)
    quantized_cache_attention.launches += 1
    return out


def _launch(q: torch.Tensor, k_cache: QuantizedKV, v_cache: QuantizedKV, mask: torch.Tensor,
            out: torch.Tensor, ws: torch.Tensor) -> None:
    """The kernel's launches alone, into ``out`` (``q``'s shape and dtype,
    any strides with a contiguous last dimension) with the scratch ``ws`` of
    ``_workspace_bytes`` bytes; checks ``quantized_cache_attention`` does not
    repeat."""
    b, hq, s, d = q.shape
    h, cache_len = k_cache.q.shape[1], k_cache.q.shape[2]
    need = _workspace_bytes(b, h, (hq // h) * s, cache_len, d)
    if out.shape != q.shape or out.dtype != q.dtype or out.stride(-1) != 1:
        raise ValueError("quantized_cache_attention: out must be like q")
    if ws.dtype != torch.uint8 or ws.numel() < need or ws.data_ptr() % 16:
        raise ValueError(f"quantized_cache_attention: scratch must be {need} aligned bytes")
    m = mask.expand(b, 1, s, cache_len)
    err = _kernels().mm_quantized_cache_attention(
        q.data_ptr(), _build.int64s(*q.stride()[:3]), k_cache.q.data_ptr(),
        k_cache.scale.data_ptr(), v_cache.q.data_ptr(), v_cache.scale.data_ptr(),
        m.data_ptr(), _build.int64s(m.stride(0), m.stride(2), m.stride(3)),
        out.data_ptr(), _build.int64s(*out.stride()[:3]), ws.data_ptr(),
        b, hq, h, s, cache_len, d, 1.0 / d ** 0.5, _DTYPE_CODES[q.dtype],
        _build.stream_of(q),
    )
    _build.raise_on(err, "quantized_cache_attention")


quantized_cache_attention.launches = 0


def reset_launch_counts() -> None:
    quantized_cache_attention.launches = 0

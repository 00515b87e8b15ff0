"""Continuous-batching inference engine for causal LMs.

Counterpart of the core of ``multimodal_tpu/serving/engine.py``
(``InferenceEngine``), on one device:

- A fixed pool of ``n_slots`` decode slots. Each layer's KV cache is one
  preallocated ``(n_slots + 1, heads, max_len, head_dim)`` pair, bf16 or
  int8 (``QuantizedKV``); a slot is a row, and row ``n_slots`` is the trash
  row that batched-prefill padding writes into. The caches are updated in
  place.
- Prefill is bucketed by prompt length (powers of two by default) and
  batched (``prefill_batch`` admissions of one bucket in one causal forward);
  each row's keys and values are block-written into its slot row. From the
  flash threshold up the forward runs kernel #6 in every layer.
- Decode runs ``decode_steps`` lockstep ticks for all ``n_slots + 1`` rows
  per call: each row carries its own position (the per-row
  ``cache_index`` write) and its own valid-prefix mask, so requests of
  different lengths decode together and finished slots are re-admitted
  between calls. The sampled ids stay on the device and cross to the host
  once per call. With an int8 cache every layer's attention is kernel #10.
- Sampling on the device: greedy where the temperature is 0, else
  temperature then per-row top-k / nucleus (``utils/generate.py``), from a
  ``torch.Generator`` on the device (a Gumbel-max draw).

The JAX semantics are kept: idle rows are pinned at the sacrificial
position ``max_len - 1`` and do not advance, positions clamp to the last
row, and the first tokens of an admission round are copied to the host only
after every prefill of the round is launched.

Registered prefixes (``register_prefix``, ``Request.prefix``): a shared
prompt prefix's keys and values are computed once and broadcast into each
admitted slot's positions ``[0, plen)`` (quantized as a prefill's rows are,
for the int8 cache); the request's prompt prefills from ``plen`` on top of
them (``_prefill_prefixed``). ``VideoGPTServer`` rides every request on the
one-token start-of-sequence prefix.

Two features serve encoder-decoder clients (the caption servers):

- Per-request conditioning (``conditioning_spec``): a per-slot buffer
  ``(n_slots + 1, *shape)`` whose row of a request is written at admission
  (``Request.conditioning``) and whose trash row stays zero; every prefill
  passes the admitted slots' rows and every decode tick the whole buffer to
  the model as ``conditioning=`` (CoCa's pooled image tokens).
- ``kv_prefix`` rows (``kv_prefix_len``): each request brings per-layer
  ``(k, v)`` rows ``(heads, kv_prefix_len, head_dim)`` (BLIP-2's primed
  query rows). Admission seeds them into the slot's cache positions
  ``[0, kv_prefix_len)`` (quantized as a prefill's rows are, for the int8
  cache), clearing the rest of the row, and the prompt prefills from
  position ``kv_prefix_len`` on top of them; decode attends them through
  the valid-prefix mask.

Not ported yet (ROADMAP.md, queue A5): chunked prefill, multi-LoRA
adapters, sliding-window streaming (``window`` / ``sinks``) and speculative
decoding with a draft model. The constructor, ``register_prefix`` or
``submit`` raises ``NotImplementedError`` for each.
"""

from __future__ import annotations

import math
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from multimodal_tpu_torch.ops.kv_cache import (
    QuantizedKV,
    is_quantized_kv,
    quantize_kv,
    quantized_kv_zeros,
)
from multimodal_tpu_torch.utils.device import resolve_device
from multimodal_tpu_torch.utils.generate import filter_logits_per_row, gumbel_sample

_NOT_PORTED = "not ported yet (ROADMAP.md, queue A5)"


def _kv_set_rows(cache, new: torch.Tensor, slots: torch.Tensor, bucket: int):
    """Write ``new`` (b, h, bucket, d) into rows ``slots[:b]``, positions
    ``[0, bucket)``, of a dense or int8 cache tensor, in place."""
    if is_quantized_kv(cache):
        q, scale = quantize_kv(new)
        cache.q[slots, :, :bucket] = q
        cache.scale[slots, :, :bucket] = scale
    else:
        cache[slots, :, :bucket] = new.to(cache.dtype)
    return cache


def _kv_rows_like(cache, b: int, prefix_kv: torch.Tensor, plen: int):
    """Fresh ``(b, ...)`` rows in ``cache``'s format holding ``prefix_kv``
    ``(b or 1, h, plen, d)`` at positions ``[0, plen)`` and zeros after;
    int8 rows are quantized by ``quantize_kv``, as a prefill's are."""
    if is_quantized_kv(cache):
        rows = quantized_kv_zeros((b,) + tuple(cache.q.shape[1:]), cache.q.device)
        q, scale = quantize_kv(prefix_kv)
        rows.q[:, :, :plen] = q
        rows.scale[:, :, :plen] = scale
        return rows
    rows = torch.zeros((b,) + tuple(cache.shape[1:]), dtype=cache.dtype, device=cache.device)
    rows[:, :, :plen] = prefix_kv.to(cache.dtype)
    return rows


def _kv_scatter_rows(cache, rows, slots: torch.Tensor) -> None:
    """Overwrite whole rows ``slots`` of the cache with ``rows`` (same
    format), in place."""
    if is_quantized_kv(cache):
        cache.q[slots] = rows.q
        cache.scale[slots] = rows.scale
    else:
        cache[slots] = rows


def _kv_gather_rows(cache, slots: torch.Tensor):
    """Copies of rows ``slots`` of a dense or int8 cache tensor."""
    if is_quantized_kv(cache):
        return QuantizedKV(cache.q[slots], cache.scale[slots])
    return cache[slots]


@dataclass
class Request:
    """One generation request. ``on_token(token_id)`` streams each sampled
    token as it is collected; ``on_finish(output)`` is called once when the
    slot retires. ``conditioning`` (one row of the engine's
    ``conditioning_spec``) and ``kv_prefix`` (per-layer ``(k, v)`` of shape
    ``(heads, kv_prefix_len, head_dim)``, tensors or arrays) are required
    exactly when the engine was built with their feature. ``prefix`` names
    a prefix registered with ``InferenceEngine.register_prefix``: its rows
    are copied into the slot and ``prompt`` is the suffix after it.
    ``adapter`` is the JAX engine's field for a feature not ported yet;
    ``submit`` refuses a request that sets it."""

    prompt: Sequence[int]
    max_new_tokens: int
    temperature: float = 0.0  # 0 = greedy
    top_k: Optional[int] = None
    top_p: Optional[float] = None
    eos_id: Optional[int] = None
    request_id: Optional[Any] = None
    on_token: Optional[Any] = None
    prefix: Optional[str] = None
    adapter: Optional[str] = None
    conditioning: Optional[Any] = None
    kv_prefix: Optional[Sequence[Tuple[Any, Any]]] = None
    on_finish: Optional[Any] = None


@dataclass
class RequestOutput:
    request_id: Optional[Any]
    prompt_len: int
    tokens: List[int] = field(default_factory=list)
    finish_reason: str = ""  # "eos" | "length" | "cancelled"
    # latency breakdown (host wall-clock seconds; 0.0 until reached)
    queue_time: float = 0.0    # submit -> admission
    prefill_time: float = 0.0  # admission -> first token
    decode_time: float = 0.0   # first token -> finish

    @property
    def decode_tokens_per_sec(self) -> float:
        n = len(self.tokens) - 1
        return n / self.decode_time if n > 0 and self.decode_time > 0 else 0.0


@dataclass
class _Slot:
    request: Optional[Request] = None
    output: Optional[RequestOutput] = None
    pos: int = 0  # sequence position the NEXT decode tick writes
    last_token: int = 0
    admit_t: float = 0.0
    first_t: float = 0.0

    @property
    def free(self) -> bool:
        return self.request is None


def _bucket(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"prompt length {n} exceeds largest bucket {buckets[-1]}")


class InferenceEngine:
    """Continuous-batching engine over a fixed slot pool.

    Args:
        model: an ``nn.Module`` with the ``LongContextLM`` decode surface
            (``model(tokens, positions=, past_key_values=, cache_index=,
            attention_mask=, use_cache=True) -> (logits, kvs)``), on
            ``device``.
        n_slots: decode batch width (most concurrent requests).
        max_len: per-slot KV capacity; every request needs
            ``len(prompt) + max_new_tokens <= max_len``.
        n_layer / n_head / head_dim: cache geometry (default: read off the
            model; a GQA model caches its kv heads).
        prefill_buckets: prompt lengths a prefill pads to; default powers
            of two up to ``max_len``.
        cache_dtype: a floating ``torch.dtype`` or the string ``"int8"``.
        top_k: default top-k for sampled requests.
        decode_steps: decode ticks per call; admission happens between calls.
        prefill_batch: admissions prefilled together (one length bucket);
            padding rows write into the trash row.
        seed: the sampling generator's seed.
        device: where the caches live and the model runs; CUDA unless the
            caller asks for the CPU.
        conditioning_spec: ``(shape, dtype)`` of one request's conditioning
            row; the model then takes ``conditioning=`` (rows aligned with
            the batch) on every call.
        kv_prefix_len: the length of each request's ``kv_prefix`` rows;
            prompts start at this position.
    """

    def __init__(
        self,
        model: torch.nn.Module,
        n_slots: int,
        max_len: int,
        n_layer: Optional[int] = None,
        n_head: Optional[int] = None,
        head_dim: Optional[int] = None,
        prefill_buckets: Optional[Sequence[int]] = None,
        cache_dtype: Union[torch.dtype, str] = torch.bfloat16,
        top_k: Optional[int] = None,
        decode_steps: int = 8,
        prefill_batch: int = 8,
        seed: int = 0,
        device: Optional[Union[str, torch.device]] = None,
        adapters: Optional[dict] = None,
        prefill_chunk: Optional[int] = None,
        window: Optional[int] = None,
        sinks: Optional[int] = None,
        conditioning_spec: Optional[Any] = None,
        kv_prefix_len: Optional[int] = None,
        draft_model: Optional[Any] = None,
    ):
        for name, value in (("adapters", adapters), ("prefill_chunk", prefill_chunk),
                            ("window", window), ("sinks", sinks), ("draft_model", draft_model)):
            if value is not None:
                raise NotImplementedError(f"InferenceEngine({name}=...) is {_NOT_PORTED}")
        self.device = resolve_device(device)
        param = next(model.parameters(), None)
        if param is not None and param.device != self.device:
            raise ValueError(f"the model is on {param.device}, the engine on {self.device}")
        self.model = model
        self.n_slots = n_slots
        self.max_len = max_len
        self.top_k = top_k
        self.decode_steps = decode_steps
        n_layer = n_layer if n_layer is not None else model.n_layer
        if n_head is None:
            n_head = getattr(model, "n_kv_head", None) or model.n_head
        head_dim = (head_dim if head_dim is not None
                    else model.d_model // getattr(model, "n_head", n_head))
        if prefill_buckets is None:
            prefill_buckets = [1 << p for p in range(int(math.ceil(math.log2(max_len))) + 1)
                               if (1 << p) <= max_len]
        self.prefill_buckets = sorted(prefill_buckets)
        self.prefill_batch = prefill_batch
        # row n_slots is the trash row: batched-prefill padding writes there
        kv_shape = (n_slots + 1, n_head, max_len, head_dim)
        if cache_dtype == "int8":
            # int8 halves (vs bf16) the cache bytes a decode tick reads
            self.cache = tuple(
                (quantized_kv_zeros(kv_shape, self.device), quantized_kv_zeros(kv_shape, self.device))
                for _ in range(n_layer))
        elif isinstance(cache_dtype, torch.dtype) and cache_dtype.is_floating_point:
            self.cache = tuple(
                (torch.zeros(kv_shape, dtype=cache_dtype, device=self.device),
                 torch.zeros(kv_shape, dtype=cache_dtype, device=self.device))
                for _ in range(n_layer))
        else:
            raise ValueError(f"cache_dtype {cache_dtype!r}: a floating torch dtype, or the "
                             "string 'int8' for the quantized KV cache")
        # row n_slots is the trash row here too: it stays zero, and the
        # outputs of the rows that read it are dropped
        self.conditioning = None
        if conditioning_spec is not None:
            shape, dtype = conditioning_spec
            self.conditioning = torch.zeros((n_slots + 1,) + tuple(shape), dtype=dtype,
                                            device=self.device)
        if kv_prefix_len is not None and not 0 < kv_prefix_len < max_len:
            raise ValueError(f"kv_prefix_len ({kv_prefix_len}) must leave room for the prompt "
                             f"and generation (max_len {max_len})")
        self.kv_prefix_len = kv_prefix_len
        self._kv_geom = (n_layer, n_head, head_dim)  # for Request.kv_prefix's validation
        self._prefixes: dict = {}  # name -> (per-layer (k, v) rows (1, h, plen, d), plen)
        self._slots = [_Slot() for _ in range(n_slots)]
        self._queue: deque = deque()
        self._done: List[RequestOutput] = []
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self.ticks = 0  # decode steps executed
        self.prefill_calls = 0  # batched prefill forwards
        self._served_slot_ticks = 0  # live slots x ticks, for occupancy
        self._finished = 0
        self._tokens_out = 0

    @torch.no_grad()
    def register_prefix(self, name: str, tokens: Sequence[int], adapter: Optional[str] = None):
        """Compute the keys and values of a shared prompt prefix once;
        requests naming it (``Request.prefix``) start from copies of those
        rows instead of recomputing them. The rows are kept in the compute
        precision and converted (or quantized) into the cache's format at
        admission."""
        if adapter is not None:
            raise NotImplementedError(f"register_prefix(adapter=...) is {_NOT_PORTED}")
        tokens = np.asarray(tokens, np.int64)
        if len(tokens) == 0:
            raise ValueError("empty prefix")
        if len(tokens) >= self.max_len:
            raise ValueError(f"prefix of {len(tokens)} tokens leaves no room in max_len "
                             f"{self.max_len}")
        if self.conditioning is not None:
            raise ValueError(
                "prefix caching does not compose with per-request conditioning: prefix KV rows "
                "depend on the conditioning through cross-attention")
        if self.kv_prefix_len is not None:
            raise ValueError("registered prefixes do not compose with kv_prefix_len: both claim "
                             "cache positions [0, plen)")
        _logits, kvs = self.model(self._tensor(tokens[None]), use_cache=True)
        self._prefixes[name] = (tuple(kvs), len(tokens))

    # ------------------------------------------------------------- device
    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def _cond_kwargs(self, slots: Optional[torch.Tensor] = None) -> dict:
        """The ``conditioning=`` argument of a model call: the buffer's rows
        ``slots``, or the whole buffer when the batch is the slot pool.
        Empty without conditioning: such a model never sees the argument."""
        if self.conditioning is None:
            return {}
        return {"conditioning": self.conditioning if slots is None else self.conditioning[slots]}

    def _last_tokens(self, logits: torch.Tensor, lengths: torch.Tensor,
                     sampling: torch.Tensor) -> torch.Tensor:
        last = logits[torch.arange(logits.shape[0], device=logits.device), lengths - 1]
        self.prefill_calls += 1
        return self._sample(last, sampling)

    @torch.no_grad()
    def _prefill(self, tokens: torch.Tensor, slots: torch.Tensor, lengths: torch.Tensor,
                 sampling: torch.Tensor) -> torch.Tensor:
        """Causal forward of a batch of padded prompts (one length bucket);
        each row's keys and values are block-written into its slot. Returns
        the first sampled token of each row (from the logits at
        ``lengths - 1``), on the device."""
        logits, kvs = self.model(tokens, use_cache=True, **self._cond_kwargs(slots))
        bucket = tokens.shape[1]
        for (ck, cv), (k, v) in zip(self.cache, kvs):
            _kv_set_rows(ck, k, slots, bucket)
            _kv_set_rows(cv, v, slots, bucket)
        return self._last_tokens(logits, lengths, sampling)

    @torch.no_grad()
    def _seed_prefix(self, prefix_kvs, plen: int, slots: torch.Tensor) -> None:
        """Write whole rows ``slots`` of every layer's cache: the prefix rows
        ``prefix_kvs`` (per layer ``(b, h, plen, d)``, or ``(1, h, plen,
        d)`` broadcast to every slot) at ``[0, plen)``, zeros after, so
        nothing of a slot's earlier request stays."""
        b = slots.shape[0]
        for (ck, cv), (pk, pv) in zip(self.cache, prefix_kvs):
            _kv_scatter_rows(ck, _kv_rows_like(ck, b, pk, plen), slots)
            _kv_scatter_rows(cv, _kv_rows_like(cv, b, pv, plen), slots)

    @torch.no_grad()
    def _prefill_prefixed(self, prefix_kvs, plen: int, tokens: torch.Tensor,
                          slots: torch.Tensor, lengths: torch.Tensor,
                          sampling: torch.Tensor) -> torch.Tensor:
        """Prefill a batch of prompts on top of prefix rows (a registered
        prefix's, or per-request ``kv_prefix`` rows): the slots are seeded
        (:meth:`_seed_prefix`), the prompts' forward runs on copies of their
        rows, attending the prefix through the valid-prefix mask and writing
        its own keys and values from position ``plen``, and the rows go
        back to the slots. A padding position past a row's prompt writes to
        the sacrificial ``max_len - 1``, which a tick overwrites before any
        mask admits it."""
        self._seed_prefix(prefix_kvs, plen, slots)
        rows = tuple((_kv_gather_rows(ck, slots), _kv_gather_rows(cv, slots))
                     for ck, cv in self.cache)
        b, bucket = tokens.shape
        offs = torch.arange(bucket, device=self.device)[None, :]
        positions = (plen + offs).clamp_max(self.max_len - 1).expand(b, bucket)
        write_idx = torch.where(offs < lengths[:, None], positions, self.max_len - 1)
        mask = (torch.arange(self.max_len, device=self.device)[None, None, None, :]
                <= positions[:, None, :, None])
        logits, rows = self.model(tokens, positions=positions, past_key_values=rows,
                                  cache_index=write_idx, attention_mask=mask, use_cache=True,
                                  **self._cond_kwargs(slots))
        for (ck, cv), (rk, rv) in zip(self.cache, rows):
            _kv_scatter_rows(ck, rk, slots)
            _kv_scatter_rows(cv, rv, slots)
        return self._last_tokens(logits, lengths, sampling)

    @torch.no_grad()
    def _decode(self, tokens: torch.Tensor, positions: torch.Tensor, advance: torch.Tensor,
                sampling: torch.Tensor, filters_on: bool = True) -> torch.Tensor:
        """``decode_steps`` lockstep ticks for every row; returns the sampled
        ids ``(decode_steps, n_slots + 1)`` on the device. A slot that
        finishes mid-call decodes garbage into its own row; the host drops
        those tokens. Writes clamp to the last position."""
        ar = torch.arange(self.max_len, device=self.device)
        out = []
        for _ in range(self.decode_steps):
            pos = positions.clamp_max(self.max_len - 1)
            mask = ar[None, None, None, :] <= pos[:, None, None, None]
            logits, _ = self.model(tokens[:, None], positions=pos[:, None],
                                   past_key_values=self.cache, cache_index=pos,
                                   attention_mask=mask, use_cache=True, **self._cond_kwargs())
            tokens = self._sample(logits[:, 0], sampling, use_filters=filters_on)
            # idle rows don't advance: their write target stays pinned
            positions = positions + advance
            out.append(tokens)
        return torch.stack(out)

    def _sample(self, logits: torch.Tensor, sampling: torch.Tensor,
                use_filters: bool = True) -> torch.Tensor:
        """Greedy where temperature == 0, else temperature sampling with
        per-row top-k / nucleus filtering; ``sampling`` is (b, 3):
        [temperature, top_k (0 = off), top_p (>= 1 = off)]."""
        logits = logits.float()
        temperature = sampling[:, 0]
        greedy = logits.argmax(dim=-1)
        # temperature before the filters: top-p truncates the tempered
        # distribution
        scaled = logits / temperature.clamp_min(1e-6)[:, None]
        if use_filters:
            scaled = filter_logits_per_row(scaled, sampling[:, 1].long(), sampling[:, 2])
        return torch.where(temperature > 0, gumbel_sample(scaled, self._gen), greedy)

    def _sampling_row(self, req: Request):
        k = req.top_k if req.top_k is not None else (self.top_k or 0)
        p = req.top_p if req.top_p is not None else 1.0
        return (req.temperature, float(k), float(p))

    # --------------------------------------------------------------- host
    def submit(self, request: Request) -> None:
        if request.adapter is not None:
            raise NotImplementedError(f"Request.adapter is {_NOT_PORTED}")
        if (self.kv_prefix_len is not None) != (request.kv_prefix is not None):
            raise ValueError(
                "Request.kv_prefix is required exactly when the engine was built with "
                f"kv_prefix_len (engine: {self.kv_prefix_len}, request: "
                f"{request.kv_prefix is not None})")
        plen = 0
        if request.kv_prefix is not None:
            n_layer, n_head, head_dim = self._kv_geom
            if len(request.kv_prefix) != n_layer:
                raise ValueError(f"kv_prefix has {len(request.kv_prefix)} layers, cache has "
                                 f"{n_layer}")
            want = (n_head, self.kv_prefix_len, head_dim)
            for li, pair in enumerate(request.kv_prefix):
                for nm, arr in zip("kv", pair):
                    if tuple(arr.shape) != want:
                        raise ValueError(f"kv_prefix layer {li} {nm} shape {tuple(arr.shape)} "
                                         f"!= {want}")
            plen = self.kv_prefix_len
        if request.prefix is not None:
            if request.kv_prefix is not None:
                raise ValueError("kv_prefix and a registered prefix cannot combine: both claim "
                                 "cache positions [0, plen)")
            if request.prefix not in self._prefixes:
                raise ValueError(f"unknown prefix {request.prefix!r}")
            plen = self._prefixes[request.prefix][1]
        if plen + len(request.prompt) + request.max_new_tokens > self.max_len:
            raise ValueError(
                f"prefix({plen}) + prompt({len(request.prompt)}) + "
                f"max_new_tokens({request.max_new_tokens}) exceeds max_len({self.max_len})")
        if len(request.prompt) == 0:
            raise ValueError("empty prompt")
        if (self.conditioning is not None) != (request.conditioning is not None):
            raise ValueError(
                "Request.conditioning is required exactly when the engine was built with "
                f"conditioning_spec (engine: {self.conditioning is not None}, request: "
                f"{request.conditioning is not None})")
        if (self.conditioning is not None
                and tuple(request.conditioning.shape) != tuple(self.conditioning.shape[1:])):
            raise ValueError(f"conditioning shape {tuple(request.conditioning.shape)} != spec "
                             f"{tuple(self.conditioning.shape[1:])}")
        request._submit_t = time.perf_counter()
        self._queue.append(request)

    def cancel(self, request: Request) -> None:
        """Mark a submitted request cancelled: it retires at its next
        collected token (or leaves the queue before admission) with
        ``finish_reason='cancelled'``."""
        request._cancelled = True

    def _stack_kv_prefixes(self, chunk, n: int):
        """Per layer, ``(n, heads, kv_prefix_len, head_dim)`` fp32 stacks of
        ``chunk``'s requests' ``kv_prefix`` rows on the device, zeros for
        the padding entries (their rows land in the trash row)."""
        def stack(li: int, i: int) -> torch.Tensor:
            rows = torch.stack([torch.as_tensor(req.kv_prefix[li][i]).to(self.device,
                                                                          torch.float32)
                                for _, req in chunk])
            return torch.cat([rows, rows.new_zeros((n - len(chunk),) + rows.shape[1:])])

        return tuple((stack(li, 0), stack(li, 1)) for li in range(self._kv_geom[0]))

    def _write_conditioning(self, pairs) -> None:
        """Write the admitted requests' conditioning rows into their slots'
        rows of the buffer."""
        if self.conditioning is None:
            return
        slots = self._tensor(np.asarray([sid for sid, _ in pairs], np.int64))
        rows = torch.stack([torch.as_tensor(req.conditioning).to(self.device)
                            for _, req in pairs])
        self.conditioning[slots] = rows.to(self.conditioning.dtype)

    def _admit(self) -> None:
        # pair free slots with queued requests, group by length bucket;
        # cancelled-in-queue requests retire without touching a slot
        pairs = []
        for slot_id, slot in enumerate(self._slots):
            while self._queue and getattr(self._queue[0], "_cancelled", False):
                req = self._queue.popleft()
                out = RequestOutput(req.request_id, len(req.prompt))
                out.finish_reason = "cancelled"
                self._finished += 1
                self._done.append(out)
                if req.on_finish is not None:
                    req.on_finish(out)
            if not self._queue:
                break
            if slot.free:
                pairs.append((slot_id, self._queue.popleft()))
        if not pairs:
            return
        self._write_conditioning(pairs)
        groups: dict = {}
        for slot_id, req in pairs:
            groups.setdefault((_bucket(len(req.prompt), self.prefill_buckets), req.prefix),
                              []).append((slot_id, req))

        admitted = []
        for (bucket, prefix), items in groups.items():
            pfx_kvs, plen = self._prefixes[prefix] if prefix is not None else (None, 0)
            if self.kv_prefix_len is not None:
                plen = self.kv_prefix_len
            for c in range(0, len(items), self.prefill_batch):
                chunk = items[c: c + self.prefill_batch]
                n = self.prefill_batch
                tokens = np.zeros((n, bucket), np.int64)
                slots = np.full(n, self.n_slots, np.int64)  # default: trash
                lengths = np.ones(n, np.int64)
                sampling = np.zeros((n, 3), np.float32)
                sampling[:, 2] = 1.0
                for j, (slot_id, req) in enumerate(chunk):
                    prompt = np.asarray(req.prompt, np.int64)
                    tokens[j, : len(prompt)] = prompt
                    slots[j] = slot_id
                    lengths[j] = len(prompt)
                    sampling[j] = self._sampling_row(req)
                    slot = self._slots[slot_id]
                    slot.request = req
                    slot.output = RequestOutput(req.request_id, plen + len(prompt))
                    slot.admit_t = time.perf_counter()
                    slot.output.queue_time = slot.admit_t - getattr(req, "_submit_t",
                                                                    slot.admit_t)
                    slot.pos = plen + len(prompt)
                args = (self._tensor(tokens), self._tensor(slots), self._tensor(lengths),
                        self._tensor(sampling))
                if self.kv_prefix_len is not None:
                    firsts = self._prefill_prefixed(self._stack_kv_prefixes(chunk, n), plen,
                                                    *args)
                elif prefix is not None:
                    firsts = self._prefill_prefixed(pfx_kvs, plen, *args)
                else:
                    firsts = self._prefill(*args)
                admitted.append((chunk, firsts))
        # pull first tokens only after every prefill is dispatched
        for chunk, firsts in admitted:
            firsts = firsts.cpu().numpy()
            for j, (slot_id, _req) in enumerate(chunk):
                self._slots[slot_id].last_token = int(firsts[j])
                self._collect(slot_id, self._slots[slot_id].last_token)

    def _collect(self, slot_id: int, token: int) -> None:
        """Record a sampled token; retire the slot on eos / length /
        cancellation."""
        slot = self._slots[slot_id]
        req, out = slot.request, slot.output
        now = time.perf_counter()
        if getattr(req, "_cancelled", False):
            out.finish_reason = "cancelled"
            if slot.first_t == 0.0:
                slot.first_t = now
            out.decode_time = now - slot.first_t
            self._finished += 1
            self._tokens_out += len(out.tokens)
            self._done.append(out)
            self._slots[slot_id] = _Slot()
            if req.on_finish is not None:
                req.on_finish(out)
            return
        out.tokens.append(token)
        if len(out.tokens) == 1:
            slot.first_t = now
            out.prefill_time = now - slot.admit_t
        if req.on_token is not None:
            req.on_token(token)
        if req.eos_id is not None and token == req.eos_id:
            out.finish_reason = "eos"
        elif len(out.tokens) >= req.max_new_tokens:
            out.finish_reason = "length"
        else:
            return
        out.decode_time = now - slot.first_t
        self._finished += 1
        self._tokens_out += len(out.tokens)
        self._done.append(out)
        self._slots[slot_id] = _Slot()
        if req.on_finish is not None:
            req.on_finish(out)

    def step(self) -> int:
        """Admit what fits, then run one ``decode_steps``-tick decode call.
        Returns the number of live slots served."""
        self._admit()
        live = [i for i, s in enumerate(self._slots) if not s.free]
        if not live:
            return 0
        # n_slots + 1 rows: the trash row decodes too, so the batch matches
        # the cache. Idle rows write their garbage at the sacrificial
        # max_len - 1 position.
        rows = self.n_slots + 1
        tokens = np.zeros(rows, np.int64)
        positions = np.full(rows, self.max_len - 1, np.int64)
        advance = np.zeros(rows, np.int64)
        sampling = np.zeros((rows, 3), np.float32)
        sampling[:, 2] = 1.0
        for i in live:
            s = self._slots[i]
            tokens[i] = s.last_token
            positions[i] = s.pos
            advance[i] = 1
            sampling[i] = self._sampling_row(s.request)
        # pay the per-row filter sorts only when a live slot samples with one
        filters_on = bool(np.any((sampling[:, 0] > 0)
                                 & ((sampling[:, 1] > 0) | (sampling[:, 2] < 1.0))))
        step_tokens = self._decode(self._tensor(tokens), self._tensor(positions),
                                   self._tensor(advance), self._tensor(sampling), filters_on)
        step_tokens = step_tokens.cpu().numpy()  # (decode_steps, n_slots + 1)
        self.ticks += self.decode_steps
        self._served_slot_ticks += len(live) * self.decode_steps
        for i in live:
            for t in range(self.decode_steps):
                s = self._slots[i]
                if s.free:  # finished earlier in this call; discard the rest
                    break
                s.pos += 1
                s.last_token = int(step_tokens[t, i])
                self._collect(i, s.last_token)
        return len(live)

    def run(self) -> List[RequestOutput]:
        """Drain the queue and all live slots; return outputs in completion
        order."""
        while self._queue or any(not s.free for s in self._slots):
            self.step()
        done, self._done = self._done, []
        return done

    def stats(self) -> dict:
        """Engine-lifetime serving counters, as the JAX engine reports them."""
        return {
            "ticks": self.ticks,
            "occupancy": (self._served_slot_ticks / (self.ticks * self.n_slots)
                          if self.ticks else 0.0),
            "requests_finished": self._finished,
            "tokens_out": self._tokens_out,
            "queue_depth": len(self._queue),
            "live_slots": sum(1 for s in self._slots if not s.free),
            "prefilling_slots": 0,  # no chunked prefill: a slot is live once admitted
        }

"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``multimodal_tpu_torch/csrc`` and runs,
in order (any failure exits non-zero):

1. the card's name and power limit, and the kernels' build time;
2. each kernel against its plain PyTorch version on the card, at the CLIP
   ViT-B/32 shapes (both towers; batch 512 for the forward kernels, the
   train step's 256 for the backward ones) in bf16 and fp32, plus every
   MLP activation, head width 96 and the attention key-bias lane at small
   shapes, and the attention backward (#2) past S = 128 (its `wgmma`
   route): S = 129, ViT-B/16's S = 197 at batch 256, S = 256 at head width
   64 and S = 181 at 128 (the forward's largest there), each #2 case also
   relaunched into a dqkv filled with NaN, bitwise equal: max abs error
   against its tolerance, and the kernel's, the plain version's and one
   library call's times beside the card's bound; #2's two bf16 routes
   timed against each other at S = 16 to 128 (the numbers
   ``_BWD_WGMMA_MIN_SEQ`` is set from);
3. CLIP ViT-B/32 embedding serving at full width and depth, random weights
   from a seed: an image server (uint8 256x256 -> preprocess ->
   encode_image) and a text server (token ids -> encode_text) answer
   requests of 1, 3, 64 and 300 rows; the launch counters must show 12
   launches of each kernel per tower forward; 4 image and 4 text rows are
   held against the same weights in fp32 on the CPU (cosine >= 0.999);
   pairs/s at batch 512;
4. one CLIP ViT-B/32 contrastive train step at full width and depth, batch
   256 (bench.py's train step): fp32 parameters, bf16 compute, random
   weights from a seed, the port's ``Trainer`` with AdamW (weight decay
   1e-4, as ``optax.adamw(1e-4)``). The gradients of 8 pairs are held
   against an fp32 step of the same weights on the CPU (concatenated
   cosine >= 0.99; its MLP backward is #4, 24 launches); then 2 warm-up
   steps and 10 timed steps, which must show 24 launches a step of #1, #2
   and #3, and 24 of the MLP backward (#4 for the vision tower's 12,800
   rows, #5 for the text tower's 19,712, by ``fused_mlp_bwd_acc_supported``)
   and finite losses; items/s,
   ms a step, peak memory and one step's device time by kernel group; then
   CLIP ViT-B/16's gradients at 2 pairs (vision S = 197, #2 past S = 128)
   against fp32 on the CPU (cosine >= 0.99, 24 launches of #2), and its
   train step at batch 256 (1 warm-up, 3 timed steps, 24 launches a step of
   #1 and #2, one step's device time by kernel group);
5. CLIP ViT-L/14's image tower (S = 257, past the fused kernels) at batch 8
   on the card against fp32 on the CPU (cosine >= 0.999);
6. long-context LM serving at bench.py's serving width and depth (12
   layers, d_model 768, 12 heads, d_ff 3072, vocab 32768, bf16, random
   weights from a seed) through ``InferenceEngine`` (32 slots, 4096-long
   int8 KV cache, prefill batch 8, 16 decode ticks a call, top-k 50): 48
   requests with prompts of 600-3000 tokens and 32-128 new tokens, half
   greedy, half at temperature 1. Every request must reach its length; the
   counters must show 12 launches of #6 per prefill call, 12 of #10 per
   decode tick and 12 of #3 per either; 2 requests' logits, teacher-forced
   with an int8 cache, are held against fp32 on the CPU (cosine >= 0.99);
   prefill and decode tokens/s, ms a tick, time to first token, peak
   memory and the device time of one prefill and one decode call by
   kernel group;
7. long-context LM training at the recipe's defaults
   (``examples/long_context/train.py``: 12 layers, d_model 768, 12 heads,
   d_ff 3072, vocab 32000, fp32 parameters, bf16 compute, remat, global-norm
   clipping + AdamW) through ``build_trainer`` and ``Trainer.fit``: the
   gradients of one packed row (1 x 1024 tokens, segment ids on) held
   against an fp32 step of the same weights on the CPU (concatenated cosine
   >= 0.99; its MLP backward is #4, 12 launches); 2 warm-up and 5 timed
   steps on synthetic windows of batch 8 x 8192, whose counters must show,
   a step, 24 launches of #6 (forward and remat recompute), 12 of the
   backward (#7 + #8 as one call), 0 of #9, 24 of #3 and 12 of #5 (#4
   none), and finite losses;
   tokens/s, ms a step, peak memory and one step's device time by kernel
   group; then the recipe's ``main`` with ``--packed-docs synthetic --steps
   2 --bf16`` (batch 8 x 8192), finite losses;
8. FLAVA pretraining at the recipe's defaults
   (``examples/flava/pretrain.py``, ``base``: 12 image, 12 text and 6
   multimodal layers, width 768, ffn 3072, image 224/16, text 77, vocab
   30522, fp32 parameters, bf16 compute, AdamW with the warmup-cosine
   schedule, random weights from a seed) through ``build_trainer_and_state``
   and ``Trainer.fit`` on the recipe's synthetic batches: the gradients of 2
   pairs held against an fp32 step of the same weights on the CPU
   (concatenated cosine >= 0.99; #3 and #4 54 launches each, no attention
   kernel: the towers ask for attention probabilities); 2 warm-up and 5
   timed steps at batch 64, whose counters must show 54 launches a step of
   #3 (image and text towers twice, the multimodal encoder once) and of the
   MLP backward by the predicate (#4 for the towers' 12,608 and 4,928 rows,
   48; #5 for the multimodal encoder's 17,600, 6) and none of #1, #2 or #6,
   and finite losses; items/s, ms a step,
   peak memory and one step's device time by kernel group; then the
   recipe's ``main`` (batch 64, 2 steps), finite losses;
9. a ``kernels`` JSON line, the card line, and the result line
   ``{"ok": true, "device": {...}}``.

Phase 2 checks the MLP forward (#3) at the CLIP, LM (prefill, train step,
decode tick) and FLAVA shapes, every activation at small widths and 48 to
512 rows, bf16 and fp32, each output element held to its own row's scale
(``row_relative_error``), and a second launch into output and workspace
filled with NaN bitwise equal to the first. It checks the MLP backward
without weight gradients (#4) at CLIP's train step and the gradient
checks' rows (FLAVA's 154-550, the LM's 1,024: dx split over Dff) and
every activation, relaunched into NaN-filled outputs and workspace,
bitwise equal. It also checks the flash attention forward (#6) at the
prefill shape (8, 12, 2048, 64) causal, a train step's (8, 12, 8192, 64)
with lse, with and without segment ids, the 128-query tile's edges (Sq
127, 129, 191) and its masking variants, each relaunched into an output
and lse filled with NaN, bitwise equal, and times the prefill and train
shapes against SDPA; and the int8-cache decode
attention (#10) at the decode shape (33 x 12 heads, 4096 positions), its
verify-window and GQA variants, a query row that sees nothing, 8 query
rows over 8,192 positions and one over 32,768, each output element held to
its own row's scale (``row_relative_error``) and relaunched into an output
and scratch filled with NaN, bitwise equal, its time the profiler's device
time; and #6 against the plain path at S = 32 to 1024 (the numbers
``ops/attention.py:FLASH_MIN_SEQ`` is set from). It checks the flash
attention backward (``flash_attention_bwd``: #7 dq and #8 dk/dv as one
call; #9 the bias gradient) against the plain backward at the prefill
shape causal and #6's variants, bf16 and fp32, with
the lse cotangent through ``flash_attention_lse``, each element to its
row's scale, and launches it again into outputs and a dq workspace filled
with NaN (dk and dv bitwise equal, dq within its bar); and times the call
and #9 at the LM training shape (8, 12, 8192, 64) bf16 causal beside their
bound, the plain version and the SDPA backward (for #9 with a
differentiable float mask, whose gradient is ds). It checks the MLP
backward with weight gradients (#5) against its plain version at every
activation, the CLIP, FLAVA and LM train steps' shapes, bf16 and fp32
(dx to #4's bar, the fp32 dW1, dW2 and db1 to their own scale, two
launches bitwise equal), and times it, and each of its stages (z/dh, dx,
dW, sum, from the profiler), beside its bound, the library's recompute VJP
and the route it replaces (#4 plus the library's dW products); and times
#5 against that route at 256 to 16,384 rows (the numbers
``fused_mlp_bwd_acc_supported``'s threshold is set from; the train phases'
expected launches of #4 and #5 follow that predicate).
``--kernels-only`` stops after phase 2 and prints no result line;
``--planted-faults`` only builds copies of #2, #6, the flash backward, #4,
#5, #3 and #10 with known faults (``PLANTED_FAULTS``) and shows that the
checks catch each one; ``--ab PARENT`` only times #2-#6 and #10 at their
paths' shapes, the flash attention backward at the LM training shape and
the LM serving tick of the tree at
PARENT (the parent commit unpacked with ``git archive``) and of this
checkout, in turns, each in a process of its own.

Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # dense bf16 tensor / fp32 non-tensor
BATCH = 512
TRAIN_BATCH = 256  # bench.py's TRAIN_BATCH


def fail(msg: str) -> None:
    print(f"FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, stdout=subprocess.PIPE, text=True,
    ).stdout.strip().splitlines()
    return out[torch.cuda.current_device()] if len(out) > 1 else out[0]


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` in ms, from CUDA events around ``reps``
    calls after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, group: str, calls: int = 20) -> float:
    """Device time of one ``fn()`` in ms: its kernels of ``kernel_group``
    ``group`` under torch.profiler, summed over ``calls`` calls and divided
    by them (for a call whose host time exceeds its device time, which the
    events of ``time_ms`` would measure instead); NaN when the profiler sees
    no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "self_device_time_total", 0) or 0 for e in prof.key_averages()
             if kernel_group(e.key) == group)
    return us / 1e3 / calls if us else float("nan")


def tolerance(dtype: torch.dtype, ref: torch.Tensor) -> float:
    """bf16: two units in the last place of the largest output (one rounding
    of the output landing on the other side of a tie, plus probabilities or
    intermediates rounded to bf16 at a different tie); fp32: 1e-4 of the
    output scale (the same products summed in another order, up to 3072
    terms)."""
    scale = max(1.0, ref.abs().max().item())
    return (2.0 ** -6 if dtype == torch.bfloat16 else 1e-4) * scale


def row_relative_error(got: torch.Tensor, ref: torch.Tensor,
                       terms: Optional[torch.Tensor] = None,
                       keep: Optional[torch.Tensor] = None) -> float:
    """Largest |got - ref| / (|ref| + rms of ref's row) over the elements, a
    row being the last dimension (one query row of one head). Each element
    is held to its own row's scale, so the rows that see few keys (outputs
    up to 4) do not loosen the bar for rows that see thousands (outputs near
    0.03), as a bar scaled by the largest output would. With ``terms`` (each
    element's sum over the absolute values of its terms) the denominator
    gains 2^-8 of the element's terms: an element whose exact value is 0 (in
    the attention backward the first causal query row, ds_00 = dp_00 -
    delta_0 with o_0 = v_0) holds only the rounding noise of a cancellation,
    whose scale is that of its terms, not of the result. With ``keep`` only
    the elements where it is true count."""
    g, r = got.float(), ref.float()
    err = (g - r).abs()
    denom = r.abs() + r.pow(2).mean(-1, keepdim=True).sqrt()
    if terms is not None:
        denom = denom + 2.0 ** -8 * terms.float()
    rel = torch.where(err == 0, 0.0, err / denom)
    if keep is not None:
        rel = torch.where(keep, rel, 0.0)
    return rel.max().item()


# Bars of row_relative_error for kernels #6 and #10. bf16: 2^-6, two units in
# the last place of the element (kernel and plain version each round the
# output once, and round the probabilities to bf16 at points that can fall
# on opposite sides of a tie). fp32: #6 rounds nothing to bf16, so only the
# order of the sums differs; #10 rounds p x v_scale to bf16 on both sides
# (as the TPU kernel does), so a score summed in another order can move one
# of those roundings across a tie.
ROW_RELATIVE_BAR = {
    ("flash_attention", torch.bfloat16): 2.0 ** -6,
    ("flash_attention", torch.float32): 2.0 ** -15,
    ("quantized_cache_attention", torch.bfloat16): 2.0 ** -6,
    ("quantized_cache_attention", torch.float32): 2.0 ** -9,
}


def bound_ms(nbytes: float, flops: float, dtype: torch.dtype):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def reps_for(ms_guess: float) -> int:
    return max(3, min(50, int(300 / max(ms_guess, 1e-3))))


# --------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# --------------------------------------------------------------------------


def attention_case(fe, name, b, s, d, h, causal, dtype, key_bias, gen):
    qkv = torch.randn(b, s, 3 * d, device="cuda", generator=gen).to(dtype)
    kb = None
    if key_bias:
        kb = torch.zeros(b, s, device="cuda")
        kb[:, s // 2:] = torch.where(
            torch.rand(b, s - s // 2, device="cuda", generator=gen) < 0.5, -1e30, 0.0)
    with torch.inference_mode():
        out = fe.fused_qkv_attention(qkv, h, causal, None, kb)
        ref = fe.qkv_attention_plain(qkv, h, causal, None, kb)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        tol = tolerance(dtype, ref)
        kernel_ms = time_ms(lambda: fe.fused_qkv_attention(qkv, h, causal, None, kb), 1)
        reps = reps_for(kernel_ms)
        kernel_ms = time_ms(lambda: fe.fused_qkv_attention(qkv, h, causal, None, kb), reps)
        plain_ms = time_ms(lambda: fe.qkv_attention_plain(qkv, h, causal, None, kb), reps)
        q, k, v = qkv.view(b, s, 3, h, d // h).permute(2, 0, 3, 1, 4).contiguous().unbind(0)
        mask = None
        if kb is not None:
            mask = kb[:, None, None, :]
            if causal:
                mask = mask + torch.full((s, s), -1e30, device="cuda").triu(1)
            mask = mask.to(dtype)
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, is_causal=causal and mask is None), reps)
    es = qkv.element_size()
    nbytes = qkv.numel() * es + out.numel() * es + (0 if kb is None else kb.numel() * 4)
    pairs = s * (s + 1) // 2 if causal else s * s  # (query, key) products the mask leaves
    flops = 4.0 * b * h * pairs * (d // h)
    bms, by = bound_ms(nbytes, flops, dtype)
    return dict(kernel="fused_qkv_attention", case=name, shape=[b, s, 3 * d], heads=h,
                causal=causal, key_bias=key_bias, dtype=str(dtype).replace("torch.", ""),
                max_abs_err=err, tol=tol, ok=bool(err <= tol), ms=kernel_ms,
                plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bms, bound_by=by)


# Bars of row_relative_error for kernel #3. bf16: 2^-6, two units in the
# last place of the element (kernel and plain version each round h and the
# output once, and an fp32 sum taken in another order can land on the other
# side of a tie). fp32: nothing is rounded to bf16, only the order of the
# sums (up to 3072 terms) differs.
ROW_RELATIVE_BAR_MLP = {torch.bfloat16: 2.0 ** -6, torch.float32: 2.0 ** -15}
MLP_STAGES = (("h", "fused_mlp_fwd_h"), ("o", "fused_mlp_fwd_o"))


def _mlp_inputs(rows, din, dff, dout, dtype, gen):
    x = torch.randn(rows, din, device="cuda", generator=gen).to(dtype)
    w1t = (torch.randn(dff, din, device="cuda", generator=gen) * din ** -0.5).to(dtype)
    b1 = (torch.randn(dff, device="cuda", generator=gen) * 0.02).to(dtype)
    w2t = (torch.randn(dout, dff, device="cuda", generator=gen) * dff ** -0.5).to(dtype)
    b2 = (torch.randn(dout, device="cuda", generator=gen) * 0.02).to(dtype)
    return x, w1t, b1, w2t, b2


def mlp_case(fe, name, rows, din, dff, dout, act, dtype, gen, timing=True):
    """Kernel #3 against its plain version, each output element to its row's
    scale (``row_relative_error``, ``ROW_RELATIVE_BAR_MLP``), and a second
    launch into an output and a workspace filled with NaN bitwise equal to
    the first: repeatable, and no element of either left unwritten. With
    ``timing``, its time (and its stages' device time) beside its bound, the
    plain version and linear-act-linear."""
    x, w1t, b1, w2t, b2 = _mlp_inputs(rows, din, dff, dout, dtype, gen)
    w1, w2 = w1t.t(), w2t.t()  # (Din, Dff), (Dff, Dout) column-major, as nn.Linear holds them
    lib_act = fe._ACTIVATIONS[act]
    run = lambda: fe.fused_mlp(x, w1, b1, w2, b2, act)  # noqa: E731
    with torch.inference_mode():
        ref = fe.mlp_plain(x, w1, b1, w2, b2, act)
        out = run()
        # the same launch into NaN: an element of the output, or a row of h
        # between the two stages, that the kernel does not write shows as NaN
        # rather than as what the caching allocator's block held before
        again = torch.full_like(out, math.nan)
        ws_shape = fe._mlp_fwd_workspace(rows, dff, dtype)
        ws = None if ws_shape is None else torch.full(ws_shape, math.nan, dtype=dtype,
                                                      device=x.device)
        fe._mlp_fwd_launch(x, w1, b1, w2, b2, act, again, ws)
        torch.cuda.synchronize()
        deterministic = torch.equal(out, again)
        rel = row_relative_error(out, ref)
        err = (out.float() - ref.float()).abs().max().item()
        del again, ws
        bar = ROW_RELATIVE_BAR_MLP[dtype]
        row = dict(kernel="fused_mlp", case=name, shape=[rows, din, dff, dout], activation=act,
                   dtype=str(dtype).replace("torch.", ""), max_abs_err=err,
                   rel_err={"out": rel}, tol=bar, deterministic=deterministic,
                   ok=bool(deterministic and rel <= bar))
        if not timing:
            return row
        kernel_ms = time_ms(run, 1)
        reps = reps_for(kernel_ms)
        kernel_ms = time_ms(run, reps)
        plain_ms = time_ms(lambda: fe.mlp_plain(x, w1, b1, w2, b2, act), reps)
        lib_ms = time_ms(lambda: F.linear(lib_act(F.linear(x, w1t, b1)), w2t, b2), reps)
        stages = stage_ms(run, MLP_STAGES)
    es = x.element_size()
    nbytes = (x.numel() + w1.numel() + b1.numel() + w2.numel() + b2.numel() + rows * dout) * es
    flops = 2.0 * rows * (din * dff + dff * dout)
    bms, by = bound_ms(nbytes, flops, dtype)
    row.update(ms=kernel_ms, stage_ms=stages, plain_ms=plain_ms, library_ms=lib_ms,
               bound_ms=bms, bound_by=by,
               tflops=flops / kernel_ms / 1e9, gbps=nbytes / kernel_ms / 1e6)
    return row


def check_mlp_kernel(fe, dtypes=(torch.bfloat16, torch.float32), timing=True):
    """Kernel #3 at the paths' shapes in each dtype: CLIP ViT-B/32 serving
    (batch 512), every activation at small widths (Dout 192 leaves a ragged
    column tile), the LM's prefill call, train step and decode tick, the
    few rows between those two (48 to 512), and FLAVA's three MLPs at batch
    64."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    shapes = [("vision", BATCH * 50, 768, 3072, 768, "quick_gelu"),
              ("text", BATCH * 77, 512, 2048, 512, "quick_gelu")]
    shapes += [(f"small_{act}", 300, 256, 512, 192, act)
               for act in ("quick_gelu", "gelu", "gelu_exact", "relu", "silu")]
    # the LM's MLP (exact GELU): a prefill call of 8 x 2048 rows, a train
    # step's 8 x 8192, a decode tick of 33, and few rows in between
    shapes += [(name, r, 768, 3072, 768, "gelu_exact") for name, r in (
        ("lm_prefill", 8 * 2048), ("lm_train", 8 * 8192), ("lm_decode", 33),
        ("rows_48", 48), ("rows_64", 64), ("rows_128", 128), ("rows_256", 256),
        ("rows_512", 512))]
    shapes += [(f"flava_{tower}", FLAVA_BATCH * seq, 768, 3072, 768, "gelu_exact")
               for tower, seq in FLAVA_SEQS]
    rows = []
    for dtype in dtypes:
        for shape in shapes:
            row = mlp_case(fe, *shape, dtype, gen, timing=timing)
            print("kernel_check " + json.dumps(row), flush=True)
            rows.append(row)
            torch.cuda.empty_cache()
    return rows


def _attention_bwd_inputs(b, s, d, dtype, key_bias, gen):
    qkv = torch.randn(b, s, 3 * d, device="cuda", generator=gen).to(dtype)
    g = torch.randn(b, s, d, device="cuda", generator=gen).to(dtype)
    kb = None
    if key_bias:
        kb = torch.zeros(b, s, device="cuda")
        kb[:, s // 2:] = torch.where(
            torch.rand(b, s - s // 2, device="cuda", generator=gen) < 0.5, -1e30, 0.0)
    return qkv, g, kb


def attention_bwd_case(fe, name, b, s, d, h, causal, dtype, key_bias, gen, timing=True):
    """Kernel #2 against its plain version by max abs error (``tolerance``),
    a key the bias masks getting dk = dv = 0 exactly, and a second launch
    through ``_attention_bwd_launch`` into a dqkv filled with NaN, bitwise
    equal to the first (every element written, in a fixed order)."""
    qkv, g, kb = _attention_bwd_inputs(b, s, d, dtype, key_bias, gen)
    out = fe.fused_qkv_attention_bwd(qkv, g, h, causal, None, kb)
    ref = fe.qkv_attention_bwd_plain(qkv, g, h, causal, None, kb)
    route = fe._attention_bwd_route(s, d // h, dtype)
    again = torch.full_like(out, float("nan"))
    fe._attention_bwd_launch(qkv, g, h, causal, None, kb, again, route)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    tol = tolerance(dtype, ref)
    deterministic = bool(torch.equal(out, again))
    # a key masked by the bias is seen by no query: its dk and dv are exactly 0
    masked_zero = kb is None or bool((out[..., d:][kb < -1e29] == 0).all())
    row = dict(kernel="fused_qkv_attention_bwd", case=name, shape=[b, s, 3 * d], heads=h,
               causal=causal, key_bias=key_bias, dtype=str(dtype).replace("torch.", ""),
               route=route, max_abs_err=err, tol=tol, masked_keys_zero=masked_zero,
               deterministic=deterministic, ok=bool(err <= tol and masked_zero and deterministic))
    if not timing:
        return row
    kernel_ms = time_ms(lambda: fe.fused_qkv_attention_bwd(qkv, g, h, causal, None, kb), 1)
    reps = reps_for(kernel_ms)
    kernel_ms = time_ms(lambda: fe.fused_qkv_attention_bwd(qkv, g, h, causal, None, kb), reps)
    plain_ms = time_ms(lambda: fe.qkv_attention_bwd_plain(qkv, g, h, causal, None, kb), reps)
    q, k, v = (t.detach().requires_grad_() for t in
               qkv.view(b, s, 3, h, d // h).permute(2, 0, 3, 1, 4).contiguous().unbind(0))
    go = g.view(b, s, h, d // h).transpose(1, 2).contiguous()
    mask = None
    if kb is not None:
        mask = kb[:, None, None, :]
        if causal:
            mask = mask + torch.full((s, s), -1e30, device="cuda").triu(1)
        mask = mask.to(dtype)
    o = F.scaled_dot_product_attention(q, k, v, attn_mask=mask, is_causal=causal and mask is None)
    lib_ms = time_ms(lambda: torch.autograd.grad(o, (q, k, v), go, retain_graph=True), reps)
    es = qkv.element_size()
    nbytes = (qkv.numel() + g.numel() + out.numel()) * es + (0 if kb is None else kb.numel() * 4)
    pairs = s * (s + 1) // 2 if causal else s * s
    flops = 10.0 * b * h * pairs * (d // h)  # five S x S x Dh products
    bms, by = bound_ms(nbytes, flops, dtype)
    row.update(ms=kernel_ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bms, bound_by=by)
    return row


# Kernel #2's cases: CLIP ViT-B/32's towers at the train batch, the key-bias
# lane, head width 96, and past S = 128 (the `wgmma` route): one past it,
# ViT-B/16's vision tower at the train batch, S = 256 at head width 64 and
# S = 181 at 128 (the forward's largest there), each with the masks.
ATTENTION_BWD_CASES = [
    ("vision", TRAIN_BATCH, 50, 768, 12, False, False),
    ("text", TRAIN_BATCH, 77, 512, 8, True, False),
    ("key_bias", 8, 40, 256, 4, False, True),
    ("key_bias_causal", 8, 77, 256, 4, True, True),
    ("head_width_96", 8, 50, 384, 4, True, False),
    ("seq_129", 8, 129, 768, 12, True, True),
    ("vit_b16", TRAIN_BATCH, 197, 768, 12, False, False),
    ("seq_256", 8, 256, 768, 12, True, True),
    ("head_width_128_seq_181", 8, 181, 512, 4, True, True),
]


def check_attention_bwd_kernel(fe, dtypes=(torch.bfloat16, torch.float32), timing=True):
    """Kernel #2 at ``ATTENTION_BWD_CASES`` in each dtype."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    rows = []
    for dtype in dtypes:
        for name, b, s, d, h, causal, kb in ATTENTION_BWD_CASES:
            row = attention_bwd_case(fe, name, b, s, d, h, causal, dtype, kb, gen, timing=timing)
            print("kernel_check " + json.dumps(row), flush=True)
            rows.append(row)
            torch.cuda.empty_cache()
    return rows


def attention_bwd_routes(fe, shapes=tuple((TRAIN_BATCH, s, 768, 12, False)
                                           for s in (16, 33, 50, 64, 80, 81, 96, 112, 128))
                         + ((TRAIN_BATCH, 77, 512, 8, True),)):
    """Kernel #2's two bf16 routes at head width 64 on the same inputs, at
    S <= 128 where both take the shape (CLIP's vision S = 50 and causal text
    S = 77 among them; the `mma.sync` kernel's tiles change at 64 and 80):
    each held to the bar, and timed. The numbers ``_BWD_WGMMA_MIN_SEQ`` is
    set from."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    rows = []
    for b, s, d, h, causal in shapes:
        qkv, g, _ = _attention_bwd_inputs(b, s, d, torch.bfloat16, False, gen)
        ref = fe.qkv_attention_bwd_plain(qkv, g, h, causal)
        row = {"seq": s, "causal": causal}
        for name, route in (("mma", fe._BWD_MMA), ("wgmma", fe._BWD_WGMMA)):
            out = torch.empty_like(qkv)
            fn = lambda: fe._attention_bwd_launch(qkv, g, h, causal, None, None, out, route)  # noqa: E731
            fn()
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            if not err <= tolerance(torch.bfloat16, ref):
                fail(f"#2 route {name} at S = {s}: max abs error {err}")
            row[f"{name}_ms"] = time_ms(fn, reps_for(time_ms(fn, 1)))
        rows.append(row)
        torch.cuda.empty_cache()
    return rows


def _mlp_bwd_inputs(rows, din, dff, dout, dtype, gen):
    x = torch.randn(rows, din, device="cuda", generator=gen).to(dtype)
    g = (torch.randn(rows, dout, device="cuda", generator=gen) * 0.1).to(dtype)
    w1t = (torch.randn(dff, din, device="cuda", generator=gen) * din ** -0.5).to(dtype)
    b1 = (torch.randn(dff, device="cuda", generator=gen) * 0.02).to(dtype)
    w2t = (torch.randn(dout, dff, device="cuda", generator=gen) * dff ** -0.5).to(dtype)
    return x, g, w1t, b1, w2t


MLP_BWD_STAGES = (("zdh", "fused_mlp_bwd_zdh"), ("dx", "fused_mlp_bwd_dx_kernel"),
                  ("sum", "fused_mlp_bwd_dx_sum"))


def mlp_bwd_case(fe, name, rows, din, dff, dout, act, dtype, gen, timing=True):
    """Kernel #4 against its plain version (dx, da and h each to its own
    tolerance), and a second launch into outputs and a workspace filled
    with NaN bitwise equal to the first; with ``timing``, its time (and its
    stages', from the profiler) beside its bound, the plain version and the
    library's recompute VJP."""
    x, g, w1t, b1, w2t = _mlp_bwd_inputs(rows, din, dff, dout, dtype, gen)
    b2 = torch.zeros(dout, device="cuda", dtype=dtype)
    w1, w2 = w1t.t(), w2t.t()
    outs = fe.fused_mlp_bwd(x, g, w1, b1, w2, act)
    refs = fe.mlp_bwd_plain(x, g, w1, b1, w2, act)
    # the same launch into NaN: an element of dx, da or h, or of a dx
    # partial, that the kernel does not write shows as NaN
    again = [torch.full_like(o, math.nan) for o in outs]
    ws = fe._mlp_bwd_workspace(rows, din, dff, dtype)
    part = None if ws is None else torch.full(ws, math.nan, device="cuda")
    fe._mlp_bwd_launch(x, g, w1, b1, w2, act, *again, part)
    torch.cuda.synchronize()
    deterministic = all(torch.equal(o, a) for o, a in zip(outs, again))
    del again, part
    errs = [(o.float() - r.float()).abs().max().item() for o, r in zip(outs, refs)]
    tols = [tolerance(dtype, r) for r in refs]
    worst = max(range(3), key=lambda i: errs[i] / tols[i])  # each output has its own tolerance
    row = dict(kernel="fused_mlp_bwd", case=name, shape=[rows, din, dff, dout], activation=act,
               dtype=str(dtype).replace("torch.", ""),
               splits=1 if ws is None else ws[0], max_abs_err=errs[worst], tol=tols[worst],
               max_abs_err_dx_da_h=errs, tol_dx_da_h=tols, deterministic=deterministic,
               ok=deterministic and all(e <= t for e, t in zip(errs, tols)))
    if not timing:
        return row
    kernel_ms = time_ms(lambda: fe.fused_mlp_bwd(x, g, w1, b1, w2, act), 1)
    reps = reps_for(kernel_ms)
    kernel_ms = time_ms(lambda: fe.fused_mlp_bwd(x, g, w1, b1, w2, act), reps)
    stages = stage_ms(lambda: fe.fused_mlp_bwd(x, g, w1, b1, w2, act), MLP_BWD_STAGES)
    plain_ms = time_ms(lambda: fe.mlp_bwd_plain(x, g, w1, b1, w2, act), reps)
    lib_act = fe._ACTIVATIONS[act]
    xg = x.detach().requires_grad_()
    # the recompute VJP: forward again, then autograd back to x
    lib_ms = time_ms(lambda: torch.autograd.grad(
        F.linear(lib_act(F.linear(xg, w1t, b1)), w2t, b2), xg, g), reps)
    es = x.element_size()
    nbytes = (x.numel() + g.numel() + w1.numel() + b1.numel() + w2.numel()
              + sum(o.numel() for o in outs)) * es
    flops = 2.0 * rows * dff * (2 * din + dout)
    bms, by = bound_ms(nbytes, flops, dtype)
    row.update(ms=kernel_ms, stage_ms=stages, plain_ms=plain_ms, library_ms=lib_ms,
               bound_ms=bms, bound_by=by)
    return row


def check_mlp_bwd_kernel(fe, dtypes=(torch.bfloat16, torch.float32), timing=True):
    """Kernel #4 in each dtype at CLIP ViT-B/32's train-step MLPs (batch
    256), every activation at small widths (Dout 192: a ragged column tile;
    Dff 512: dx in two runs), and the gradient checks' rows: FLAVA's at 2
    pairs and the LM's packed row."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    tb = TRAIN_BATCH
    shapes = [("vision", tb * 50, 768, 3072, 768, "quick_gelu"),
              ("text", tb * 77, 512, 2048, 512, "quick_gelu")]
    shapes += [(f"small_{act}", 300, 256, 512, 192, act)
               for act in ("quick_gelu", "gelu", "gelu_exact", "relu", "silu")]
    # FLAVA's gradient check at 2 pairs, #4's side of the predicate, and the
    # LM's at one packed row of 1,024 tokens
    shapes += [(f"flava_grad_{tower}", 2 * seq, 768, 3072, 768, "gelu_exact")
               for tower, seq in FLAVA_SEQS]
    shapes.append(("lm_grad", 1024, 768, 3072, 768, "gelu_exact"))
    rows = []
    for dtype in dtypes:
        for shape in shapes:
            row = mlp_bwd_case(fe, *shape, dtype, gen, timing=timing)
            print("kernel_check " + json.dumps(row), flush=True)
            rows.append(row)
            torch.cuda.empty_cache()
    return rows


# Bars of row_relative_error (each element's terms included) for the fp32
# dW1, dW2 and db1 of kernel #5, keyed on the input dtype. bf16: 2^-6, as
# for #6: da and h are rounded to bf16 before the dW products, and an fp32
# value summed in another order can land on the other side of a tie. fp32:
# nothing is rounded to bf16, only the order of the sums over the rows
# differs. Where a weight gradient's terms cancel (random data: an element
# of dW1 is a sum of thousands of terms of either sign), 2^-8 of its terms
# join its scale, as for the flash backward.
ROW_RELATIVE_BAR_ACC = {torch.bfloat16: 2.0 ** -6, torch.float32: 2.0 ** -15}


def mlp_bwd_acc_case(fe, name, rows, din, dff, dout, act, dtype, gen, timing=True):
    """Kernel #5 against its plain version: dx to #4's bar, dW1, dW2 and db1
    to their own scale (``ROW_RELATIVE_BAR_ACC``); two launches bitwise
    equal; with ``timing``, its time beside its bound, the plain version,
    the library's recompute VJP (autograd through F.linear, the activation
    and F.linear, every gradient) and the route it replaces (#4 plus its two
    library dW products and the db1 sum)."""
    x, g, w1t, b1, w2t = _mlp_bwd_inputs(rows, din, dff, dout, dtype, gen)
    w1, w2 = w1t.t(), w2t.t()
    outs = fe.fused_mlp_bwd_acc(x, g, w1, b1, w2, act)
    again = fe.fused_mlp_bwd_acc(x, g, w1, b1, w2, act)
    refs = fe.mlp_bwd_acc_plain(x, g, w1, b1, w2, act)
    torch.cuda.synchronize()
    deterministic = all(torch.equal(a, b) for a, b in zip(outs, again))
    # each dW element's terms: |x|^T |da_c|, |h_c|^T |g|; db1's: sum of |da|
    z = x.float() @ w1.float() + b1.float()
    h, dact = fe._act_and_grad(act, z)
    da = (g.float() @ w2.float().t()) * dact
    terms = (x.float().abs().t() @ da.to(dtype).float().abs(),
             h.to(dtype).float().abs().t() @ g.float().abs(), da.abs().sum(0))
    del z, h, dact, da
    dx_err = (outs[0].float() - refs[0].float()).abs().max().item()
    dx_tol = tolerance(dtype, refs[0])
    rel = {n: row_relative_error(o, r, t)
           for n, o, r, t in zip(("dw1", "dw2", "db1"), outs[1:], refs[1:], terms)}
    bar = ROW_RELATIVE_BAR_ACC[dtype]
    ok = dx_err <= dx_tol and all(v <= bar for v in rel.values()) and deterministic
    row = dict(kernel="fused_mlp_bwd_acc", case=name, shape=[rows, din, dff, dout],
               activation=act, dtype=str(dtype).replace("torch.", ""),
               splits=fe._acc_splits(rows, din, dff, dout), max_abs_err=dx_err, tol=dx_tol,
               rel_err=rel, rel_bar=bar, deterministic=deterministic, ok=bool(ok))
    del outs, again, refs, terms
    if not timing:
        return row
    kernel_ms = time_ms(lambda: fe.fused_mlp_bwd_acc(x, g, w1, b1, w2, act), 1)
    reps = reps_for(kernel_ms)
    kernel_ms = time_ms(lambda: fe.fused_mlp_bwd_acc(x, g, w1, b1, w2, act), reps)
    stages = stage_ms(lambda: fe.fused_mlp_bwd_acc(x, g, w1, b1, w2, act), ACC_STAGES)
    plain_ms = time_ms(lambda: fe.mlp_bwd_acc_plain(x, g, w1, b1, w2, act), reps)

    def staged():  # the route #5 replaces: _MLP.backward's #4 branch
        dx, da, h = fe.fused_mlp_bwd(x, g, w1, b1, w2, act)
        return (dx, torch.matmul(da.t(), x), torch.matmul(g.t(), h),
                da.sum(0, dtype=torch.float32))

    staged_ms = time_ms(staged, reps)
    lib_act = fe._ACTIVATIONS[act]
    leaves = [t.detach().requires_grad_() for t in (x, w1t, b1, w2t)]
    out = F.linear(lib_act(F.linear(leaves[0], leaves[1], leaves[2])), leaves[3])
    lib_ms = time_ms(lambda: torch.autograd.grad(out, leaves, g, retain_graph=True), reps)
    del out, leaves
    es = x.element_size()
    nbytes = ((2 * x.numel() + g.numel() + w1.numel() + b1.numel() + w2.numel()) * es
              + 4 * (w1.numel() + w2.numel() + b1.numel()))
    flops = 2.0 * rows * dff * (3 * din + 2 * dout)  # z, g W2^T, dx, dW1, dW2
    bms, by = bound_ms(nbytes, flops, dtype)
    row.update(ms=kernel_ms, stage_ms=stages, plain_ms=plain_ms, library_ms=lib_ms,
               staged_ms=staged_ms, bound_ms=bms, bound_by=by)
    return row


ACC_STAGES = (("zdh", "fused_mlp_bwd_acc_zdh"), ("dx", "fused_mlp_bwd_acc_dx"),
              ("dw", "fused_mlp_bwd_acc_dw"), ("sum", "fused_mlp_bwd_acc_sum"))


def stage_ms(fn, stages, reps=5):
    """Device time a call of ``fn`` of each of a kernel's stages (``stages``:
    (stage, a text of its kernels' names)), from torch.profiler over
    ``reps`` calls; 'not measured' when the profiler sees no device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
        for stage, kernel in stages:
            if kernel in e.key and us:
                out[stage] = out.get(stage, 0.0) + us / 1e3 / reps
    return out or "not measured"


def acc_threshold(fe, rows=(256, 512, 1024, 2048, 4096, 8192, 16384), din=768, dff=3072,
                  dout=768):
    """#5 against the route it replaces (#4 plus the library's dW products
    and the db1 sum) at the row counts around ``fused_mlp_bwd_acc_supported``'s
    threshold, bf16, exact GELU: the numbers ``_ACC_MIN_ROWS`` is set from."""
    gen = torch.Generator(device="cuda").manual_seed(6)
    out = {}
    for r in rows:
        x, g, w1t, b1, w2t = _mlp_bwd_inputs(r, din, dff, dout, torch.bfloat16, gen)
        w1, w2 = w1t.t(), w2t.t()

        def staged():
            dx, da, h = fe.fused_mlp_bwd(x, g, w1, b1, w2, "gelu_exact")
            return (dx, torch.matmul(da.t(), x), torch.matmul(g.t(), h),
                    da.sum(0, dtype=torch.float32))

        acc = lambda: fe.fused_mlp_bwd_acc(x, g, w1, b1, w2, "gelu_exact")  # noqa: E731
        ms = [time_ms(f, 20) for f in (staged, acc, acc, staged)]  # in turns
        out[r] = {"staged_ms": (ms[0] + ms[3]) / 2, "acc_ms": (ms[1] + ms[2]) / 2}
    return out


# Kernel #5's shapes: every activation at 1,000 rows (a ragged last tile),
# then the train steps' MLPs: CLIP ViT-B/32 vision and text at batch 256,
# FLAVA's image, text and multimodal MLPs at batch 64, the LM at 8 x 8192.
ACC_CASES = [(f"ragged_1000_{act}", 1000, 768, 3072, 768, act, False)
             for act in ("quick_gelu", "gelu", "gelu_exact", "relu", "silu")] + [
    ("clip_vision", TRAIN_BATCH * 50, 768, 3072, 768, "quick_gelu", True),
    ("clip_text", TRAIN_BATCH * 77, 512, 2048, 512, "quick_gelu", True),
    ("flava_image", 64 * 197, 768, 3072, 768, "gelu_exact", True),
    ("flava_text", 64 * 77, 768, 3072, 768, "gelu_exact", True),
    ("flava_mm", 64 * 275, 768, 3072, 768, "gelu_exact", True),
    ("lm_train", 8 * 8192, 768, 3072, 768, "gelu_exact", True),
]


def check_acc_kernel(fe, dtypes=(torch.bfloat16, torch.float32), timing=True):
    """Kernel #5 at ``ACC_CASES`` in each dtype; the train steps' shapes are
    timed in bf16, the dtype they run in."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    rows = []
    for dtype in dtypes:
        for name, r, din, dff, dout, act, timed in ACC_CASES:
            row = mlp_bwd_acc_case(fe, name, r, din, dff, dout, act, dtype, gen,
                                   timing=timing and timed and dtype == torch.bfloat16)
            print("kernel_check " + json.dumps(row), flush=True)
            rows.append(row)
            torch.cuda.empty_cache()
    return rows


def _segments(b, s, gen):
    """(b, s) int32 packed-document ids: 4 documents a row, cut at random."""
    cuts = torch.sort(torch.randperm(s - 1, generator=gen, device="cuda")[:3] + 1).values
    ids = torch.searchsorted(cuts, torch.arange(s, device="cuda"), right=True)
    return ids.to(torch.int32)[None].expand(b, s).contiguous()


def flash_case(fa, name, b, h, sq, sk, d, causal, dtype, gen, bias_kind=None,
               segments=False, lse=False, timing=True):
    """Kernel #6 against its plain version (a batch row at a time where the
    (Sq, Sk) fp32 matrices of all rows would not fit), and a second launch
    into an output and lse filled with NaN bitwise equal to the first; with
    ``timing``, its time beside its bound, the plain version and the library
    call, SDPA with the same visibility and bias as an explicit mask
    (``is_causal`` where it is the square causal mask, since SDPA's causal
    is top-left aligned)."""
    q, k, v = (torch.randn(b, h, s, d, device="cuda", generator=gen).to(dtype)
               for s in (sq, sk, sk))
    bias = None
    if bias_kind == "1h1k":  # ALiBi-style per-head key ramp
        bias = -0.05 * torch.rand(1, h, 1, 1, device="cuda", generator=gen) * torch.arange(
            sk, device="cuda")[None, None, None, :]
    elif bias_kind == "b1qk":
        bias = torch.randn(b, 1, sq, sk, device="cuda", generator=gen)
    qseg = kvseg = None
    if segments:
        qseg = kvseg = _segments(b, sq, gen)
    kw = dict(causal=causal, return_lse=lse, q_segment_ids=qseg, kv_segment_ids=kvseg)
    rows = b if b * h * sq * sk <= 2 ** 30 else 1  # batch rows of one plain call

    def plain(i):
        cut = (lambda x: x if x is None or x.shape[0] == 1 else x[i:i + rows])  # noqa: E731
        return fa.flash_attention_plain(
            q[i:i + rows], k[i:i + rows], v[i:i + rows], cut(bias), causal=causal,
            return_lse=lse, q_segment_ids=cut(qseg), kv_segment_ids=cut(kvseg))

    with torch.inference_mode():
        got = fa.flash_attention_forward(q, k, v, bias, **kw)
        out, got_lse = (got[0], got[1]) if lse else (got, None)
        again = fa._grad_like(q).fill_(math.nan)
        again_lse = None if got_lse is None else torch.full_like(got_lse, math.nan)
        fa._flash_fwd_launch(q, k, v, bias, again, again_lse, causal=causal, sm_scale=None,
                             q_segment_ids=qseg, kv_segment_ids=kvseg)
        torch.cuda.synchronize()
        deterministic = torch.equal(out, again) and (
            got_lse is None or torch.equal(got_lse, again_lse))
        del again, again_lse
        err = rel_err = 0.0
        lse_ok, lse_err = True, None
        for i in range(0, b, rows):
            ref = plain(i)
            ref_out = ref[0] if lse else ref
            err = max(err, (out[i:i + rows].float() - ref_out.float()).abs().max().item())
            rel_err = max(rel_err, row_relative_error(out[i:i + rows], ref_out))
            if lse:
                fin = torch.isfinite(ref[1])
                e = (got_lse[i:i + rows][fin] - ref[1][fin]).abs().max().item()
                lse_err = e if lse_err is None else max(lse_err, e)
                lse_ok = lse_ok and e <= 1e-4 * max(1.0, ref[1][fin].abs().max().item()) and bool(
                    torch.equal(torch.isfinite(got_lse[i:i + rows]), fin))
            del ref, ref_out
        tol = ROW_RELATIVE_BAR["flash_attention", dtype]
        row = dict(kernel="flash_attention", case=name, shape=[b, h, sq, sk, d], causal=causal,
                   bias=bias_kind, segments=segments, lse=lse,
                   dtype=str(dtype).replace("torch.", ""), max_abs_err=err, rel_err=rel_err,
                   tol=tol, lse_err=lse_err, deterministic=deterministic,
                   ok=bool(rel_err <= tol and lse_ok and deterministic))
        if not timing:
            return row
        visible = torch.ones(sq, sk, dtype=torch.bool, device="cuda")
        if causal:
            visible = visible.tril(sk - sq)
        visible = visible[None, None].expand(b, 1, sq, sk)
        if segments:
            visible = visible & (qseg[:, None, :, None] == kvseg[:, None, None, :])
        pairs = int(visible.sum().item()) * h
        lib_mask = None
        if bias is not None or segments or (causal and sq != sk):
            lib_mask = torch.where(visible, 0.0, -math.inf)
            if bias is not None:
                lib_mask = lib_mask + bias
            lib_mask = lib_mask.to(dtype)
        del visible
        lib_causal = causal and lib_mask is None
        call = lambda: fa.flash_attention_forward(q, k, v, bias, **kw)  # noqa: E731
        kernel_ms = time_ms(call, 1)
        reps = reps_for(kernel_ms)
        kernel_ms = time_ms(call, reps)
        plain_ms = time_ms(lambda: [plain(i) for i in range(0, b, rows)],
                           max(1, reps // 4) if rows == b else 1, warmup=1)
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=lib_mask, is_causal=lib_causal), reps)
        del lib_mask
    es = q.element_size()
    nbytes = (q.numel() + k.numel() + v.numel() + out.numel()) * es
    nbytes += 0 if bias is None else bias.numel() * 4
    nbytes += 0 if not segments else (b * sq + b * sk) * 4
    nbytes += 0 if not lse else b * h * sq * 4
    flops = 4.0 * d * pairs  # q.k and p.v over the visible (query, key) pairs
    bms, by = bound_ms(nbytes, flops, dtype)
    row.update(ms=kernel_ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bms, bound_by=by,
               tflops=flops / kernel_ms / 1e9)
    return row


def decode_mask(b, s, length, gen, lo=600, hi=3200):
    """(b, 1, s, L) bool: row i of slot n sees positions <= pos_n + i, pos_n
    drawn in [lo, hi) as the engine's slots sit after prompts of 600-3000
    tokens; the last row is an idle slot pinned at L - 1, as the engine
    pins it."""
    pos = torch.randint(lo, hi, (b,), device="cuda", generator=gen)
    pos[-1] = length - s
    ar = torch.arange(length, device="cuda")
    rows = pos[:, None] + torch.arange(s, device="cuda")[None, :]
    return ar[None, None, None, :] <= rows[:, None, :, None]


def _qca_inputs(qa, kv, b, hq, hkv, s, length, d, dtype, gen, lo, hi):
    q = torch.randn(b, hq, s, d, device="cuda", generator=gen).to(dtype)
    k = torch.randn(b, hkv, length, d, device="cuda", generator=gen)
    v = torch.randn(b, hkv, length, d, device="cuda", generator=gen)
    kc, vc = kv.QuantizedKV(*kv.quantize_kv(k)), kv.QuantizedKV(*kv.quantize_kv(v))
    return q, kc, vc, decode_mask(b, s, length, gen, lo, hi)


def qca_case(qa, kv, name, b, hq, hkv, s, length, d, dtype, gen, lo=600, hi=3200,
             blind=False, timing=True):
    """Kernel #10 against its plain version, each element to its row's scale,
    and a second launch through ``_launch`` into an output and a scratch
    filled with NaN, bitwise equal to the first (the counters zeroed by the
    scores kernel, every score, statistic and partial read written first,
    the runs summed in a fixed order); the library call is SDPA over a bf16
    cache of the same length (another function: it reads twice the cache
    bytes, all L positions). ``blind``: the first slot's first query row
    sees no position (p = 1 / L everywhere, as -1e30 scores give)."""
    q, kc, vc, mask = _qca_inputs(qa, kv, b, hq, hkv, s, length, d, dtype, gen, lo, hi)
    if blind:
        mask[0, :, 0] = False
    with torch.inference_mode():
        out = qa.quantized_cache_attention(q, kc, vc, mask)
        ref = qa.quantized_cache_attention_plain(q, kc, vc, mask)
        again = torch.full_like(out, float("nan"))
        ws = torch.full((qa._workspace_bytes(b, hkv, (hq // hkv) * s, length, d),),
                        255, dtype=torch.uint8, device="cuda")
        qa._launch(q, kc, vc, mask, again, ws)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        rel_err = row_relative_error(out, ref)
        tol = ROW_RELATIVE_BAR["quantized_cache_attention", dtype]
        deterministic = bool(torch.equal(out, again))
        row = dict(kernel="quantized_cache_attention", case=name,
                   shape=[b, hq, hkv, s, length, d], dtype=str(dtype).replace("torch.", ""),
                   max_abs_err=err, rel_err=rel_err, tol=tol,
                   deterministic=deterministic, ok=bool(rel_err <= tol and deterministic))
        if not timing:
            return row
        call = lambda: qa.quantized_cache_attention(q, kc, vc, mask)
        call_ms = time_ms(call, 1)
        reps = reps_for(call_ms)
        call_ms = time_ms(call, reps)  # the host's wrapper time, where it is longer
        kernel_ms = device_ms(call, "quantized_cache_attention")
        plain_ms = time_ms(lambda: qa.quantized_cache_attention_plain(q, kc, vc, mask),
                           max(3, reps // 4))
        group = hq // hkv
        kb = kc.dequantize(torch.bfloat16).repeat_interleave(group, dim=1)
        vb = vc.dequantize(torch.bfloat16).repeat_interleave(group, dim=1)
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
            q.to(torch.bfloat16), kb, vb, attn_mask=mask), reps)
        # the positions some row of a slot sees: the rows the kernel reads
        seen = int(mask.any(dim=2).sum().item())  # sum over slots
    nbytes = seen * hkv * (2 * d + 8) + mask.numel() + (q.numel() + out.numel()) * q.element_size()
    flops = 4.0 * seen * hkv * group * s * d
    bms, by = bound_ms(nbytes, flops, torch.bfloat16)
    row.update(ms=kernel_ms, call_ms=call_ms, plain_ms=plain_ms, library_ms=lib_ms,
               library="SDPA over a bf16 cache (2x the bytes, all positions)", bound_ms=bms,
               bound_by=by)
    return row


# Kernel #10's cases: the LM decode tick (33 slots x 12 heads, 4096
# positions), a verify window, a GQA group, head width 128, a slot whose
# first query row sees nothing, and, in bf16 (the LM's decode dtype),
# caches the old whole-row block refused: 8 query rows over 8,192
# positions, one row over 32,768 (positions spread over the whole cache).
# Not in fp32: rows that see 1,000-8,000 positions reach p = 0.05, where
# one bf16 tie of p x v_scale, rounded to another side by any other order
# of the fp32 sums, moves an element by 2^-8 p |v|, past fp32's 2^-9
# (PERF.md: on the draw that failed, the plain version was 2.7e-3
# from a float64 softmax rounded as both round it, the kernel 6.0e-4).
QCA_CASES = [
    ("decode", 33, 12, 12, 1, 4096, 64, {}),
    ("verify_window", 8, 12, 12, 5, 4096, 64, {}),
    ("gqa_group4", 8, 12, 3, 2, 4096, 64, {}),
    ("head_width_128", 8, 8, 8, 1, 2048, 128, {}),
    ("rows_8_len_8192", 8, 12, 12, 8, 8192, 64, {"lo": 1000, "hi": 8000, "bf16_only": True}),
    ("len_32768", 4, 12, 12, 1, 32768, 64, {"lo": 4000, "hi": 32000, "bf16_only": True}),
    ("row_sees_nothing", 4, 4, 4, 2, 1024, 64, {"lo": 100, "hi": 800, "blind": True}),
]


def check_qca_kernel(qa, kv, dtypes=(torch.bfloat16, torch.float32), timing=True):
    """Kernel #10 at ``QCA_CASES`` in each dtype (the long caches in bf16)."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = []
    for dtype in dtypes:
        for name, b, hq, hkv, s, length, d, kw in QCA_CASES:
            kw = dict(kw)
            if kw.pop("bf16_only", False) and dtype != torch.bfloat16:
                continue
            row = qca_case(qa, kv, name, b, hq, hkv, s, length, d, dtype, gen, timing=timing, **kw)
            print("kernel_check " + json.dumps(row), flush=True)
            rows.append(row)
            torch.cuda.empty_cache()
    return rows


def flash_threshold(fa, attn, gen, heads=12, d=64, batch=8):
    """Kernel #6 against the port's plain path at S = 32 to 1024, bf16
    causal at the LM's heads: the numbers FLASH_MIN_SEQ is set from."""
    rows = []
    with torch.inference_mode():
        for s in (32, 64, 128, 256, 512, 1024):
            q, k, v = (torch.randn(batch, heads, s, d, device="cuda", generator=gen)
                       .to(torch.bfloat16) for _ in range(3))
            flash = lambda: fa.flash_attention_forward(q, k, v, causal=True)
            plain = lambda: attn.attention_plain(q, k, v, is_causal=True)
            reps = reps_for(time_ms(flash, 1))
            rows.append({"seq": s, "flash_ms": time_ms(flash, reps),
                         "plain_ms": time_ms(plain, reps)})
    return rows


# Kernel #6's cases: the LM prefill call, a train step's call (with and
# without packed documents), Sq != Sk, the masks, the 128-query tile's edges
# (Sq 127, 129, 191) and the other routes (bias, head widths 32 and 128).
FLASH_CASES = [
    ("prefill", 8, 12, 2048, 2048, 64, True, {}),
    ("train", 8, 12, 8192, 8192, 64, True, {"lse": True}),
    ("train_segment_ids", 8, 12, 8192, 8192, 64, True, {"lse": True, "segments": True}),
    ("sq512_sk2048", 8, 12, 512, 2048, 64, True, {}),
    ("non_causal", 4, 12, 1024, 1024, 64, False, {}),
    ("segment_ids", 4, 12, 1024, 1024, 64, True, {"segments": True}),
    ("bias_1h1k", 4, 12, 1024, 1024, 64, True, {"bias_kind": "1h1k"}),
    ("bias_b1qk", 4, 12, 1024, 1024, 64, False, {"bias_kind": "b1qk"}),
    ("lse", 4, 12, 1024, 1024, 64, True, {"lse": True}),
    ("ragged_1000", 4, 12, 1000, 1000, 64, True, {"lse": True}),
    ("sq127", 4, 12, 127, 127, 64, True, {"lse": True}),
    ("sq129_segment_ids", 4, 12, 129, 129, 64, True, {"lse": True, "segments": True}),
    ("sq191_sk300", 4, 12, 191, 300, 64, True, {"lse": True}),
    ("sq191_non_causal", 4, 12, 191, 191, 64, False, {}),
    ("head_width_32", 4, 12, 1024, 1024, 32, True, {}),
    ("head_width_128", 4, 12, 1024, 1024, 128, True, {}),
]


def check_flash_fwd_kernel(fa, dtypes=(torch.bfloat16, torch.float32), timing=True):
    """Kernel #6 at ``FLASH_CASES`` in each dtype (the train step's shapes
    in bf16 only, the dtype it runs in)."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = []
    for dtype in dtypes:
        for name, b, h, sq, sk, d, causal, kw in FLASH_CASES:
            if name.startswith("train") and dtype != torch.bfloat16:
                continue
            row = flash_case(fa, name, b, h, sq, sk, d, causal, dtype, gen, timing=timing, **kw)
            print("kernel_check " + json.dumps(row), flush=True)
            rows.append(row)
            torch.cuda.empty_cache()
    return rows


def check_new_kernels(fa, qa, kv):
    """The cases of kernels #6 and #10 (LM prefill, train and decode
    shapes)."""
    print("kernel_check tolerance #6, #10: row_relative_error (the largest |got - ref| / "
          "(|ref| + rms of ref's row)) within " + json.dumps(
              {f"{k}/{str(d).replace('torch.', '')}": v for (k, d), v in ROW_RELATIVE_BAR.items()}),
          flush=True)
    return check_flash_fwd_kernel(fa) + check_qca_kernel(qa, kv)


# Bars of row_relative_error for kernels #7-#9 (dq by query row, dk and dv by
# key row, the bias gradient ds by query row, each with its terms' scale),
# keyed on the output's dtype: dq, dk and dv come back in the inputs' dtype,
# ds in fp32 whatever the inputs (as the TPU kernel writes it). Set from the
# readings in PERF.md (its LM training findings).
ROW_RELATIVE_BAR_BWD = {torch.bfloat16: 2.0 ** -6, torch.float32: 2.0 ** -15}


def bwd_readings(got, ref, terms):
    """row_relative_error of each output with its terms, and, to show what
    the terms let through, without them: over every element, and over the
    elements that are no cancellation (|ref| at least 2^-8 of their terms)."""
    rel = {n: row_relative_error(got[n], ref[n], terms[n]) for n in got}
    no_terms = {n: [row_relative_error(got[n], ref[n]), row_relative_error(
        got[n], ref[n], keep=ref[n].float().abs() >= 2.0 ** -8 * terms[n])] for n in got}
    return rel, no_terms


def _bwd_inputs(b, h, sq, sk, d, dtype, gen, bias_kind, segments):
    """q, k, v as #6's cases make them; do in (B, Sq, H, D) storage, as the
    gradient of #6's output arrives."""
    q, k, v = (torch.randn(b, h, s, d, device="cuda", generator=gen).to(dtype)
               for s in (sq, sk, sk))
    do = torch.randn(b, sq, h, d, device="cuda", generator=gen).to(dtype).transpose(1, 2)
    bias = None
    if bias_kind == "1h1k":  # ALiBi-style per-head key ramp
        bias = -0.05 * torch.rand(1, h, 1, 1, device="cuda", generator=gen) * torch.arange(
            sk, device="cuda")[None, None, None, :]
    elif bias_kind == "b1qk":
        bias = torch.randn(b, 1, sq, sk, device="cuda", generator=gen)
    seg = _segments(b, sq, gen) if segments else None
    return q, k, v, do, bias, seg


def bwd_terms(fa, q, k, v, out, do, lse, dlse, bias, causal, seg, parts):
    """Each backward output element's sum over the absolute values of its
    terms, for ``row_relative_error``: with a_ij = p_ij (|do_i| . |v_j| +
    |do_i| . |o_i| + |dlse_i| log2(e)), the size of the terms of ds_ij = p_ij
    (do_i . v_j - delta_i), dq_i sums a_ij |k_j| scale, dk_j sums a_ij |q_i|
    scale, dv_j sums p_ij |do_i|, and ds_ij is a_ij."""
    d = q.shape[-1]
    scale = d ** -0.5
    s2 = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * (scale * fa.LOG2E)
    if bias is not None:
        s2 = s2 + fa._as_4d_bias(bias) * fa.LOG2E
    visible = fa._visible(q.shape[2], k.shape[2], causal, seg, seg, q.device)
    lse = torch.where(lse == -math.inf, math.inf, lse)
    p = torch.where(visible, torch.exp2(s2 - lse[..., None]), 0.0)
    del s2
    row = (do.float().abs() * out.float().abs()).sum(-1)
    if dlse is not None:
        row = row + dlse.abs() * fa.LOG2E
    a = p * (torch.einsum("bhqd,bhkd->bhqk", do.float().abs(), v.float().abs()) + row[..., None])
    terms = {}
    if "dq" in parts:
        terms["dq"] = torch.einsum("bhqk,bhkd->bhqd", a, k.float().abs()) * scale
    if "dk" in parts:
        terms["dk"] = torch.einsum("bhqk,bhqd->bhkd", a, q.float().abs()) * scale
    if "dv" in parts:
        terms["dv"] = torch.einsum("bhqk,bhqd->bhkd", p, do.float().abs())
    if "ds" in parts:
        terms["ds"] = a
    return terms


def flash_bwd_case(fa, name, b, h, sq, sk, d, causal, dtype, gen, bias_kind=None,
                   segments=False, dbias=False, lse_cot=False):
    """``flash_attention_bwd`` (#7 + #8 as one call; and #9 with ``dbias``)
    against the plain backward on the same inputs, each output element to
    its row's scale; with ``lse_cot`` through ``flash_attention_lse``'s
    autograd with both cotangents. Without it the call is launched again
    through ``_flash_bwd_launch`` into dq, dk, dv and a dq workspace filled
    with NaN first: dk and dv must come back bitwise equal to the first
    call's (no element left unwritten, no workspace read before its
    zero-fill), dq within its bar (its sum over key blocks has no fixed
    order on the one-pass route)."""
    q, k, v, do, bias, seg = _bwd_inputs(b, h, sq, sk, d, dtype, gen, bias_kind, segments)
    kw = dict(causal=causal, q_segment_ids=seg, kv_segment_ids=seg)
    relaunch = {}
    if lse_cot:
        qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
        out, lse = fa.flash_attention_lse(qg, kg, vg, causal)
        glse = torch.randn(lse.shape, device="cuda", generator=gen)
        gq, gk, gv = torch.autograd.grad((out, lse), (qg, kg, vg), (do, glse))
        got = {"dq": gq, "dk": gk, "dv": gv}
        with torch.no_grad():
            dlse = torch.where(torch.isfinite(lse), glse, 0.0)
            out, lse = out.detach(), lse.detach()
            ref = dict(zip(("dq", "dk", "dv"), fa.flash_attention_bwd_plain(
                q, k, v, out, lse, do, causal=causal, dlse=dlse)))
            terms = bwd_terms(fa, q, k, v, out, do, lse, dlse, None, causal, None,
                              ("dq", "dk", "dv"))
    else:
        with torch.no_grad():
            out, lse = fa.flash_attention_forward(q, k, v, bias, return_lse=True, **kw)
            delta = fa._delta(out, do, None)
            got = dict(zip(("dq", "dk", "dv"),
                           fa.flash_attention_bwd(q, k, v, do, lse, delta, bias, **kw)))
            again = [fa._grad_like(t).fill_(math.nan) for t in (q, k, v)]
            ws = fa._dq_workspace(q)
            acc = None if ws is None else torch.full(ws, math.nan, device="cuda")
            fa._flash_bwd_launch(q, k, v, do, lse, delta, bias, *again, acc, sm_scale=None, **kw)
            relaunch["dq"] = again[0]
            relaunch["same"] = all(torch.equal(x, got[n]) for x, n in zip(again[1:], ("dk", "dv")))
            del again, acc
            parts = ("dq", "dk", "dv")
            if dbias:
                got["ds"] = fa.flash_attention_bwd_dbias(q, k, v, do, lse, delta, bias, **kw)
                parts += ("ds",)
            ref = fa._bwd_plain_parts(q, k, v, do, lse, delta, bias, causal, None, seg, seg,
                                      parts)
            terms = bwd_terms(fa, q, k, v, out, do, lse, None, bias, causal, seg, parts)
    torch.cuda.synchronize()
    rel, no_terms = bwd_readings(got, ref, terms)
    err = {n: (got[n].float() - ref[n].float()).abs().max().item() for n in got}
    tol = {n: ROW_RELATIVE_BAR_BWD[got[n].dtype] for n in got}
    ok = all(rel[n] <= tol[n] for n in rel)
    extra = {}
    if relaunch:
        rel_dq = row_relative_error(relaunch["dq"], ref["dq"], terms["dq"])
        extra = dict(deterministic=relaunch["same"], relaunch_dq_rel_err=rel_dq)
        ok = ok and relaunch["same"] and rel_dq <= tol["dq"]
    return dict(kernel="flash_attention_bwd", case=name, shape=[b, h, sq, sk, d], causal=causal,
                bias=bias_kind, segments=segments, dbias=dbias, lse_cotangent=lse_cot,
                dtype=str(dtype).replace("torch.", ""), rel_err=rel, max_abs_err=err, tol=tol,
                rel_err_no_terms=no_terms, **extra, ok=ok)


def check_bwd_kernels(fa, dtypes=(torch.bfloat16, torch.float32)):
    """The cases of the backward (#7 + #8 as one call, #9): the LM prefill
    shape causal and #6's variants; head widths 32, 96 and 128 take the
    other routes."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    cases = []
    for dtype in dtypes:
        cases.append(flash_bwd_case(fa, "prefill", 8, 12, 2048, 2048, 64, True, dtype, gen))
        cases.append(flash_bwd_case(fa, "sq512_sk2048", 8, 12, 512, 2048, 64, True, dtype, gen))
        cases.append(flash_bwd_case(fa, "non_causal", 4, 12, 1024, 1024, 64, False, dtype, gen))
        cases.append(flash_bwd_case(fa, "segment_ids", 4, 12, 1024, 1024, 64, True, dtype, gen,
                                    segments=True))
        cases.append(flash_bwd_case(fa, "bias_1h1k_dbias", 4, 12, 1024, 1024, 64, True, dtype,
                                    gen, bias_kind="1h1k", dbias=True))
        cases.append(flash_bwd_case(fa, "bias_b1qk_dbias", 4, 12, 1024, 1024, 64, False, dtype,
                                    gen, bias_kind="b1qk", dbias=True))
        cases.append(flash_bwd_case(fa, "ragged_1000", 4, 12, 1000, 1000, 64, True, dtype, gen,
                                    dbias=True))
        cases.append(flash_bwd_case(fa, "head_width_32", 4, 12, 1024, 1024, 32, True, dtype, gen))
        cases.append(flash_bwd_case(fa, "head_width_128", 4, 12, 1024, 1024, 128, True, dtype,
                                    gen))
        cases.append(flash_bwd_case(fa, "head_width_96", 2, 4, 300, 300, 96, True, dtype, gen,
                                    bias_kind="1h1k", dbias=True))
        cases.append(flash_bwd_case(fa, "lse_cotangent", 4, 12, 1000, 1000, 64, True, dtype,
                                    gen, lse_cot=True))
    print("kernel_check tolerance #7-#9: row_relative_error with the terms, by the output's "
          "dtype (ds is fp32 in every case), within " + json.dumps(
              {str(k).replace("torch.", ""): v for k, v in ROW_RELATIVE_BAR_BWD.items()}),
          flush=True)
    for c in cases:
        print("kernel_check " + json.dumps(c), flush=True)
    return cases


def flash_bwd_timing(fa, b=8, h=12, s=8192, d=64):
    """``flash_attention_bwd`` (#7 + #8 as one call: zero-fill, the one-pass
    kernel and dq's conversion) and #9 at the LM training shape, bf16 causal
    (#9 with an ALiBi-style (1, H, 1, S) bias, the case that differentiates
    one): each held against the plain backward (run a batch row at a time:
    its (S, S) fp32 matrices of all 8 rows would not fit) and timed beside
    the plain version, the SDPA backward (dq, dk and dv in one call, timed
    only) and the card's bound. The bound of the call counts the five
    products that the function needs (s, dp, dv, dk, dq: 10 d FLOPs a
    visible pair), and bytes as q, k, v, do, lse and delta read once and dq,
    dk, dv written once. The library time of #9 is the SDPA backward with a
    differentiable float mask (ALiBi plus the causal -inf), on the
    memory-efficient backend: it returns the mask's gradient, the full
    (B, H, S, S) ds summed to the mask's shape, with dq, dk and dv."""
    gen = torch.Generator(device="cuda").manual_seed(8)
    dtype = torch.bfloat16
    q, k, v, do, _, _ = _bwd_inputs(b, h, s, s, d, dtype, gen, None, False)
    alibi = -0.05 * torch.rand(1, h, 1, 1, device="cuda", generator=gen) * torch.arange(
        s, device="cuda")[None, None, None, :]
    pairs = b * h * s * (s + 1) // 2
    es = q.element_size()
    io = 4 * q.numel() * es + 2 * b * h * s * 4  # q, k, v, do, lse, delta
    rows = []
    with torch.no_grad():
        for name, bias in (("flash_attention_bwd", None), ("flash_attention_bwd_dbias", alibi)):
            out, lse = fa.flash_attention_forward(q, k, v, bias, causal=True, return_lse=True)
            delta = fa._delta(out, do, None)
            args = (q, k, v, do, lse, delta, bias)
            fn = getattr(fa, name)
            parts = ("dq", "dk", "dv") if name == "flash_attention_bwd" else ("ds",)
            got = fn(*args, causal=True)
            got = dict(zip(parts, got if len(parts) > 1 else (got,)))
            tol = {n: ROW_RELATIVE_BAR_BWD[got[n].dtype] for n in parts}
            rel, err = {n: 0.0 for n in parts}, {n: 0.0 for n in parts}
            no_terms = {n: [0.0, 0.0] for n in parts}

            def plain(i):
                return fa._bwd_plain_parts(q[i:i + 1], k[i:i + 1], v[i:i + 1], do[i:i + 1],
                                           lse[i:i + 1], delta[i:i + 1], bias, True, None,
                                           None, None, parts)

            for i in range(b):
                ref = plain(i)
                terms = bwd_terms(fa, q[i:i + 1], k[i:i + 1], v[i:i + 1], out[i:i + 1],
                                  do[i:i + 1], lse[i:i + 1], None, bias, True, None, parts)
                rel_i, no_terms_i = bwd_readings({n: got[n][i:i + 1] for n in parts}, ref, terms)
                for n in parts:
                    rel[n] = max(rel[n], rel_i[n])
                    no_terms[n] = [max(a, b) for a, b in zip(no_terms[n], no_terms_i[n])]
                    err[n] = max(err[n], (got[n][i:i + 1].float() - ref[n].float()).abs()
                                 .max().item())
                del ref, terms
            del got
            kernel_ms = time_ms(lambda: fn(*args, causal=True), 1, warmup=1)
            kernel_ms = time_ms(lambda: fn(*args, causal=True), reps_for(kernel_ms), warmup=1)
            plain_ms = time_ms(lambda: [plain(i) for i in range(b)], 2, warmup=1)
            if name == "flash_attention_bwd":
                flops, nbytes = 10.0 * d * pairs, io + 3 * q.numel() * es
            else:
                flops, nbytes = 4.0 * d * pairs, io + alibi.numel() * 4 + b * h * s * s * 4
            bms, by = bound_ms(nbytes, flops, dtype)
            rows.append(dict(kernel=name, case="train", shape=[b, h, s, s, d], causal=True,
                             dtype="bfloat16", rel_err=rel, max_abs_err=max(err.values()),
                             max_abs_err_by_part=err, tol=tol, rel_err_no_terms=no_terms,
                             ok=all(rel[n] <= tol[n] for n in rel), ms=kernel_ms,
                             plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                             tflops=flops / kernel_ms / 1e9))
            del out, lse, delta, args
            torch.cuda.empty_cache()
    qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
    o = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
    lib_ms = time_ms(lambda: torch.autograd.grad(o, (qg, kg, vg), do, retain_graph=True), 3)
    del o
    from torch.nn.attention import SDPBackend, sdpa_kernel

    mask = (alibi + torch.full((s, s), -math.inf, device="cuda").triu(1)).to(dtype)
    mask.requires_grad_()
    with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
        o = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask.expand(b, h, s, s))
        lib_ds_ms = time_ms(lambda: torch.autograd.grad(o, (mask, qg, kg, vg), do,
                                                        retain_graph=True), 3)
    del o, mask
    torch.cuda.empty_cache()
    for r in rows:
        dbias = r["kernel"].endswith("dbias")
        r["library_ms"] = lib_ds_ms if dbias else lib_ms
        r["library"] = ("SDPA backward with a differentiable float mask, memory-efficient "
                        "backend (ds summed to the mask's shape, dq, dk and dv in one call)"
                        if dbias else "SDPA backward (dq, dk and dv in one call)")
        print("kernel_check " + json.dumps(r), flush=True)
    return rows


def check_kernels(fe):
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = []
    for dtype in (torch.bfloat16, torch.float32):
        cases.append(attention_case(fe, "vision", BATCH, 50, 768, 12, False, dtype, False, gen))
        cases.append(attention_case(fe, "text", BATCH, 77, 512, 8, True, dtype, False, gen))
        cases.append(attention_case(fe, "key_bias", 8, 40, 256, 4, False, dtype, True, gen))
        cases.append(attention_case(fe, "key_bias_causal", 8, 77, 256, 4, True, dtype, True, gen))
        cases.append(attention_case(fe, "head_width_96", 8, 50, 384, 4, True, dtype, False, gen))
    print("kernel_check tolerance: " + " ".join(tolerance.__doc__.split()), flush=True)
    for c in cases:
        print("kernel_check " + json.dumps(c), flush=True)
    return cases + check_attention_bwd_kernel(fe) + check_mlp_bwd_kernel(fe)


# Faults planted in copies of the kernels' sources (under build/, never in
# the checkout's sources): (source, the kernel function's signature, text,
# replacement).
PLANTED_FAULTS = {
    "attention bwd: the ragged last key tile unmasked (padded keys' bias 0)": (
        "fused_qkv_attention_bwd.cu", "qkv_attention_bwd_wgmma_kernel(const __grid_constant__",
        ": 0.f) : -INFINITY;", ": 0.f) : 0.f;"),
    "quantized attention: the merge drops the last run": (
        "quantized_cache_attention.cu", "quantized_cache_attention_values_kernel(QArgs a)",
        "for (int k = 0; k < a.runs; ++k) o +=", "for (int k = 0; k < a.runs - 1; ++k) o +="),
    "bwd: one key past the causal diagonal": (
        "flash_attention_bwd.cu", "flash_bwd_wgmma_kernel(const __grid_constant__",
        "visible(a, b, i, j)",
        "(visible(a, b, i, j) || (a.causal && j == i + 1 + off && (!a.qseg || "
        "a.qseg[b * a.qseg_b + i] == a.kvseg[b * a.kvseg_b + j])))"),
    "bwd: the ragged last query tile dropped": (
        "flash_attention_bwd.cu", "flash_bwd_wgmma_kernel(const __grid_constant__",
        "const int nq = (a.Sq + kWgTile - 1) / kWgTile;", "const int nq = a.Sq / kWgTile;"),
    "bwd: delta left out of ds": (
        "flash_attention_bwd.cu", "flash_bwd_wgmma_kernel(const __grid_constant__",
        "pe * (dpt[4 * n + e] - ((e & 1) ? d2.y : d2.x))", "pe * dpt[4 * n + e]"),
    "bwd: key block 0's dq part not added": (
        "flash_attention_bwd.cu", "void add_dq_part(const float (&dq)[16]",
        "if (issuer) wg::tma_reduce_add_3d(",
        "if (issuer && blockIdx.x != 0) wg::tma_reduce_add_3d("),
    "bwd: the dq workspace not zero-filled": (
        "flash_attention_bwd.cu", "cudaError_t launch_wgmma(",
        "cudaMemsetAsync(ws, 0, bytes, st)", "cudaSuccess"),
    "acc: the first row run's dW partial left out of the sum": (
        "fused_mlp_bwd_acc.cu", "fused_mlp_bwd_acc_sum_kernel(const float*",
        "for (int c = 0; c < splits; ++c)", "for (int c = 1; c < splits; ++c)"),
    "acc: the last 16 rows of every k-block left out of dW": (
        "fused_mlp_bwd_acc.cu", "fused_mlp_bwd_acc_dw_kernel(const __grid_constant__",
        "for (int kk = 0; kk < BK / 16; ++kk) wg::mma_step<wg::MN, wg::MN>",
        "for (int kk = 0; kk < BK / 16 - 1; ++kk) wg::mma_step<wg::MN, wg::MN>"),
    "acc: act' left out of da": (
        "mlp_bwd_common.cuh", "void zdh_stage(const ZdhParams& p",
        "const float da0 = dh[4 * j + 2 * hf] * d0;", "const float da0 = dh[4 * j + 2 * hf];"),
    "mlp_bwd: act' left out of da's odd columns": (
        "mlp_bwd_common.cuh", "void zdh_stage(const ZdhParams& p",
        "const float da1 = dh[4 * j + 2 * hf + 1] * d1;",
        "const float da1 = dh[4 * j + 2 * hf + 1];"),
    "mlp_bwd: the first Dff run left out of dx's sum": (
        "fused_mlp_bwd.cu", "fused_mlp_bwd_dx_sum_kernel(const float4*",
        "for (int r = 0; r < splits; ++r)", "for (int r = 1; r < splits; ++r)"),
    "fwd: one key past the causal diagonal": (
        "flash_attention_fwd.cu", "void mask_tile(float (&s)[64]",
        "(!a.causal || key <= r0 + 8 * hh + off)", "(!a.causal || key <= r0 + 8 * hh + 1 + off)"),
    "fwd: the ragged last query tile not stored": (
        "flash_attention_fwd.cu", "flash_fwd_wgmma_kernel(const __grid_constant__",
        "if (i >= a.Sq) continue;", "if (i >= a.Sq / kWgRows * kWgRows) continue;"),
    "fwd: alpha left out of the O rescale": (
        "flash_attention_fwd.cu", "void flash_tile(const WgParams& p",
        "for (int x = 0; x < 32; ++x) o[x] *= alpha[(x >> 1) & 1];",
        "for (int x = 0; x < 32; ++x) o[x] *= 1.f;"),
    "mlp: b1 left out of stage H's epilogue": (
        "fused_mlp.cu", "gemm_tiles(const GemmParams& p)",
        "const float bias0 = to_f(p.bias[c]), bias1 = to_f(p.bias[c + 1]);",
        "const float bias0 = ACT < 0 ? to_f(p.bias[c]) : 0.f, "
        "bias1 = ACT < 0 ? to_f(p.bias[c + 1]) : 0.f;"),
    "mlp: stage H's last ragged row tile of h not stored": (
        "fused_mlp.cu", "gemm_tiles(const GemmParams& p)", "if (r < p.R)",
        "if (r < (ACT >= 0 ? p.R / BM * BM : p.R))"),
    "mlp: stage O's last ragged row tile of the output not stored": (
        "fused_mlp.cu", "gemm_tiles(const GemmParams& p)", "if (r < p.R)",
        "if (r < (ACT < 0 ? p.R / BM * BM : p.R))"),
}
# For each patched source: the sources its copy builds (its wrappers bind
# their symbols) and the bf16 checks that run against it. The MLP backward's
# shared stages (mlp_bwd_common.cuh) run under both #4's checks and #5's.
_MLP_SOURCES = ("fused_qkv_attention.cu", "fused_qkv_attention_bwd.cu", "fused_mlp.cu",
                "fused_mlp_bwd.cu", "fused_mlp_bwd_acc.cu")
PLANTED_FAULT_CHECKS = {
    "fused_qkv_attention_bwd.cu": (
        _MLP_SOURCES,
        "from multimodal_tpu_torch.ops import fused_encoder as fe; "
        "cs.check_attention_bwd_kernel(fe, (torch.bfloat16,), timing=False)"),
    "quantized_cache_attention.cu": (
        ("quantized_cache_attention.cu",),
        "from multimodal_tpu_torch.ops import kv_cache as kv, quantized_attention as qa; "
        "cs.check_qca_kernel(qa, kv, (torch.bfloat16,), timing=False)"),
    "flash_attention_fwd.cu": (
        ("flash_attention_fwd.cu", "flash_attention_bwd.cu"),
        "from multimodal_tpu_torch.ops import flash_attention as fa; "
        "cs.check_flash_fwd_kernel(fa, (torch.bfloat16,), timing=False)"),
    "fused_mlp_bwd.cu": (
        _MLP_SOURCES,
        "from multimodal_tpu_torch.ops import fused_encoder as fe; "
        "cs.check_mlp_bwd_kernel(fe, (torch.bfloat16,), timing=False)"),
    "mlp_bwd_common.cuh": (
        _MLP_SOURCES,
        "from multimodal_tpu_torch.ops import fused_encoder as fe; "
        "cs.check_mlp_bwd_kernel(fe, (torch.bfloat16,), timing=False); "
        "cs.check_acc_kernel(fe, (torch.bfloat16,), timing=False)"),
    "flash_attention_bwd.cu": (
        ("flash_attention_fwd.cu", "flash_attention_bwd.cu"),
        "from multimodal_tpu_torch.ops import flash_attention as fa; "
        "cs.check_bwd_kernels(fa, (torch.bfloat16,))"),
    "fused_mlp_bwd_acc.cu": (
        _MLP_SOURCES,
        "from multimodal_tpu_torch.ops import fused_encoder as fe; "
        "cs.check_acc_kernel(fe, (torch.bfloat16,), timing=False)"),
    "fused_mlp.cu": (
        _MLP_SOURCES,
        "from multimodal_tpu_torch.ops import fused_encoder as fe; "
        "cs.check_mlp_kernel(fe, (torch.bfloat16,), timing=False)"),
}


def fault_readings(case) -> dict:
    """A failed case's readings: its relative errors by output, or its max
    abs error where the case has none (#4)."""
    rel = case.get("rel_err", {"max_abs_err": case["max_abs_err"]})
    return rel if isinstance(rel, dict) else {"out": rel}


def planted_faults() -> None:
    """Each fault of PLANTED_FAULTS in a copy of the package (only the
    sources its checks need, so the copy builds quickly) whose bf16 checks
    of that kernel (#6, the flash backward, #4, #5 or #3) run in a process
    of their own: a fault that no case catches fails the run."""
    import shutil
    from pathlib import Path

    root = Path(__file__).resolve().parent
    for n, (name, (source, signature, old, new)) in enumerate(PLANTED_FAULTS.items()):
        keep, check = PLANTED_FAULT_CHECKS[source]
        copy = root / "build" / "planted_faults" / str(n)
        shutil.rmtree(copy, ignore_errors=True)
        shutil.copytree(root / "multimodal_tpu_torch", copy / "multimodal_tpu_torch",
                        ignore=shutil.ignore_patterns("__pycache__"))
        shutil.copy(root / "chip_smoke.py", copy / "chip_smoke.py")
        csrc = copy / "multimodal_tpu_torch" / "csrc"
        for src in csrc.glob("*.cu"):
            if src.name not in keep:
                src.unlink()
        cu = csrc / source
        text = cu.read_text()
        start = text.index(signature)
        end = text.index("\n}\n", start)
        if text[start:end].count(old) != 1:
            fail(f"planted fault {name!r}: {old!r} is not once in {signature}")
        cu.write_text(text[:start] + text[start:end].replace(old, new) + text[end:])
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", "import torch, chip_smoke as cs; " + check],
                              cwd=copy, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
        checked = [json.loads(line[len("kernel_check "):]) for line in proc.stdout.splitlines()
                   if line.startswith("kernel_check {")]
        caught = [c for c in checked if not c["ok"]]
        print(f"planted fault {name!r}: {len(caught)} of {len(checked)} bf16 cases fail "
              f"({time.perf_counter() - t0:.0f} s): " + json.dumps(
                  {f"{c['kernel']}/{c['case']}": {
                      **{k: round(v, 4) for k, v in fault_readings(c).items()},
                      **({} if c.get("deterministic", True) else {"relaunch": "differs"})}
                   for c in caught}), flush=True)
        if proc.returncode != 0 or not checked:
            fail(f"planted fault {name!r}: the check did not run\n{proc.stdout[-3000:]}")
        if not caught:
            fail(f"planted fault {name!r}: no case caught it")
        shutil.rmtree(copy, ignore_errors=True)


# --------------------------------------------------------------------------
# --ab: kernels #2-#6 and #10, the flash attention backward and the LM
# serving tick, this checkout against another tree
# --------------------------------------------------------------------------

# The main paths' shapes of #3 and of #5, bf16.
AB_MLP = [("flava_image", 64 * 197, 768, 3072, 768, "gelu_exact"),
          ("flava_text", 64 * 77, 768, 3072, 768, "gelu_exact"),
          ("flava_mm", 64 * 275, 768, 3072, 768, "gelu_exact"),
          ("clip_vision", BATCH * 50, 768, 3072, 768, "quick_gelu"),
          ("clip_text", BATCH * 77, 512, 2048, 512, "quick_gelu"),
          ("lm_prefill", 8 * 2048, 768, 3072, 768, "gelu_exact"),
          ("lm_train", 8 * 8192, 768, 3072, 768, "gelu_exact"),
          ("lm_decode", 33, 768, 3072, 768, "gelu_exact")]
AB_ACC = [("flava_image", 64 * 197, 768, 3072, 768, "gelu_exact"),
          ("clip_vision", TRAIN_BATCH * 50, 768, 3072, 768, "quick_gelu"),
          ("lm_train", 8 * 8192, 768, 3072, 768, "gelu_exact")]


def ab_side() -> None:
    """One process of --ab, run with a tree of the repo first on sys.path:
    ms of that tree's #5 at AB_ACC's shapes and of its #3 at AB_MLP's (with
    each stage's, from the profiler, where its kernels have this checkout's
    names, and the host's time a call at the decode tick's rows), of its #4
    at FLAVA's gradient check's 394 image rows and CLIP's 12,800 vision
    rows, of its #6 at the LM's prefill and train shapes (8, 12, 2048 and
    8192, 64) bf16 causal, of its flash attention backward (``_flash_backward``: delta, dq, dk and dv) at
    the LM training shape (8, 12, 8192, 64) bf16 causal, of its #2 at
    CLIP's vision (256, 50) and causal text (256, 77) towers and ViT-B/16's
    (256, 197), of its #10 at the first four ``QCA_CASES`` (device time
    from the profiler, and the call on the events' clock), and the LM
    serving phase's ms a tick on the host clock and on the device. Prints
    one ``ab`` JSON line."""
    from multimodal_tpu_torch.ops import flash_attention as fa
    from multimodal_tpu_torch.ops import fused_encoder as fe
    from multimodal_tpu_torch.ops import kv_cache as kv
    from multimodal_tpu_torch.ops import quantized_attention as qa

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(7)
    out = {}
    with torch.inference_mode():
        # #5 first: its times then do not depend on what #3's version left
        # in the allocator and the caches
        for name, rows, din, dff, dout, act in AB_ACC:
            x, g, w1t, b1, w2t = _mlp_bwd_inputs(rows, din, dff, dout, torch.bfloat16, gen)
            fn = lambda: fe.fused_mlp_bwd_acc(x, g, w1t.t(), b1, w2t.t(), act)  # noqa: E731
            out[f"acc_{name}"] = time_ms(fn, reps_for(time_ms(fn, 1)))
            torch.cuda.empty_cache()
        for name, rows, din, dff, dout, act in AB_MLP:
            x, w1t, b1, w2t, b2 = _mlp_inputs(rows, din, dff, dout, torch.bfloat16, gen)
            fn = lambda: fe.fused_mlp(x, w1t.t(), b1, w2t.t(), b2, act)  # noqa: E731
            out[f"mlp_{name}"] = time_ms(fn, reps_for(time_ms(fn, 1)))
            out[f"mlp_{name}_stages"] = stage_ms(fn, MLP_STAGES)
            if rows == 33:  # the host's cost of one call at the decode tick's rows
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(200):
                    fn()
                out[f"mlp_{name}_host_us"] = (time.perf_counter() - t0) / 200 * 1e6
                torch.cuda.synchronize()
        # #4 at FLAVA's gradient check's image rows and CLIP's vision MLP
        for name, rows, act in (("flava_grad_image", 2 * 197, "gelu_exact"),
                                ("clip_vision", TRAIN_BATCH * 50, "quick_gelu")):
            x, g, w1t, b1, w2t = _mlp_bwd_inputs(rows, 768, 3072, 768, torch.bfloat16, gen)
            fn = lambda: fe.fused_mlp_bwd(x, g, w1t.t(), b1, w2t.t(), act)  # noqa: E731
            out[f"mlp_bwd_{name}"] = time_ms(fn, reps_for(time_ms(fn, 1)))
            torch.cuda.empty_cache()
        # #6 at the LM's prefill call and a train step's call (with lse)
        for name, s in (("prefill", 2048), ("train", 8192)):
            q, k, v = (torch.randn(8, 12, s, 64, device="cuda", generator=gen)
                       .to(torch.bfloat16) for _ in range(3))
            fn = lambda: fa.flash_attention_forward(  # noqa: E731
                q, k, v, causal=True, return_lse=name == "train")
            out[f"flash_fwd_{name}"] = time_ms(fn, reps_for(time_ms(fn, 1)))
            del q, k, v
            torch.cuda.empty_cache()
        q, k, v, do, _, _ = _bwd_inputs(8, 12, 8192, 8192, 64, torch.bfloat16, gen, None, False)
        o, lse = fa.flash_attention_forward(q, k, v, causal=True, return_lse=True)
        fn = lambda: fa._flash_backward(q, k, v, o, lse, do, causal=True,  # noqa: E731
                                        sm_scale=None)
        out["flash_backward_train"] = time_ms(fn, reps_for(time_ms(fn, 1)))
        del q, k, v, do, o, lse
        torch.cuda.empty_cache()
        # #2 at CLIP's vision and (causal) text towers and ViT-B/16's vision
        # tower, the train batch
        for name, s, d, h, causal in (("clip_vision", 50, 768, 12, False),
                                      ("clip_text", 77, 512, 8, True),
                                      ("vit_b16", 197, 768, 12, False)):
            qkv, g, _ = _attention_bwd_inputs(TRAIN_BATCH, s, d, torch.bfloat16, False, gen)
            fn = lambda: fe.fused_qkv_attention_bwd(qkv, g, h, causal)  # noqa: E731
            out[f"attn_bwd_{name}"] = time_ms(fn, reps_for(time_ms(fn, 1)))
            del qkv, g
            torch.cuda.empty_cache()
        # #10 at the four cases of the 4096-position cache
        for name, b, hq, hkv, s, length, d, _ in QCA_CASES[:4]:  # the 4096-long ones
            q, kc, vc, mask = _qca_inputs(qa, kv, b, hq, hkv, s, length, d, torch.bfloat16, gen,
                                          600, 3200)
            fn = lambda: qa.quantized_cache_attention(q, kc, vc, mask)  # noqa: E731
            out[f"qca_{name}"] = device_ms(fn, "quantized_cache_attention")
            out[f"qca_{name}_call"] = time_ms(fn, reps_for(time_ms(fn, 1)))
            del q, kc, vc, mask
            torch.cuda.empty_cache()

    _, res = lm_serve(fe, fa, qa, card_line())
    out["lm_ms_per_tick"] = res["ms_per_tick"]
    out["lm_device_ms_per_tick"] = res.get("device_ms_per_tick", "not measured")
    print("ab " + json.dumps(out), flush=True)


def ab(parent: str) -> None:
    """--ab PARENT: #2-#6, #10, the flash backward and the LM serving tick of
    another tree of the repo (PARENT: the parent commit, unpacked with git
    archive) and of this checkout, each side a process of its own, in turns: parent, checkout,
    checkout, parent, twice. The trees' kernels build in parallel first."""
    from pathlib import Path

    trees = {"parent": Path(parent).resolve(), "change": Path(__file__).resolve().parent}

    def run(name, code):
        return [sys.executable, "-c", f"import sys; sys.path.insert(0, {str(trees[name])!r}); "
                + code]

    t0 = time.perf_counter()
    procs = {n: subprocess.Popen(run(n, "from multimodal_tpu_torch.ops import _build; "
                                        "_build.build()"),
                                 stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for n in trees}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            fail(f"--ab: the {name} tree's kernels did not build\n{log[-3000:]}")
    print(f"ab: built {len(trees)} trees in {time.perf_counter() - t0:.1f} s", flush=True)
    results = {n: [] for n in trees}
    me = str(Path(__file__).resolve())
    for name in ("parent", "change", "change", "parent") * 2:
        proc = subprocess.run(
            run(name, "import importlib.util as u; "
                      f"s = u.spec_from_file_location('ab_side', {me!r}); "
                      "m = u.module_from_spec(s); s.loader.exec_module(m); "
                      "m.ab_side()"),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        lines = [line for line in proc.stdout.splitlines() if line.startswith("ab {")]
        if proc.returncode or not lines:
            fail(f"--ab: the {name} side failed\n{proc.stdout[-3000:]}")
        results[name].append(json.loads(lines[-1][3:]))
        print(f"ab {name}: {lines[-1][3:]}", flush=True)
        for line in proc.stdout.splitlines():
            if line.startswith("lm decode: top host ops"):
                print(f"ab {name} {line}", flush=True)
    first = results["change"][0]
    summary = {k: {n: [r.get(k) for r in rs] for n, rs in results.items()}
               for k, v in first.items() if isinstance(v, float)}
    print("ab summary (each side's runs in order): " + json.dumps(summary), flush=True)


# --------------------------------------------------------------------------
# phase 3: CLIP ViT-B/32 embedding serving
# --------------------------------------------------------------------------


def token_ids(rng, n):
    """(n, 77) ids as CLIP's tokenizer lays them out: SOT, words, EOT (the
    highest id), zero padding."""
    ids = np.zeros((n, 77), dtype=np.int64)
    for i in range(n):
        length = int(rng.integers(3, 76))
        ids[i, 0] = 49406
        ids[i, 1:length] = rng.integers(1, 49405, size=length - 1)
        ids[i, length] = 49407
    return ids


def cosine_rows(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    a = a.astype(np.float64)
    b = b.astype(np.float64)
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


def serve(fe, card):
    from multimodal_tpu_torch.models.clip.model import clip_vit_b32
    from multimodal_tpu_torch.ops.image import fused_preprocess_for_encoder
    from multimodal_tpu_torch.serving.embedding import EmbeddingServer

    t0 = time.perf_counter()
    model = clip_vit_b32(dtype=torch.bfloat16, seed=0)
    print(f"serve: built clip_vit_b32 bf16 in {time.perf_counter() - t0:.2f} s", flush=True)

    def encode_images(u8):
        return model.encode_image(fused_preprocess_for_encoder(u8, 224, dtype=torch.bfloat16))

    image_server = EmbeddingServer(encode_images, max_batch=256)
    text_server = EmbeddingServer(model.encode_text, max_batch=256)

    rng = np.random.default_rng(0)
    sizes = (1, 3, 64, 300)
    requests = [(rng.integers(0, 256, size=(n, 256, 256, 3), dtype=np.uint8),
                 token_ids(rng, n)) for n in sizes]
    # the one-row request reappears as row 0 of the largest: row alignment
    requests[-1][0][0] = requests[0][0][0]
    requests[-1][1][0] = requests[0][1][0]

    fe.reset_launch_counts()
    outs = [(image_server.encode(im), text_server.encode(tx)) for im, tx in requests]
    torch.cuda.synchronize()
    launches = {"fused_qkv_attention": fe.fused_qkv_attention.launches,
                "fused_mlp": fe.fused_mlp.launches}
    forwards = 2 * sum(math.ceil(n / 256) for n in sizes)  # both towers
    want = 12 * forwards
    print(f"serve: launches {launches}, want {want} each ({forwards} tower forwards x 12 layers)",
          flush=True)
    for k, v in launches.items():
        if v != want:
            fail(f"{k} launched {v} times on the main path, want {want}")

    for (im, tx), (ei, et), n in zip(requests, outs, sizes):
        if ei.shape != (n, 512) or et.shape != (n, 512):
            fail(f"request of {n}: embedding shapes {ei.shape}, {et.shape}")
        scores = ei @ et.T
        if not (np.isfinite(ei).all() and np.isfinite(et).all() and np.isfinite(scores).all()):
            fail(f"request of {n}: non-finite embeddings or scores")
        norms = np.linalg.norm(ei, axis=-1)
        if np.abs(norms - 1).max() > 1e-2:
            fail(f"request of {n}: image embeddings not unit norm ({norms.min()}..{norms.max()})")
    align = min(cosine_rows(outs[0][0][:1], outs[-1][0][:1]).min(),
                cosine_rows(outs[0][1][:1], outs[-1][1][:1]).min())
    print(f"serve: row alignment cosine (1-row request vs row 0 of 300) {align:.6f}", flush=True)
    if align < 0.999:
        fail(f"row alignment cosine {align} < 0.999")

    # 4 image and 4 text rows against the same weights in fp32 on the CPU
    ref_model = clip_vit_b32(device="cpu", dtype=torch.float32)
    ref_model.load_state_dict({k: v.float().cpu() for k, v in model.state_dict().items()})
    im, tx = requests[2]
    with torch.inference_mode():
        ref_i = ref_model.encode_image(fused_preprocess_for_encoder(
            torch.from_numpy(im[:4]), 224, dtype=torch.float32)).numpy()
        ref_t = ref_model.encode_text(torch.from_numpy(tx[:4])).numpy()
    cos_i = cosine_rows(outs[2][0][:4], ref_i)
    cos_t = cosine_rows(outs[2][1][:4], ref_t)
    min_cos = float(min(cos_i.min(), cos_t.min()))
    print(f"serve: cosine vs fp32 CPU: image {cos_i.round(6).tolist()} text "
          f"{cos_t.round(6).tolist()} min {min_cos:.6f} (bar 0.999)", flush=True)
    if min_cos < 0.999:
        fail(f"served embeddings reach cosine {min_cos} < 0.999 against fp32")

    # throughput at batch 512: device-resident inputs, and through the servers
    u8 = torch.from_numpy(rng.integers(0, 256, size=(BATCH, 256, 256, 3), dtype=np.uint8)).cuda()
    ids_np = token_ids(rng, BATCH)
    ids = torch.from_numpy(ids_np).cuda()

    def step():
        return encode_images(u8), model.encode_text(ids)

    with torch.inference_mode():
        step()
        torch.cuda.synchronize()
        iters = 5
        t0 = time.perf_counter()
        for _ in range(iters):
            step()
        torch.cuda.synchronize()
        device_rate = BATCH * iters / (time.perf_counter() - t0)
        breakdown = profile_step(step, "serve")
    host_u8 = u8.cpu().numpy()
    t0 = time.perf_counter()
    image_server.encode(host_u8)
    text_server.encode(ids_np)
    served_rate = BATCH / (time.perf_counter() - t0)
    print(f"serve: {device_rate:.1f} pairs/s at batch {BATCH} on device-resident inputs; "
          f"{served_rate:.1f} pairs/s through the servers from host arrays "
          f"(max_batch 256) on {card}", flush=True)
    print("serve: device time by kernel at batch 512 " + json.dumps(breakdown), flush=True)
    return launches, min_cos, device_rate, served_rate


def vit_l14_check(card):
    """CLIP ViT-L/14's image tower (S = 257, beyond the fused kernels) on the
    card at batch 8 in bf16 against the same weights in fp32 on the CPU."""
    from multimodal_tpu_torch.models.clip.model import clip_vit_l14
    from multimodal_tpu_torch.ops.image import fused_preprocess_for_encoder

    model = clip_vit_l14(dtype=torch.bfloat16, seed=0)
    u8 = torch.from_numpy(np.random.default_rng(3).integers(0, 256, size=(8, 256, 256, 3),
                                                            dtype=np.uint8))
    with torch.inference_mode():
        got = model.encode_image(fused_preprocess_for_encoder(u8.cuda(), 224,
                                                              dtype=torch.bfloat16))
        torch.cuda.synchronize()
        ref_model = clip_vit_l14(device="cpu", dtype=torch.float32)
        ref_model.load_state_dict({k: v.float().cpu() for k, v in model.state_dict().items()})
        ref = ref_model.encode_image(fused_preprocess_for_encoder(u8, 224, dtype=torch.float32))
    got = got.float().cpu().numpy()
    if got.shape != (8, 768) or not np.isfinite(got).all():
        fail(f"clip_vit_l14 image embeddings {got.shape}, finite {np.isfinite(got).all()}")
    cos = float(cosine_rows(got, ref.numpy()).min())
    print(f"vit_l14: image tower at S=257 on the card, min cosine vs fp32 CPU {cos:.6f} "
          "(bar 0.999)", flush=True)
    if cos < 0.999:
        fail(f"clip_vit_l14 embeddings reach cosine {cos} < 0.999 against fp32")
    return cos


# --------------------------------------------------------------------------
# phase 5: long-context LM serving (continuous batching, int8 KV cache)
# --------------------------------------------------------------------------

LM = dict(vocab_size=32768, max_seq_len=4096, n_layer=12, d_model=768, n_head=12,
          dim_feedforward=3072)  # bench.py's serving model


def lm_requests(rng, n):
    from multimodal_tpu_torch.serving.engine import Request

    out = []
    for i in range(n):
        length = int(rng.integers(600, 3001))  # buckets 1024, 2048 and 4096
        out.append(Request(rng.integers(0, LM["vocab_size"], size=length).tolist(),
                           max_new_tokens=int(rng.integers(32, 129)),
                           temperature=0.0 if i % 2 == 0 else 1.0, request_id=i))
    return out


def teacher_forced(model, prompt, feed, device):
    """Logits at the prompt's last position and at each of ``feed``'s
    decode steps: the prompt's keys and values go into a one-row int8 cache,
    then the fed tokens decode over it, as the engine does."""
    from multimodal_tpu_torch.ops.kv_cache import quantized_kv_zeros
    from multimodal_tpu_torch.serving.engine import _kv_set_rows

    length = 2048
    toks = torch.tensor([prompt], device=device)
    with torch.inference_mode():
        logits, kvs = model(toks, use_cache=True)
        rows = [logits[0, -1].float().cpu()]
        shape = (1, LM["n_head"], length, LM["d_model"] // LM["n_head"])
        cache = tuple((quantized_kv_zeros(shape, device), quantized_kv_zeros(shape, device))
                      for _ in range(LM["n_layer"]))
        slot = torch.zeros(1, dtype=torch.long, device=device)
        for (ck, cv), (k, v) in zip(cache, kvs):
            _kv_set_rows(ck, k, slot, len(prompt))
            _kv_set_rows(cv, v, slot, len(prompt))
        ar = torch.arange(length, device=device)
        for t, tok in enumerate(feed):
            pos = torch.tensor([len(prompt) + t], device=device)
            logits, _ = model(torch.tensor([[tok]], device=device), positions=pos[:, None],
                              past_key_values=cache, cache_index=pos,
                              attention_mask=(ar <= pos)[None, None, None, :], use_cache=True)
            rows.append(logits[0, 0].float().cpu())
    return torch.stack(rows).double()


def lm_serve(fe, fa, qa, card):
    from multimodal_tpu_torch.examples.long_context.model import long_context_lm
    from multimodal_tpu_torch.serving.engine import InferenceEngine

    t0 = time.perf_counter()
    model = long_context_lm(dtype=torch.bfloat16, seed=0, **LM)
    print(f"lm: built LongContextLM {LM} bf16 in {time.perf_counter() - t0:.2f} s", flush=True)
    engine_kw = dict(n_slots=32, max_len=4096, cache_dtype="int8", prefill_batch=8,
                     decode_steps=16, top_k=50)
    rng = np.random.default_rng(4)

    # warm-up: one request per bucket through a throwaway engine
    warm = InferenceEngine(model, **engine_kw)
    for r in lm_requests(rng, 3):
        r.max_new_tokens = 16
        warm.submit(r)
    warm.run()
    del warm
    torch.cuda.synchronize()

    engine = InferenceEngine(model, **engine_kw)
    timing = {"prefill": 0.0, "decode": 0.0}

    def timed(name, fn):
        def run(*args, **kw):
            t = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            timing[name] += time.perf_counter() - t
            return out
        return run

    engine._prefill = timed("prefill", engine._prefill)
    engine._decode = timed("decode", engine._decode)
    reqs = lm_requests(rng, 48)
    fe.reset_launch_counts()
    fa.reset_launch_counts()
    qa.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for r in reqs:
        engine.submit(r)
    outs = engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"flash_attention": fa.flash_attention_forward.launches,
                "quantized_cache_attention": qa.quantized_cache_attention.launches,
                "fused_mlp": fe.fused_mlp.launches}
    calls, ticks, layers = engine.prefill_calls, engine.ticks, LM["n_layer"]
    want = {"flash_attention": layers * calls, "quantized_cache_attention": layers * ticks,
            "fused_mlp": layers * (calls + ticks)}
    print(f"lm: launches {launches}, want {want} ({calls} prefill calls, {ticks} decode ticks, "
          f"{layers} layers)", flush=True)
    for k, v in launches.items():
        if v != want[k]:
            fail(f"{k} launched {v} times on the LM serving path, want {want[k]}")
    by_id = {o.request_id: o for o in outs}
    if len(by_id) != len(reqs):
        fail(f"{len(by_id)} of {len(reqs)} requests finished")
    for r in reqs:
        o = by_id[r.request_id]
        if o.finish_reason != "length" or len(o.tokens) != r.max_new_tokens:
            fail(f"request {r.request_id}: {o.finish_reason}, {len(o.tokens)} of "
                 f"{r.max_new_tokens} tokens")
        if not all(0 <= t < LM["vocab_size"] for t in o.tokens):
            fail(f"request {r.request_id}: token ids out of range")
    peak = torch.cuda.max_memory_allocated()
    prompt_tokens = sum(len(r.prompt) for r in reqs)
    decoded = sum(len(o.tokens) - 1 for o in outs)  # the first token comes from the prefill
    ttft = sorted(o.queue_time + o.prefill_time for o in outs)
    stats = engine.stats()
    result = {
        "requests": len(reqs), "prompt_tokens": prompt_tokens, "generated_tokens": decoded + len(outs),
        "prefill_calls": calls, "decode_ticks": ticks, "occupancy": stats["occupancy"],
        "prefill_tokens_per_s": prompt_tokens / timing["prefill"],
        "decode_tokens_per_s": decoded / timing["decode"],
        "ms_per_tick": timing["decode"] / ticks * 1e3,
        "prefill_s": timing["prefill"], "decode_s": timing["decode"], "wall_s": wall,
        "ttft_p50_s": ttft[len(ttft) // 2],
        "prefill_time_p50_s": sorted(o.prefill_time for o in outs)[len(outs) // 2],
        "peak_gib": peak / 2 ** 30,
    }
    print("lm: serving " + json.dumps(result) + f" on {card}", flush=True)

    # accuracy: 2 requests teacher-forced, card bf16 against fp32 on the CPU
    ref = long_context_lm(device="cpu", dtype=torch.float32, **LM)
    ref.load_state_dict({k: v.float().cpu() for k, v in model.state_dict().items()})
    worst = 1.0
    for r in (reqs[0], reqs[1]):
        prompt = list(r.prompt[:700 + 400 * r.request_id])
        feed = by_id[r.request_id].tokens[:8]
        a = teacher_forced(model, prompt, feed, "cuda")
        b = teacher_forced(ref, prompt, feed, "cpu")
        cos = ((a * b).sum(-1) / (a.norm(dim=-1) * b.norm(dim=-1))).min().item()
        worst = min(worst, cos)
        print(f"lm: teacher-forced logits, prompt {len(prompt)} + 8 decode steps, min cosine "
              f"vs fp32 CPU {cos:.6f}", flush=True)
    print("lm: bar 0.99: bf16 activations through 12 layers (each rounding 2^-9 relative), "
          "probabilities rounded to bf16 in #6 and #10, and int8 codes that can differ by one "
          "step where the bf16 keys and values differ from the fp32 ones", flush=True)
    if worst < 0.99:
        fail(f"LM logits reach cosine {worst} < 0.99 against fp32")

    # device time of one prefill call (bucket 2048) and one decode call by group
    n = engine.prefill_batch
    dev = engine.device
    tokens = torch.from_numpy(rng.integers(0, LM["vocab_size"], size=(n, 2048))).to(dev)
    slots = torch.arange(n, device=dev)
    lengths = torch.full((n,), 2000, device=dev)
    sampling = torch.tensor([[0.0, 50.0, 1.0]] * n, device=dev)
    prefill_groups = profile_step(lambda: engine._prefill(tokens, slots, lengths, sampling),
                                  "lm prefill")
    rows = engine.n_slots + 1
    dtok = torch.from_numpy(rng.integers(0, LM["vocab_size"], size=rows)).to(dev)
    dpos = torch.full((rows,), 2100, device=dev)
    dsamp = torch.tensor([[0.0, 50.0, 1.0]] * rows, device=dev)
    decode_groups = profile_step(lambda: engine._decode(dtok, dpos, torch.ones_like(dpos), dsamp,
                                                        False), "lm decode")
    print("lm: device time of one prefill call (8 x 2048) by kernel group "
          + json.dumps(prefill_groups), flush=True)
    print("lm: device time of one decode call (16 ticks x 33 rows at position 2100) by kernel "
          "group " + json.dumps(decode_groups), flush=True)
    result.update(min_cosine=worst, prefill_profile=prefill_groups, decode_profile=decode_groups)
    if isinstance(decode_groups, dict):  # device time against the host clock's ms a tick
        result["device_ms_per_tick"] = decode_groups["total_device_ms"] / engine.decode_steps
    return launches, result


def kernel_group(name: str) -> str:
    low = name.lower()
    if "flash_fwd" in name:
        return "flash_attention"
    if "flash_bwd" in name:  # #9 is the dq body's kDbias = true instance
        return "flash_attention_bwd_dbias" if "true" in name else "flash_attention_bwd"
    if "quantized_cache_attention" in name:
        return "quantized_cache_attention"
    if "qkv_attention_bwd" in name:
        return "fused_qkv_attention_bwd"
    if "qkv_attention" in name:
        return "fused_qkv_attention"
    if "fused_mlp_bwd_acc" in name:  # #5's four stages
        return "fused_mlp_bwd_acc"
    if "fused_mlp_bwd_" in name:  # #4's stages
        return "fused_mlp_bwd"
    if "fused_mlp_kernel" in name or "fused_mlp_fwd_" in name:  # #3: fp32; bf16's stages
        return "fused_mlp"
    if any(k in low for k in ("gemm", "nvjet", "cutlass", "xmma")):
        return "library_gemm"
    if "layer_norm" in low:
        return "layer_norm"
    if "conv" in low or "wgrad" in low or "dgrad" in low:
        return "conv"
    if "upsample" in low or "interp" in low:
        return "resize"
    if "adam" in low or "multi_tensor" in low:
        return "optimizer"
    if "softmax" in low:
        return "softmax"
    if "embedding" in low:
        return "embedding"
    if "reduce" in low:
        return "reduce"
    return "other"


def profile_step(step, label: str):
    """Device time of one ``step()``, summed by kernel group, from
    torch.profiler; 'not measured' when the profiler sees no device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    groups, top = {}, []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if not us or e.device_type.name != "CUDA" or getattr(e, "is_user_annotation", False):
            continue  # annotations (Optimizer.step#...) span kernels counted on their own
        g = kernel_group(e.key)
        groups[g] = groups.get(g, 0.0) + us / 1e3
        top.append((round(us / 1e3, 3), e.key[:90]))
    if not groups:
        return "not measured"
    print(f"{label}: top kernels (ms) " + json.dumps(sorted(top, reverse=True)[:12]), flush=True)
    host = sorted(((round(e.self_cpu_time_total / 1e3, 3), e.count, e.key[:60])
                   for e in prof.key_averages() if e.self_cpu_time_total > 0), reverse=True)
    print(f"{label}: top host ops (self ms, calls) " + json.dumps(host[:10]), flush=True)
    out = {k: round(v, 3) for k, v in sorted(groups.items(), key=lambda kv: -kv[1])}
    out["total_device_ms"] = round(sum(groups.values()), 3)
    out["wall_ms_under_profiler"] = round(wall_ms, 3)
    return out


# --------------------------------------------------------------------------
# phase 4: CLIP ViT-B/32 contrastive train step
# --------------------------------------------------------------------------


def clip_loss_fn(dtype):
    """bench.py's loss_fn: uint8 images -> preprocess -> both towers ->
    contrastive loss at logit scale 4.6052."""
    from multimodal_tpu_torch.modules.losses.contrastive_loss_with_temperature import (
        contrastive_loss_with_temperature,
    )
    from multimodal_tpu_torch.ops.image import fused_preprocess_for_encoder

    def loss_fn(model, batch):
        images_u8, text = batch
        out = model(fused_preprocess_for_encoder(images_u8, 224, dtype=dtype), text)
        return contrastive_loss_with_temperature(
            out.embeddings_a, out.embeddings_b, 4.6052).loss, {}

    return loss_fn


def mlp_bwd_launches(fe):
    """Launches of the two MLP backward kernels since the last reset."""
    return {"fused_mlp_bwd": fe.fused_mlp_bwd.launches,
            "fused_mlp_bwd_acc": fe.fused_mlp_bwd_acc.launches}


def mlp_bwd_routes(fe, mlps):
    """The launches of #4 and #5 that MLP backwards make, each taking the
    route ``fused_mlp_bwd_acc_supported`` gives its shape: ``mlps`` holds
    (rows, Din, Dff, Dout, count)."""
    out = {"fused_mlp_bwd": 0, "fused_mlp_bwd_acc": 0}
    for rows, din, dff, dout, count in mlps:
        acc = fe.fused_mlp_bwd_acc_supported(rows, din, dff, dout)
        out["fused_mlp_bwd_acc" if acc else "fused_mlp_bwd"] += count
    return out


def grad_cosines(model, batch, build=None):
    """Cosines of the card's bf16 gradients against an fp32 step of the
    same weights (a model from ``build``, CLIP ViT-B/32 by default) on the
    CPU through the plain versions: the concatenated gradient's, and the
    lowest single tensor's with its name."""
    from multimodal_tpu_torch.models.clip.model import clip_vit_b32

    build = build or clip_vit_b32
    model.zero_grad(set_to_none=True)
    loss, _ = clip_loss_fn(torch.bfloat16)(model, tuple(t.cuda() for t in batch))
    loss.backward()
    loss = loss.detach()
    ref = build(device="cpu", dtype=torch.float32)
    ref.load_state_dict({k: v.detach().float().cpu() for k, v in model.state_dict().items()})
    ref_loss, _ = clip_loss_fn(torch.float32)(ref, batch)
    ref_loss.backward()
    ref_loss = ref_loss.detach()
    ref_grads = dict(ref.named_parameters())
    dots = sq_a = sq_b = 0.0
    worst = (2.0, "")
    for name, p in model.named_parameters():
        a = p.grad.double().cpu().flatten()
        b = ref_grads[name].grad.double().flatten()
        dots += float(a @ b)
        sq_a += float(a @ a)
        sq_b += float(b @ b)
        cos = float(a @ b) / max(float(a.norm() * b.norm()), 1e-300)
        worst = min(worst, (cos, name))
    model.zero_grad(set_to_none=True)
    return dots / math.sqrt(sq_a * sq_b), worst, loss.item(), ref_loss.item()


def train(fe, card):
    from multimodal_tpu_torch.models.clip.model import clip_vit_b32
    from multimodal_tpu_torch.training.trainer import Trainer

    t0 = time.perf_counter()
    model = clip_vit_b32(dtype=torch.bfloat16, param_dtype=torch.float32, seed=0).train()
    print(f"train: built clip_vit_b32 (fp32 params, bf16 compute) in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    rng = np.random.default_rng(1)
    small = (torch.from_numpy(rng.integers(0, 256, size=(8, 256, 256, 3), dtype=np.uint8)),
             torch.from_numpy(token_ids(rng, 8)))
    t0 = time.perf_counter()
    fe.reset_launch_counts()
    cos, (worst_cos, worst_name), loss_card, loss_cpu = grad_cosines(model, small)
    check_launches = mlp_bwd_launches(fe)
    print(f"train: gradient cosine vs fp32 CPU at 8 pairs: {cos:.6f} (bar 0.99); lowest "
          f"tensor {worst_name} {worst_cos:.6f}; loss card {loss_card:.6f} cpu {loss_cpu:.6f} "
          f"({time.perf_counter() - t0:.1f} s); MLP backward launches {check_launches}",
          flush=True)
    if not cos >= 0.99:
        fail(f"gradient cosine {cos} < 0.99 against fp32 on the CPU")
    # 8 pairs are 400 and 616 rows a tower, 12 layers each
    want = mlp_bwd_routes(fe, ((8 * 50, 768, 3072, 768, 12), (8 * 77, 512, 2048, 512, 12)))
    if check_launches != want:
        fail(f"MLP backward launches in the 8-pair gradient check: {check_launches}, "
             f"want {want}")

    warmup, steps = 2, 10
    batches = [(rng.integers(0, 256, size=(TRAIN_BATCH, 256, 256, 3), dtype=np.uint8),
                token_ids(rng, TRAIN_BATCH)) for _ in range(warmup + steps + 1)]
    # optax.adamw(1e-4): weight decay 1e-4 on every parameter; PyTorch's
    # single-kernel (fused) AdamW
    opt = torch.optim.AdamW(model.parameters(), lr=1e-4, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=1e-4, fused=True)
    # no log boundary inside the window: the metrics reach the host at the
    # last step of a fit only (the losses are printed below)
    trainer = Trainer(clip_loss_fn(torch.bfloat16), opt, log_interval=100)
    # two warm-up steps: the prefetch's two pinned host buffers exist before
    # the timed window
    trainer.fit(model, batches[:warmup], warmup)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fe.reset_launch_counts()
    t0 = time.perf_counter()
    trainer.fit(model, batches[warmup:warmup + steps], steps)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {"fused_qkv_attention": fe.fused_qkv_attention.launches,
                "fused_qkv_attention_bwd": fe.fused_qkv_attention_bwd.launches,
                "fused_mlp": fe.fused_mlp.launches, **mlp_bwd_launches(fe)}
    peak = torch.cuda.max_memory_allocated()
    losses = [r["loss"] for r in trainer.logger.records if "loss" in r]
    # 24 a step (12 layers x 2 towers); the MLP backward by the predicate
    want = {k: 24 * steps for k in launches}
    want.update(mlp_bwd_routes(fe, ((TRAIN_BATCH * 50, 768, 3072, 768, 12 * steps),
                                    (TRAIN_BATCH * 77, 512, 2048, 512, 12 * steps))))
    print(f"train: launches {launches}, want {want}", flush=True)
    for k, v in launches.items():
        if v != want[k]:
            fail(f"{k} launched {v} times in {steps} train steps, want {want[k]}")
    if not all(math.isfinite(x) for x in losses):
        fail(f"non-finite loss: {losses}")
    rate = TRAIN_BATCH * steps / dt
    print(f"train: {rate:.1f} items/s, {dt / steps * 1e3:.1f} ms a step at batch {TRAIN_BATCH} "
          f"(host batches, prefetched), peak memory {peak / 2**30:.2f} GiB, losses "
          f"{[round(x, 5) for x in losses]} on {card}", flush=True)
    breakdown = profile_step(lambda: trainer.fit(model, batches[-1:], 1), "train")
    print("train: device time of one step by kernel group " + json.dumps(breakdown), flush=True)
    launches["fused_mlp_bwd_grad_check"] = check_launches["fused_mlp_bwd"]
    return launches, cos, rate, dt / steps * 1e3, peak


def vit_b16_grad_check(fe, card):
    """CLIP ViT-B/16's gradients (vision S = 197: kernel #2 past S = 128) at
    2 pairs, fp32 parameters and bf16 compute on the card, against fp32 on
    the CPU: concatenated cosine >= 0.99 with #2 launched. Then its train
    step at batch 256 (AdamW, as the ViT-B/32 phase): 1 warm-up and 3 timed
    steps with 24 launches a step of #1 and #2, and one step's device time
    by kernel group."""
    from multimodal_tpu_torch.models.clip.model import clip_vit_b16
    from multimodal_tpu_torch.training.trainer import Trainer

    model = clip_vit_b16(dtype=torch.bfloat16, param_dtype=torch.float32, seed=0).train()
    rng = np.random.default_rng(4)
    pairs = (torch.from_numpy(rng.integers(0, 256, size=(2, 256, 256, 3), dtype=np.uint8)),
             torch.from_numpy(token_ids(rng, 2)))
    t0 = time.perf_counter()
    fe.reset_launch_counts()
    cos, (worst_cos, worst_name), loss_card, loss_cpu = grad_cosines(model, pairs, clip_vit_b16)
    launches = {"fused_qkv_attention": fe.fused_qkv_attention.launches,
                "fused_qkv_attention_bwd": fe.fused_qkv_attention_bwd.launches}
    print(f"vit_b16: gradient cosine vs fp32 CPU at 2 pairs: {cos:.6f} (bar 0.99); lowest "
          f"tensor {worst_name} {worst_cos:.6f}; loss card {loss_card:.6f} cpu {loss_cpu:.6f} "
          f"({time.perf_counter() - t0:.1f} s); attention launches {launches} on {card}",
          flush=True)
    if not cos >= 0.99:
        fail(f"ViT-B/16 gradient cosine {cos} < 0.99 against fp32 on the CPU")
    # 12 layers x 2 towers; the vision tower's 12 at S = 197
    if launches["fused_qkv_attention_bwd"] != 24:
        fail(f"ViT-B/16 gradient check: #2 launched {launches['fused_qkv_attention_bwd']} "
             "times, want 24")

    warmup, steps = 1, 3
    batches = [(rng.integers(0, 256, size=(TRAIN_BATCH, 256, 256, 3), dtype=np.uint8),
                token_ids(rng, TRAIN_BATCH)) for _ in range(warmup + steps + 1)]
    opt = torch.optim.AdamW(model.parameters(), lr=1e-4, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=1e-4, fused=True)
    trainer = Trainer(clip_loss_fn(torch.bfloat16), opt, log_interval=100)
    trainer.fit(model, batches[:warmup], warmup)
    torch.cuda.synchronize()
    fe.reset_launch_counts()
    t0 = time.perf_counter()
    trainer.fit(model, batches[warmup:warmup + steps], steps)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    step_launches = {"fused_qkv_attention": fe.fused_qkv_attention.launches,
                     "fused_qkv_attention_bwd": fe.fused_qkv_attention_bwd.launches}
    losses = [r["loss"] for r in trainer.logger.records if "loss" in r]
    print(f"vit_b16: train {TRAIN_BATCH * steps / dt:.1f} items/s, {dt / steps * 1e3:.1f} ms a "
          f"step at batch {TRAIN_BATCH}, launches {step_launches}, losses "
          f"{[round(x, 5) for x in losses]} on {card}", flush=True)
    for k, v in step_launches.items():
        if v != 24 * steps:
            fail(f"ViT-B/16 train: {k} launched {v} times in {steps} steps, want {24 * steps}")
    if not all(math.isfinite(x) for x in losses):
        fail(f"ViT-B/16 train: non-finite loss: {losses}")
    breakdown = profile_step(lambda: trainer.fit(model, batches[-1:], 1), "vit_b16")
    print("vit_b16: device time of one train step by kernel group " + json.dumps(breakdown),
          flush=True)
    del model, trainer, opt
    torch.cuda.empty_cache()
    return launches, cos, step_launches, dt / steps * 1e3


# --------------------------------------------------------------------------
# phase 7: long-context LM training (kernels #6-#8, #3, #4)
# --------------------------------------------------------------------------

LM_TRAIN = dict(vocab_size=32000, max_seq_len=8192, n_layer=12, d_model=768, n_head=12,
                dim_feedforward=3072)  # the training recipe's defaults
LM_TRAIN_BATCH, LM_TRAIN_SEQ = 8, 8192


def lm_grad_cosine(model, trainer, batch):
    """Cosine of the card's gradients (bf16 compute) against an fp32 step of
    the same weights on the CPU through the plain versions, both through the
    recipe's loss: the concatenated gradient's, and the lowest single
    tensor's with its name."""
    from multimodal_tpu_torch.examples.long_context import train as lt
    from multimodal_tpu_torch.examples.long_context.model import long_context_lm

    model.zero_grad(set_to_none=True)
    loss, _ = trainer.loss_fn(model, {k: torch.from_numpy(v).cuda() for k, v in batch.items()})
    loss.backward()
    ref = long_context_lm(device="cpu", dtype=torch.float32, **LM_TRAIN).train()
    ref.load_state_dict({k: v.detach().float().cpu() for k, v in model.state_dict().items()})
    ref_loss, _ = lt.build_trainer(ref).loss_fn(ref, {k: torch.from_numpy(v)
                                                      for k, v in batch.items()})
    ref_loss.backward()
    ref_grads = dict(ref.named_parameters())
    dots = sq_a = sq_b = 0.0
    worst = (2.0, "")
    for name, p in model.named_parameters():
        a = p.grad.double().cpu().flatten()
        b = ref_grads[name].grad.double().flatten()
        dots += float(a @ b)
        sq_a += float(a @ a)
        sq_b += float(b @ b)
        worst = min(worst, (float(a @ b) / max(float(a.norm() * b.norm()), 1e-300), name))
    model.zero_grad(set_to_none=True)
    return dots / math.sqrt(sq_a * sq_b), worst, loss.item(), ref_loss.item()


def lm_train(fe, fa, card):
    """The recipe at its defaults through ``build_trainer`` and
    ``Trainer.fit``: fp32 parameters, bf16 compute, remat, clipping + AdamW,
    synthetic token windows at batch 8 x 8192; then ``main`` itself with
    packed documents."""
    from multimodal_tpu_torch.examples.long_context import train as lt
    from multimodal_tpu_torch.examples.long_context.model import long_context_lm

    t0 = time.perf_counter()
    model = long_context_lm(dtype=torch.bfloat16, param_dtype=torch.float32, seed=0, remat=True,
                            **LM_TRAIN)
    n_params = sum(p.numel() for p in model.parameters())
    trainer = lt.build_trainer(model, log_interval=100)
    print(f"lm train: built LongContextLM {LM_TRAIN} ({n_params / 1e6:.1f}M parameters, fp32, "
          f"bf16 compute, remat) in {time.perf_counter() - t0:.2f} s", flush=True)

    # the row of a packed batch of 4 that holds the most documents
    packed = next(lt.packed_document_batches(None, LM_TRAIN["vocab_size"], 1024, 4, seed=0))
    row = int(packed["segment_ids"].max(axis=1).argmax())
    packed = {k: v[row:row + 1] for k, v in packed.items()}
    n_docs = int(packed["segment_ids"].max())
    t0 = time.perf_counter()
    fe.reset_launch_counts()
    cos, (worst_cos, worst_name), loss_card, loss_cpu = lm_grad_cosine(model, trainer, packed)
    check_launches = mlp_bwd_launches(fe)
    print(f"lm train: gradient cosine vs fp32 CPU, one packed row of 1024 tokens ({n_docs} "
          f"documents, segment ids on), {LM_TRAIN['n_layer']} layers: {cos:.6f} (bar 0.99); "
          f"lowest tensor "
          f"{worst_name} {worst_cos:.6f}; loss card {loss_card:.6f} cpu {loss_cpu:.6f} "
          f"({time.perf_counter() - t0:.1f} s); MLP backward launches {check_launches}",
          flush=True)
    if not cos >= 0.99:
        fail(f"LM gradient cosine {cos} < 0.99 against fp32 on the CPU")
    # one packed row is 1,024 rows: #4's side of the predicate
    if check_launches != mlp_bwd_routes(fe, ((1024, 768, 3072, 768, LM_TRAIN["n_layer"]),)):
        fail(f"MLP backward launches in the LM gradient check: {check_launches}")

    warmup, steps = 2, 5
    stream = lt.synthetic_tokens(LM_TRAIN["vocab_size"], LM_TRAIN_BATCH * LM_TRAIN_SEQ * 64)
    data = lt.token_batches(lt.TokenWindowDataset(stream, LM_TRAIN_SEQ), LM_TRAIN_BATCH)
    batches = [next(data) for _ in range(warmup + steps + 1)]
    trainer.fit(model, batches[:warmup], warmup)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fe.reset_launch_counts()
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    trainer.fit(model, batches[warmup:warmup + steps], steps)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = {"flash_attention": fa.flash_attention_forward.launches,
                "flash_attention_bwd": fa.flash_attention_bwd.launches,
                "flash_attention_bwd_dbias": fa.flash_attention_bwd_dbias.launches,
                "fused_mlp": fe.fused_mlp.launches, **mlp_bwd_launches(fe)}
    layers = LM_TRAIN["n_layer"]
    # forward and remat recompute: 2 a layer; backward: 1; #9 only for a
    # differentiated bias; the MLP backward of 65,536 rows by the predicate
    want = {"flash_attention": 2 * layers * steps, "flash_attention_bwd": layers * steps,
            "flash_attention_bwd_dbias": 0, "fused_mlp": 2 * layers * steps,
            **mlp_bwd_routes(fe, ((LM_TRAIN_BATCH * LM_TRAIN_SEQ, 768, 3072, 768,
                                   layers * steps),))}
    print(f"lm train: launches {launches}, want {want} ({steps} steps, {layers} layers)",
          flush=True)
    for k, v in launches.items():
        if v != want[k]:
            fail(f"{k} launched {v} times in {steps} LM train steps, want {want[k]}")
    losses = [r["loss"] for r in trainer.logger.records[-steps:]]
    skipped = [r["nonfinite_skipped"] for r in trainer.logger.records[-steps:]]
    if len(losses) != steps or not all(math.isfinite(x) for x in losses) or any(skipped):
        fail(f"LM train losses {losses}, skipped {skipped}")
    tokens = LM_TRAIN_BATCH * LM_TRAIN_SEQ * steps
    result = {"tokens_per_s": tokens / dt, "ms_per_step": dt / steps * 1e3,
              "peak_gib": peak / 2 ** 30, "losses": losses, "grad_cosine": cos,
              "grad_cosine_lowest": [worst_name, worst_cos]}
    print(f"lm train: {tokens / dt:.1f} tokens/s, {dt / steps * 1e3:.1f} ms a step at batch "
          f"{LM_TRAIN_BATCH} x {LM_TRAIN_SEQ} (host batches, prefetched), peak memory "
          f"{peak / 2 ** 30:.2f} GiB, losses {[round(x, 5) for x in losses]} on {card}",
          flush=True)
    breakdown = profile_step(lambda: trainer.fit(model, batches[-1:], 1), "lm train")
    print("lm train: device time of one step by kernel group " + json.dumps(breakdown),
          flush=True)
    result["profile"] = breakdown
    del model, trainer, batches
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    model, trainer = lt.main(["--packed-docs", "synthetic", "--steps", "2", "--bf16"])
    torch.cuda.synchronize()
    cli_losses = [r["loss"] for r in trainer.logger.records]
    print(f"lm train: main(--packed-docs synthetic --steps 2 --bf16) at batch 8 x 8192: losses "
          f"{[round(x, 5) for x in cli_losses]} in {time.perf_counter() - t0:.1f} s", flush=True)
    if len(cli_losses) != 2 or not all(math.isfinite(x) for x in cli_losses):
        fail(f"the packed CLI run's losses {cli_losses}")
    result["cli_packed_losses"] = cli_losses
    del model, trainer
    torch.cuda.empty_cache()
    launches["fused_mlp_bwd_grad_check"] = check_launches["fused_mlp_bwd"]
    return launches, result


# --------------------------------------------------------------------------
# phase 8: FLAVA pretraining (kernels #3, #5 and #4)
# --------------------------------------------------------------------------

FLAVA_BATCH = 64
FLAVA_SEQS = (("image", 197), ("text", 77), ("mm", 275))  # rows a pair of each tower's MLP
FLAVA_MLPS = 12 * 2 + 12 * 2 + 6  # image and text towers twice a step, multimodal once


def flava_mlp_bwd_routes(fe, batch):
    """#4's and #5's launches in one FLAVA step at ``batch`` pairs."""
    rows = dict(FLAVA_SEQS)
    return mlp_bwd_routes(fe, ((batch * rows["image"], 768, 3072, 768, 24),
                               (batch * rows["text"], 768, 3072, 768, 24),
                               (batch * rows["mm"], 768, 3072, 768, 6)))


def flava_cfg(batch: int, steps: int, bf16: bool = True):
    """The recipe's config at its defaults (``base``: image 224/16, text 77,
    vocab 30522) at ``batch``; ``steps`` sets the schedule's length."""
    from multimodal_tpu_torch.examples.flava import pretrain as fp
    from multimodal_tpu_torch.utils.config import build_config

    return build_config(None, [f"data.batch_size={batch}", f"train.steps={steps}",
                               f"model.bf16={bf16}", "train.log_interval=100"],
                        defaults=fp.DEFAULTS)


def flava_grad_cosine(model, batch):
    """Cosine of the card's gradients (bf16 compute) against an fp32 step of
    the same weights on the CPU through the plain versions, both through the
    recipe's loss: the concatenated gradient's, and the lowest single
    tensor's with its name. Parameters the batch does not reach have no
    gradient on either side."""
    from multimodal_tpu_torch.examples.flava import pretrain as fp

    model.zero_grad(set_to_none=True)
    loss, _ = fp.loss_fn(model, {k: torch.from_numpy(v).cuda() for k, v in batch.items()})
    loss.backward()
    ref = fp.build_model(flava_cfg(2, 1, bf16=False), device="cpu")
    ref.load_state_dict({k: v.detach().float().cpu() for k, v in model.state_dict().items()})
    ref_loss, _ = fp.loss_fn(ref, {k: torch.from_numpy(v) for k, v in batch.items()})
    ref_loss.backward()
    ref_grads = dict(ref.named_parameters())
    dots = sq_a = sq_b = 0.0
    worst = (2.0, "")
    for name, p in model.named_parameters():
        if (p.grad is None) != (ref_grads[name].grad is None):
            fail(f"FLAVA gradient of {name}: present on one side only")
        if p.grad is None:
            continue
        a = p.grad.double().cpu().flatten()
        b = ref_grads[name].grad.double().flatten()
        dots += float(a @ b)
        sq_a += float(a @ a)
        sq_b += float(b @ b)
        if a.any() or b.any():  # a head the batch reaches only through `sum() * 0` has none
            worst = min(worst, (float(a @ b) / max(float(a.norm() * b.norm()), 1e-300), name))
    model.zero_grad(set_to_none=True)
    return dots / math.sqrt(sq_a * sq_b), worst, loss.item(), ref_loss.item()


def flava_train(fe, fa, card):
    """The FLAVA recipe at ``base`` (12 image, 12 text and 6 multimodal
    layers, width 768, ffn 3072, fp32 parameters, bf16 compute, the recipe's
    AdamW and schedule) through ``build_trainer_and_state`` and
    ``Trainer.fit`` on the recipe's synthetic batches at batch 64: the
    gradients of 2 pairs against fp32 on the CPU, then 2 warm-up and 5
    timed steps; then the recipe's ``main``."""
    from multimodal_tpu_torch.examples.flava import pretrain as fp

    warmup, steps = 2, 5
    cfg = flava_cfg(FLAVA_BATCH, warmup + steps)
    t0 = time.perf_counter()
    model = fp.build_model(cfg, seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    trainer, model = fp.build_trainer_and_state(cfg, model=model)
    print(f"flava: built FLAVAForPreTraining base ({n_params / 1e6:.1f}M parameters, fp32, "
          f"bf16 compute) in {time.perf_counter() - t0:.2f} s", flush=True)

    def counts():
        return {"fused_qkv_attention": fe.fused_qkv_attention.launches,
                "fused_qkv_attention_bwd": fe.fused_qkv_attention_bwd.launches,
                "fused_mlp": fe.fused_mlp.launches, **mlp_bwd_launches(fe),
                "flash_attention": fa.flash_attention_forward.launches}

    small = next(fp.synthetic_batches(flava_cfg(2, 1)))
    t0 = time.perf_counter()
    fe.reset_launch_counts()
    fa.reset_launch_counts()
    cos, (worst_cos, worst_name), loss_card, loss_cpu = flava_grad_cosine(model, small)
    check_launches = counts()
    print(f"flava: gradient cosine vs fp32 CPU at 2 pairs: {cos:.6f} (bar 0.99); lowest tensor "
          f"{worst_name} {worst_cos:.6f}; loss card {loss_card:.6f} cpu {loss_cpu:.6f} "
          f"({time.perf_counter() - t0:.1f} s); launches {check_launches}", flush=True)
    if not cos >= 0.99:
        fail(f"FLAVA gradient cosine {cos} < 0.99 against fp32 on the CPU")
    # 2 pairs are 394, 154 and 550 rows; the towers ask for attention
    # probabilities, so no fused or flash attention
    want = dict.fromkeys(check_launches, 0)
    want.update(fused_mlp=FLAVA_MLPS, **flava_mlp_bwd_routes(fe, 2))
    if check_launches != want:
        fail(f"FLAVA gradient check launches {check_launches}, want {want}")

    data = fp.synthetic_batches(cfg)
    batches = [next(data) for _ in range(warmup + steps + 1)]
    trainer.fit(model, batches[:warmup], warmup)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fe.reset_launch_counts()
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    trainer.fit(model, batches[warmup:warmup + steps], steps)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = counts()
    want = dict.fromkeys(launches, 0)
    want.update(fused_mlp=FLAVA_MLPS * steps,
                **{k: v * steps for k, v in flava_mlp_bwd_routes(fe, FLAVA_BATCH).items()})
    print(f"flava: launches {launches}, want {want} ({steps} steps, {FLAVA_MLPS} MLPs a step)",
          flush=True)
    if launches != want:
        fail(f"FLAVA train launches {launches}, want {want}")
    records = trainer.logger.records[-steps:]
    names = ("loss", "itm_loss", "mmm_text_loss", "mmm_image_loss", "global_contrastive_loss")
    if (len(records) != steps or any(r["nonfinite_skipped"] for r in records)
            or not all(math.isfinite(r[k]) for r in records for k in names)):
        fail(f"FLAVA train losses {records}")
    losses = [r["loss"] for r in records]
    result = {"items_per_s": FLAVA_BATCH * steps / dt, "ms_per_step": dt / steps * 1e3,
              "peak_gib": peak / 2 ** 30, "losses": losses,
              "last_step": {k: records[-1][k] for k in names}, "grad_cosine": cos,
              "grad_cosine_lowest": [worst_name, worst_cos]}
    print(f"flava: {result['items_per_s']:.1f} items/s, {result['ms_per_step']:.1f} ms a step "
          f"at batch {FLAVA_BATCH} (host batches, prefetched), peak memory "
          f"{result['peak_gib']:.2f} GiB, losses {[round(x, 5) for x in losses]}, last step "
          f"{json.dumps(result['last_step'])} on {card}", flush=True)
    breakdown = profile_step(lambda: trainer.fit(model, batches[-1:], 1), "flava")
    print("flava: device time of one step by kernel group " + json.dumps(breakdown),
          flush=True)
    result["profile"] = breakdown
    del model, trainer, batches, data
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    model, trainer = fp.main([f"data.batch_size={FLAVA_BATCH}", "train.steps=2"])
    torch.cuda.synchronize()
    cli_losses = [r["loss"] for r in trainer.logger.records]
    print(f"flava: main(data.batch_size={FLAVA_BATCH} train.steps=2): losses "
          f"{[round(x, 5) for x in cli_losses]} in {time.perf_counter() - t0:.1f} s", flush=True)
    if len(cli_losses) != 2 or not all(math.isfinite(x) for x in cli_losses):
        fail(f"the FLAVA CLI run's losses {cli_losses}")
    result["cli_losses"] = cli_losses
    del model, trainer
    torch.cuda.empty_cache()
    launches["fused_mlp_bwd_grad_check"] = check_launches["fused_mlp_bwd"]
    return launches, result


def main() -> None:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs a CUDA GPU",
              file=sys.stderr)
        sys.exit(2)
    from multimodal_tpu_torch.ops import _build
    from multimodal_tpu_torch.ops import attention as attn
    from multimodal_tpu_torch.ops import flash_attention as fa
    from multimodal_tpu_torch.ops import fused_encoder as fe
    from multimodal_tpu_torch.ops import kv_cache as kv
    from multimodal_tpu_torch.ops import quantized_attention as qa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = card_line()
    print(f"device: {card} | {torch.cuda.get_device_name(0)} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    if "--ab" in sys.argv[1:]:
        ab(sys.argv[sys.argv.index("--ab") + 1])
        print("ab: done; no result line", flush=True)
        return
    if "--planted-faults" in sys.argv[1:]:
        planted_faults()
        print("planted faults: each failed at least one case; no result line", flush=True)
        return
    t0 = time.perf_counter()
    lib = _build.build()
    build_s = time.perf_counter() - t0
    print(f"build: {lib.name} in {build_s:.1f} s (nvcc -gencode arch=compute_90a,code=sm_90a)",
          flush=True)
    if _build.build_log:
        for line in _build.build_log.splitlines():
            if ("registers" in line or "spill" in line or "entry function" in line
                    or "C75" in line or line.startswith("==")):  # C75xx: wgmma serialized
                print("  " + line.strip(), flush=True)

    cases = (check_kernels(fe) + check_mlp_kernel(fe) + check_acc_kernel(fe)
             + check_new_kernels(fa, qa, kv) + check_bwd_kernels(fa))
    bwd_rows = flash_bwd_timing(fa)
    cases += bwd_rows
    bad = [c for c in cases if not c["ok"]]
    if bad:
        fail(f"{len(bad)} kernel case(s) outside tolerance: "
             + ", ".join(f"{c['kernel']}/{c['case']}/{c['dtype']}" for c in bad))
    threshold = flash_threshold(fa, attn, torch.Generator(device="cuda").manual_seed(2))
    print(f"threshold: flash vs the plain path, (8, 12, S, 64) bf16 causal: {json.dumps(threshold)}"
          f"; FLASH_MIN_SEQ = {attn.FLASH_MIN_SEQ}", flush=True)
    routes = attention_bwd_routes(fe)
    print(f"threshold: #2's mma.sync vs wgmma kernel, (256, S, 3D) bf16 at head width 64: "
          f"{json.dumps(routes)}; _BWD_WGMMA_MIN_SEQ = {fe._BWD_WGMMA_MIN_SEQ}", flush=True)
    acc_rows = acc_threshold(fe)
    print(f"threshold: #5 vs #4 + library dW, (rows, 768, 3072, 768) bf16 exact GELU: "
          f"{json.dumps(acc_rows)}; _ACC_MIN_ROWS = {fe._ACC_MIN_ROWS}", flush=True)
    if "--kernels-only" in sys.argv[1:]:
        print("kernels only: every case within tolerance; no result line", flush=True)
        return

    serve_launches, min_cos, device_rate, served_rate = serve(fe, card)
    launches, grad_cos, train_rate, step_ms, peak = train(fe, card)
    b16_launches, b16_cos, b16_step_launches, b16_step_ms = vit_b16_grad_check(fe, card)
    vit_cos = vit_l14_check(card)
    lm_launches, lm = lm_serve(fe, fa, qa, card)
    train_launches, lm_tr = lm_train(fe, fa, card)
    flava_launches, flava = flava_train(fe, fa, card)

    # every path's launch counts, each read just after the path ran with the
    # counts set to 0 just before it; a kernel's `launches` is its count on
    # its main path, the path whose shapes its head case (below) checks and
    # times
    paths = {"serve": serve_launches, "train": launches, "lm": lm_launches,
             "lm_train": train_launches, "flava": flava_launches,
             "train_grad_check": {"fused_mlp_bwd": launches["fused_mlp_bwd_grad_check"]},
             "vit_b16_grad_check": b16_launches, "vit_b16_train": b16_step_launches,
             "lm_train_grad_check": {"fused_mlp_bwd": train_launches["fused_mlp_bwd_grad_check"]},
             "flava_grad_check": {"fused_mlp_bwd": flava_launches["fused_mlp_bwd_grad_check"]}}
    main_path = {"fused_qkv_attention": "serve", "fused_qkv_attention_bwd": "train",
                 "fused_mlp": "flava", "fused_mlp_bwd": "flava_grad_check",
                 "fused_mlp_bwd_acc": "flava", "flash_attention": "lm",
                 "quantized_cache_attention": "lm", "flash_attention_bwd": "lm_train",
                 "flash_attention_bwd_dbias": "lm_train"}

    def path_launches(name):
        out = {"launches": paths[main_path[name]][name]}
        out.update({f"launches_{p}": c[name] for p, c in paths.items() if name in c})
        return out

    kernels = []
    for name, source, replaces, head_case in (
        ("fused_qkv_attention", "multimodal_tpu_torch/csrc/fused_qkv_attention.cu",
         "multimodal_tpu/ops/fused_encoder.py:200", "vision"),
        ("fused_qkv_attention_bwd", "multimodal_tpu_torch/csrc/fused_qkv_attention_bwd.cu",
         "multimodal_tpu/ops/fused_encoder.py:317", "vision"),
        ("fused_mlp", "multimodal_tpu_torch/csrc/fused_mlp.cu",
         "multimodal_tpu/ops/fused_encoder.py:500", "flava_image"),
        ("fused_mlp_bwd", "multimodal_tpu_torch/csrc/fused_mlp_bwd.cu",
         "multimodal_tpu/ops/fused_encoder.py:603", "flava_grad_image"),
        ("fused_mlp_bwd_acc", "multimodal_tpu_torch/csrc/fused_mlp_bwd_acc.cu",
         "multimodal_tpu/ops/fused_encoder.py:706", "flava_mm"),
        ("flash_attention", "multimodal_tpu_torch/csrc/flash_attention_fwd.cu",
         "multimodal_tpu/ops/flash_attention.py:336", "prefill"),
        ("quantized_cache_attention", "multimodal_tpu_torch/csrc/quantized_cache_attention.cu",
         "multimodal_tpu/ops/quantized_attention.py:117", "decode"),
    ):
        mine = [c for c in cases if c["kernel"] == name]
        head = next(c for c in mine if c["case"] == head_case and c["dtype"] == "bfloat16")
        entry = {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            **path_launches(name),
            "max_abs_err": head["max_abs_err"],
            "ms": head["ms"], "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            "passed": all(c["ok"] for c in mine),
        }
        if "staged_ms" in head:
            entry["staged_ms"] = head["staged_ms"]  # the route #5 replaces: #4 + library dW
        entry["cases"] = [{k: c[k] for k in ("case", "dtype", "max_abs_err", "rel_err", "tol",
                                             "ms", "stage_ms",
                                             "plain_ms", "library_ms", "staged_ms", "tflops",
                                             "bound_ms", "bound_by", "deterministic")
                           if k in c}
                          for c in mine]
        kernels.append(entry)
    # one entry per pallas_call: :625 (dq) and :650 (dk, dv) both name the
    # one call that replaces them, with its one time
    bwd_checks = [c for c in cases
                  if c["kernel"] == "flash_attention_bwd" and c["case"] != "train"]
    fused_row, dbias_row = bwd_rows
    for row, line, parts in ((fused_row, 625, ("dq",)), (fused_row, 650, ("dk", "dv")),
                             (dbias_row, 679, ("ds",))):
        name = row["kernel"]
        kernels.append({
            "name": name, "route": "cuda", "source": "multimodal_tpu_torch/csrc/flash_attention_bwd.cu",
            "replaces": f"multimodal_tpu/ops/flash_attention.py:{line}", "parts": list(parts),
            **path_launches(name),
            "max_abs_err": max(row["max_abs_err_by_part"][n] for n in parts),
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
            "passed": row["ok"] and all(c["ok"] for c in bwd_checks),
            "cases": [{"case": c["case"], "dtype": c["dtype"],
                       "tol": {n: c["tol"][n] for n in parts},
                       "rel_err": {n: c["rel_err"][n] for n in parts},
                       **{k: c[k] for k in ("deterministic", "relaunch_dq_rel_err") if k in c}}
                      for c in bwd_checks if parts[0] in c["rel_err"]]})
    print(f"summary: serve min cosine {min_cos:.6f}, {device_rate:.1f} pairs/s device, "
          f"{served_rate:.1f} pairs/s served; train gradient cosine {grad_cos:.6f}, "
          f"{train_rate:.1f} items/s, {step_ms:.1f} ms a step, peak {peak / 2**30:.2f} GiB; "
          f"ViT-B/16 gradient cosine {b16_cos:.6f}, {b16_step_ms:.1f} ms a step; "
          f"ViT-L/14 cosine {vit_cos:.6f}; LM serving "
          f"{lm['prefill_tokens_per_s']:.1f} prefill tokens/s, "
          f"{lm['decode_tokens_per_s']:.1f} decode tokens/s, {lm['ms_per_tick']:.2f} ms a tick "
          f"(device {lm.get('device_ms_per_tick', float('nan')):.2f}), TTFT p50 "
          f"{lm['ttft_p50_s']:.3f} s, peak {lm['peak_gib']:.2f} GiB, logit "
          f"cosine {lm['min_cosine']:.6f}; LM training {lm_tr['tokens_per_s']:.1f} tokens/s, "
          f"{lm_tr['ms_per_step']:.1f} ms a step, peak {lm_tr['peak_gib']:.2f} GiB, gradient "
          f"cosine {lm_tr['grad_cosine']:.6f}; FLAVA pretraining {flava['items_per_s']:.1f} "
          f"items/s, {flava['ms_per_step']:.1f} ms a step, peak {flava['peak_gib']:.2f} GiB, "
          f"gradient cosine {flava['grad_cosine']:.6f}; build {build_s:.1f} s", flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()

"""Variants of the flash attention kernels' `wgmma` routes, measured on the
card: each variant is a list of (text, replacement) edits applied to the
kernel's source in a copy of the package under ``build/variants/<name>/``.
The copies build in parallel; the report gives, for the kernel, ptxas's
registers and spills, its C75xx notes (``wgmma`` serialized) and the
highest register its SASS uses, and, with ``--time``, its ms by CUDA
events, each variant in a process of its own, twice in turns, with the
profiler's device ms by kernel.

    python -m multimodal_tpu_torch.tools.kernel_variants
        [--forward | --decode | --qkv] [--time] [--only=name,name] [edits.json]

Without ``--forward`` the kernel is the backward's one-pass
``flash_bwd_wgmma_kernel`` (``csrc/flash_attention_bwd.cu``), timed as
``flash_attention_bwd`` at the LM training shape (8, 12, 8192, 64) bf16
causal (and, by the profiler's device ms, its head-width-96 instance at
CoCa's attention pooler, (32, 8, 256, 256, 96) bf16 non-causal), and the
default variants are ``VARIANTS``: the source as it is, K and V read from
shared memory in place of register fragments, ``exp2`` left out, the dq
reduction left out, and four ring stages. With
``--forward`` it is the forward's ``flash_fwd_wgmma_kernel``
(``csrc/flash_attention_fwd.cu``), timed as ``flash_attention_forward`` at
the LM's prefill (8, 12, 2048, 64) and train (8, 12, 8192, 64) shapes bf16
causal, and the default variants are ``FWD_VARIANTS``: the source as it
is, each warpgroup overlapping only its own softmax (no ping-pong),
``ex2`` left out, two and four ring stages, the grid walked a query tile
of every head at a time (in place of a chunk of heads at a time), and
two-warpgroup blocks at every query length (no one-warpgroup blocks up to
``kShortQueries``); CoCa's and BLIP-2's shapes (``chip_smoke``'s
``CAPTION_FLASH_CASES``) and MDETR's at head width 32 with key padding
(``MDETR_FLASH_CASES``) are timed too, by the profiler's device ms. With
``--decode`` it is the int8-cache decode attention's values kernel
(``csrc/quantized_cache_attention.cu``, reported at head width 64 and one
row), timed as ``quantized_cache_attention`` at ``chip_smoke.py``'s four
4096-position cases in bf16 (device ms by kernel from the profiler), and
the default variants are ``DECODE_VARIANTS``: the source as it is, the
mask's loads left out (a 1,900-position prefix seen instead), the K
copies, the V copies, and the merge's fence and counter left out (no
output is written).
With ``--qkv`` it is the fused QKV attention's `wgmma` kernel
(``csrc/fused_qkv_attention.cu``, reported at four key chunks), timed as
``fused_qkv_attention`` at CoCa-L's (32, 256, 3 x 1024, 16 heads),
ViT-B/16's (256, 197), CLIP's vision (512, 50) and causal text (512, 77)
and ALBEF's text (32, 30, a key bias) towers, and the default variants are
``QKV_VARIANTS``: the source as it is, ``ex2`` left out, the output
product left out, the loads alone, and the registers free to hold two
blocks an SM.
``--only=`` keeps the named variants. ``edits.json`` maps a variant's
name to its edits. A variant is for measuring only: its results are wrong
where an edit leaves work out.
"""

from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
SOURCE = "flash_attention_bwd.cu"
KERNEL = "flash_bwd_wgmma_kernelILi64E"  # the LM's: D = 64

VARIANTS = {
    "as_is": [],
    "kv_from_shared_memory": [
        ("wg::mma_m64n64k16_rs<wg::K>(st, kf[kk], desc_k(q_box, kk), kk);",
         "wg::mma_m64n64k16<wg::K, wg::K>(st, desc_k(k_rows, kk), desc_k(q_box, kk), kk);"),
        ("wg::mma_m64n64k16_rs<wg::K>(dpt, vf[kk], desc_k(do_box, kk), kk);",
         "wg::mma_m64n64k16<wg::K, wg::K>(dpt, desc_k(v_rows, kk), desc_k(do_box, kk), kk);")],
    "no_exp2": [("exp2f(st[4 * n + e] - ", "(st[4 * n + e] - ")],
    "no_dq_reduction": [("if (issuer) wg::tma_reduce_add_3d(",
                         "if (false) wg::tma_reduce_add_3d(")],
    "four_stages": [("static constexpr int kStages = 3;  // ring stages of q and do",
                     "static constexpr int kStages = 4;  // ring stages of q and do")],
}

FWD_SOURCE = "flash_attention_fwd.cu"
FWD_KERNEL = "flash_fwd_wgmma_kernelILi64ELb0ELi2E"  # the LM's: D = 64, no bias
FWD_VARIANTS = {
    "as_is": [],
    "overlap_alone": [("constexpr bool kPingPong = true;", "constexpr bool kPingPong = false;")],
    "no_ex2": [("s[x] = ex2(fmaf(s[x], a.scale_log2, -mu[hh]));",
                "s[x] = fmaf(s[x], a.scale_log2, -mu[hh]);")],
    "two_stages": [("static constexpr int kStages = 6;", "static constexpr int kStages = 2;")],
    "four_stages": [("static constexpr int kStages = 6;", "static constexpr int kStages = 4;")],
    "all_heads_per_tile": [("constexpr int kChunkBlocks = 132;",
                            "constexpr int kChunkBlocks = 1 << 30;")],
    "two_warpgroup_blocks": [("constexpr int kShortQueries = 64;",
                              "constexpr int kShortQueries = 0;")],
    "q_base_once": [("  const uint32_t q_tile = wg::smem_u32(sm);\n"
                     "  const uint32_t q_row0 = wgi * 64 * Wg<D>::kRowBytes;",
                     "  const uint32_t q_tile = wg::smem_u32(sm) + wgi * 64 * Wg<D>::kRowBytes;\n"
                     "  const uint32_t q_row0 = 0;")],
    "v_lbo_one_box": [("  return wg_desc<D>(tile + kk * 16 * Wg<D>::kRowBytes, 2 * Wg<D>::kBox, "
                       "8 * Wg<D>::kRowBytes);",
                       "  return wg_desc<D>(tile + kk * 16 * Wg<D>::kRowBytes, (Wg<D>::kChunks == 1 ? 1 "
                       ": 2) * Wg<D>::kBox, 8 * Wg<D>::kRowBytes);")],
    "unguarded_unmasked_loop": [("  if constexpr (!BIAS)\n    for (int t = 0; t < n_full; ++t)\n"
                                 "      flash_tile<D, WGS, false, false>",
                                 "  for (int t = 0; t < n_full; ++t)\n"
                                 "      flash_tile<D, WGS, false, false>")],
    "plain_desc": [("  return (wg::desc(addr, lbo, sbo) & ~(3ull << 62)) | (Wg<D>::kSwizzle << 62);",
                    "  if constexpr (Wg<D>::kSwizzle == 1) return wg::desc(addr, lbo, sbo);\n"
                    "  return (wg::desc(addr, lbo, sbo) & ~(3ull << 62)) | (Wg<D>::kSwizzle << 62);")],
}

FWD_TIME = r"""
import json, sys, torch
sys.path.insert(0, ".")
import chip_smoke as cs
from torch.profiler import ProfilerActivity, profile
from multimodal_tpu_torch.ops import flash_attention as fa
gen = torch.Generator(device="cuda").manual_seed(8)
ms, kernels = {}, {}
with torch.no_grad():
    for name, s in (("prefill", 2048), ("train", 8192)):
        q, k, v = (torch.randn(8, 12, s, 64, device="cuda", generator=gen).to(torch.bfloat16)
                   for _ in range(3))
        fn = lambda: fa.flash_attention_forward(q, k, v, causal=True, return_lse=True)
        ms[name] = [cs.time_ms(fn, 100 if s == 2048 else 20, warmup=3) for _ in range(3)]
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
        kernels[name] = {e.key[:60]: round(getattr(e, "device_time_total", 0) / 3 / 1e3, 4)
                         for e in prof.key_averages() if getattr(e, "device_time_total", 0)}
    # CoCa's and BLIP-2's short shapes (the bias lane, head width 96):
    # device ms from the profiler, their calls being host-bound on the events
    for name, b, h, sq, sk, d, _, kw in cs.CAPTION_FLASH_CASES:
        q, k, v = (torch.randn(b, h, n, d, device="cuda", generator=gen).to(torch.bfloat16)
                   for n in (sq, sk, sk))
        bias = cs.make_bias(kw.get("bias_kind"), b, h, sq, sk, gen)
        fn = lambda: fa.flash_attention_forward(q, k, v, bias, return_lse=kw.get("lse", False))
        ms[name] = [cs.device_ms(fn, "flash_attention") for _ in range(3)]
    for name, b, h, sq, sk, d, _, kw in cs.MDETR_FLASH_CASES:
        q, k, v = (torch.randn(b, h, n, d, device="cuda", generator=gen).to(torch.bfloat16)
                   for n in (sq, sk, sk))
        qseg = torch.ones(b, sq, dtype=torch.int32, device="cuda")
        kvseg = (cs.mdetr_key_mask(b, sk, gen).to(torch.int32) if kw.get("segments")
                 else torch.ones(b, sk, dtype=torch.int32, device="cuda"))
        fn = lambda: fa.flash_attention_forward(q, k, v, q_segment_ids=qseg,
                                                kv_segment_ids=kvseg)
        ms[name] = [cs.device_ms(fn, "flash_attention") for _ in range(3)]
print("variant_time " + json.dumps({"ms": ms, "device_ms": kernels, "card": cs.card_line()}))
"""

TIME = r"""
import json, sys, torch
sys.path.insert(0, ".")
import chip_smoke as cs
from torch.profiler import ProfilerActivity, profile
from multimodal_tpu_torch.ops import flash_attention as fa
gen = torch.Generator(device="cuda").manual_seed(8)
q, k, v, do, _, _ = cs._bwd_inputs(8, 12, 8192, 8192, 64, torch.bfloat16, gen, None, False)
with torch.no_grad():
    out, lse = fa.flash_attention_forward(q, k, v, causal=True, return_lse=True)
    delta = fa._delta(out, do, None)
    fn = lambda: fa.flash_attention_bwd(q, k, v, do, lse, delta, causal=True)
    ms = [cs.time_ms(fn, 10, warmup=2) for _ in range(3)]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
    del q, k, v, do, out, lse, delta
    q, k, v, do, _, _ = cs._bwd_inputs(32, 8, 256, 256, 96, torch.bfloat16, gen, None, False)
    out, lse = fa.flash_attention_forward(q, k, v, return_lse=True)
    delta = fa._delta(out, do, None)
    fn = lambda: fa.flash_attention_bwd(q, k, v, do, lse, delta)
    pooler = [cs.device_ms(fn, "flash_attention_bwd") for _ in range(3)]
kernels = {e.key[:60]: round(getattr(e, "device_time_total", 0) / 3 / 1e3, 4)
           for e in prof.key_averages() if getattr(e, "device_time_total", 0)}
print("variant_time " + json.dumps({"ms": ms, "device_ms": kernels,
                                    "pooler_d96_device_ms": pooler, "card": cs.card_line()}))
"""


DECODE_SOURCE = "quantized_cache_attention.cu"
DECODE_KERNEL = "quantized_cache_attention_values_kernelILi64ELi1E"
DECODE_VARIANTS = {
    "as_is": [],
    "no_mask_loads": [
        ("  unsigned bits = 0;\n  for (int s = 0; s < a.S; ++s) bits |= (unsigned)(mrow[s * a.ms[1]"
         " + j * a.ms[2]] != 0) << s;\n  return bits;", "  return j < 1900 ? 1u : 0u;")],
    "no_k_copies": [("      cp_async16(k_s + jj * D + part * 16, a.kq + (row0 + jj) * D"
                     " + part * 16);", "")],
    "no_v_copies": [("      if (msk[jj]) cp_async16(v_s + jj * D + part * 16, a.vq"
                     " + (row0 + jj) * D + part * 16);", "")],
    "no_merge_counter": [("    asm volatile(\"fence.acq_rel.gpu;\\n\" ::: \"memory\");\n", ""),
                         ("    last = atomicAdd(&a.done[g], 1u) == (unsigned)(a.runs - 1);",
                          "    last = 0u;")],
}

DECODE_TIME = r"""
import json, sys, torch
sys.path.insert(0, ".")
import chip_smoke as cs
from multimodal_tpu_torch.ops import kv_cache as kv, quantized_attention as qa
from torch.profiler import ProfilerActivity, profile
gen = torch.Generator(device="cuda").manual_seed(6)
ms, kernels = {}, {}
with torch.inference_mode():
    for name, b, hq, hkv, s, length, d, _ in cs.QCA_CASES[:4]:
        q, kc, vc, mask = cs._qca_inputs(qa, kv, b, hq, hkv, s, length, d, torch.bfloat16, gen,
                                         600, 3200)
        fn = lambda: qa.quantized_cache_attention(q, kc, vc, mask)
        ms[name] = cs.time_ms(fn, 200)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                fn()
            torch.cuda.synchronize()
        kernels[name] = {e.key[:70]: round(getattr(e, "device_time_total", 0) / 20 / 1e3, 4)
                         for e in prof.key_averages() if getattr(e, "device_time_total", 0)}
print("variant_time " + json.dumps({"ms": ms, "device_ms": kernels, "card": cs.card_line()}))
"""

QKV_SOURCE = "fused_qkv_attention.cu"
QKV_KERNEL = "qkv_attention_wgmma_kernelILi4E"
QKV_VARIANTS = {
    "as_is": [],
    "no_ex2": [("s[c][x] = ex2(s[c][x] - mx[hh]);", "s[c][x] = s[c][x] - mx[hh];")],
    "no_pv": [("      wg::mma_m64n64k16_rs<wg::MN>(o, pa[c][kl],\n                        "
               "           wg::desc(vb + (4 * c + kl) * 2048, kBox, 1024), 1);",
               "      wg::fence_regs(pa[c][kl]);")],
    "loads_only": [("  // S = Q K^T, both K-major",
                    "  for (int c = 0; c < C; ++c) wg::bar_wait(&k_bars[c], 0);\n"
                    "  wg::bar_wait(v_bar, 0);\n  if (S > 0) return;\n"
                    "  // S = Q K^T, both K-major")],
    "two_blocks_an_sm": [("__launch_bounds__(kWgThreads, 3)", "__launch_bounds__(kWgThreads)")],
}

QKV_TIME = r"""
import json, sys, torch
sys.path.insert(0, ".")
import chip_smoke as cs
from torch.profiler import ProfilerActivity, profile
from multimodal_tpu_torch.ops import fused_encoder as fe
gen = torch.Generator(device="cuda").manual_seed(6)
ms, kernels = {}, {}
with torch.inference_mode():
    for name, b, s, d, h, causal, key_bias in (
            ("coca_vit_l14", 32, 256, 1024, 16, False, False),
            ("vit_b16", cs.TRAIN_BATCH, 197, 768, 12, False, False),
            ("clip_vision", cs.BATCH, 50, 768, 12, False, False),
            ("clip_text", cs.BATCH, 77, 512, 8, True, False),
            ("albef_text", 32, 30, 768, 12, False, True)):
        qkv, kb = cs._attention_inputs(b, s, d, torch.bfloat16, key_bias, gen)
        fn = lambda: fe.fused_qkv_attention(qkv, h, causal, None, kb)
        ms[name] = [cs.time_ms(fn, 100, warmup=3) for _ in range(3)]
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                fn()
            torch.cuda.synchronize()
        kernels[name] = {e.key[:60]: round(getattr(e, "device_time_total", 0) / 20 / 1e3, 4)
                         for e in prof.key_averages() if getattr(e, "device_time_total", 0)}
print("variant_time " + json.dumps({"ms": ms, "device_ms": kernels, "card": cs.card_line()}))
"""

KEEP = {SOURCE: ("flash_attention_fwd.cu", "flash_attention_bwd.cu"),
        FWD_SOURCE: ("flash_attention_fwd.cu", "flash_attention_bwd.cu"),
        DECODE_SOURCE: (DECODE_SOURCE,),
        QKV_SOURCE: (QKV_SOURCE, "fused_qkv_attention_bwd.cu", "fused_mlp.cu",
                     "fused_mlp_bwd.cu", "fused_mlp_bwd_acc.cu")}


def make_copy(name: str, edits, source: str = SOURCE) -> Path:
    """The package and chip_smoke.py under build/variants/<name>, the
    kernel's source edited, the sources its wrapper binds kept."""
    copy = ROOT / "build" / "variants" / name
    shutil.rmtree(copy, ignore_errors=True)
    shutil.copytree(ROOT / "multimodal_tpu_torch", copy / "multimodal_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "chip_smoke.py", copy / "chip_smoke.py")
    csrc = copy / "multimodal_tpu_torch" / "csrc"
    for src in csrc.glob("*.cu"):
        if src.name not in KEEP[source]:
            src.unlink()
    text = (csrc / source).read_text()
    for old, new in edits:
        if old not in text:
            raise ValueError(f"variant {name}: {old!r} is not in {source}")
        text = text.replace(old, new)
    (csrc / source).write_text(text)
    return copy


def build_report(copy: Path, kernel: str = KERNEL) -> dict:
    """Builds the copy; ptxas's lines for `kernel` and its SASS's highest
    register."""
    proc = subprocess.run(
        [sys.executable, "-c", "import sys; sys.path.insert(0, '.'); "
         "from multimodal_tpu_torch.ops import _build; print(_build.build()); "
         "print(_build.build_log)"], cwd=copy, capture_output=True, text=True)
    if proc.returncode:
        return {"built": False, "log": proc.stdout[-2000:] + proc.stderr[-2000:]}
    lines = proc.stdout.splitlines()
    at = [i for i, line in enumerate(lines) if kernel in line and "Compiling" in line]
    report = {"built": True,
              "ptxas": [line.strip() for line in lines[at[0] + 1:at[0] + 4]
                        if "Function properties" not in line] if at else [],
              "notes": sorted({m.group(1) for m in re.finditer(r"\((C75\d\d)\)[^\n]*" + kernel,
                                                               proc.stdout)})}
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([cuobjdump, "-sass", lines[0]], capture_output=True, text=True).stdout
    body = [f for f in re.split(r"\n\s+Function : ", sass) if kernel in f.split("\n", 1)[0]]
    if body:
        report["highest_register"] = max(int(r) for r in re.findall(r"\bR(\d+)\b", body[0]))
    return report


def main(argv) -> None:
    time_it = "--time" in argv
    forward = "--forward" in argv
    decode = "--decode" in argv
    qkv = "--qkv" in argv
    source, kernel, timer, defaults = (
        (FWD_SOURCE, FWD_KERNEL, FWD_TIME, FWD_VARIANTS) if forward
        else (DECODE_SOURCE, DECODE_KERNEL, DECODE_TIME, DECODE_VARIANTS) if decode
        else (QKV_SOURCE, QKV_KERNEL, QKV_TIME, QKV_VARIANTS) if qkv
        else (SOURCE, KERNEL, TIME, VARIANTS))
    files = [a for a in argv if not a.startswith("--")]
    variants = json.loads(Path(files[0]).read_text()) if files else defaults
    only = [a.split("=", 1)[1].split(",") for a in argv if a.startswith("--only=")]
    if only:
        variants = {n: e for n, e in variants.items() if n in only[0]}
    copies = {name: make_copy(name, edits, source) for name, edits in variants.items()}
    with ThreadPoolExecutor(len(copies)) as ex:
        reports = dict(zip(copies, ex.map(lambda c: build_report(c, kernel), copies.values())))
    for name, report in reports.items():
        print(f"variant_build {name} " + json.dumps(report), flush=True)
    if not time_it:
        return
    for turn in range(2):
        for name, copy in copies.items():
            if not reports[name]["built"]:
                continue
            proc = subprocess.run([sys.executable, "-c", timer], cwd=copy, capture_output=True,
                                  text=True)
            line = [x for x in proc.stdout.splitlines() if x.startswith("variant_time ")]
            print(f"variant_time {name} turn {turn} "
                  + (line[-1][len("variant_time "):] if line else proc.stderr[-1500:]),
                  flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])

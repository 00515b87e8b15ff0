"""The port stands alone: it imports neither JAX nor the JAX package, its
entry points (model constructors, servers, trainer, LM engine, LM and FLAVA
training recipes) refuse to run without CUDA unless asked for the CPU, and
on CPU tensors no kernel is launched, forward or backward."""

import ast
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import multimodal_tpu_torch
from multimodal_tpu_torch.examples.flava import finetune as flava_finetune
from multimodal_tpu_torch.examples.flava import pretrain as flava_pretrain
from multimodal_tpu_torch.examples.long_context import train as lm_train
from multimodal_tpu_torch.examples.long_context.model import long_context_lm
from multimodal_tpu_torch.examples.mugen import retrieval_train as mugen_retrieval
from multimodal_tpu_torch.models.mdetr import model as mdetr_model
from multimodal_tpu_torch.models.clip import model as clip_model
from multimodal_tpu_torch.models.clip.image_encoder import CLIPViTEncoder
from multimodal_tpu_torch.models.clip.text_encoder import CLIPTextEncoder
from multimodal_tpu_torch.models.flava.model import (
    flava_model,
    flava_model_for_classification,
    flava_model_for_pretraining,
)
from multimodal_tpu_torch.ops import attention as attn
from multimodal_tpu_torch.ops import flash_attention as fa
from multimodal_tpu_torch.ops import fused_encoder as fe
from multimodal_tpu_torch.ops import quantized_attention as qa
from multimodal_tpu_torch.serving.embedding import EmbeddingServer
from multimodal_tpu_torch.serving.engine import InferenceEngine, Request
from multimodal_tpu_torch.training.trainer import Trainer

ROOT = Path(__file__).resolve().parents[1]
TINY_LM = dict(vocab_size=64, max_seq_len=1024, n_layer=1, d_model=64, n_head=2,
               dim_feedforward=128)
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "multimodal_tpu"}


def _port_modules():
    return sorted(
        m.name for m in pkgutil.walk_packages(
            multimodal_tpu_torch.__path__, prefix="multimodal_tpu_torch.")
    )


def test_every_module_imports_with_jax_blocked():
    blocked = "; ".join(f"sys.modules[{name!r}] = None" for name in sorted(FORBIDDEN))
    imports = "; ".join(f"importlib.import_module({m!r})" for m in _port_modules())
    code = f"import importlib, sys; {blocked}; {imports}; print('ok')"
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_no_jax_imports_in_the_source():
    files = sorted((ROOT / "multimodal_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    offenders = []
    for f in files:
        for node in ast.walk(ast.parse(f.read_text(), str(f))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            offenders += [f"{f.name}: {n}" for n in names if n.split(".")[0] in FORBIDDEN]
    assert not offenders


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        clip_model.clip_vit_b32()
    with pytest.raises(RuntimeError, match="CUDA"):
        EmbeddingServer(lambda x: x)
    model = torch.nn.Linear(2, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(lambda m, b: (m(b).sum(), {}), torch.optim.AdamW(model.parameters()))
    with pytest.raises(RuntimeError, match="CUDA"):
        long_context_lm(**TINY_LM)
    lm = long_context_lm(device="cpu", dtype=torch.float32, **TINY_LM)
    with pytest.raises(RuntimeError, match="CUDA"):
        InferenceEngine(lm, n_slots=2, max_len=1024, cache_dtype="int8")
    with pytest.raises(RuntimeError, match="CUDA"):
        lm_train.main(["--seq-len", "64", "--n-layer", "1", "--d-model", "64", "--n-head", "2",
                       "--vocab-size", "64", "--steps", "1"])


MDETR_TINY = dict(resnet_layers=(1, 1, 1, 1), embedding_dim=64, transformer_d_model=64,
                  transformer_num_heads=2, transformer_encoder_layers=1,
                  transformer_decoder_layers=1, transformer_dim_feedforward=128, num_queries=4,
                  text_encoder_kwargs=dict(num_hidden_layers=1, num_attention_heads=2,
                                           intermediate_size=128, vocab_size=100))


def test_mugen_and_mdetr_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        mugen_retrieval.build_model(mugen_retrieval.DEFAULTS)
    with pytest.raises(RuntimeError, match="CUDA"):
        mdetr_model.mdetr_for_phrase_grounding(**MDETR_TINY)
    with pytest.raises(RuntimeError, match="CUDA"):
        mdetr_model.mdetr_for_vqa(**MDETR_TINY)


def test_cpu_mdetr_launches_no_kernel():
    """MDETR on the CPU past the flash threshold (40 image tokens and 40
    text tokens) at widths the fused kernels take: their plain versions
    run, no kernel."""
    fe.reset_launch_counts()
    fa.reset_launch_counts()
    model = mdetr_model.mdetr_for_phrase_grounding(device="cpu", **MDETR_TINY)
    images = torch.rand(2, 160, 256, 3)
    mask = torch.zeros(2, 160, 256, dtype=torch.bool)
    mask[1, :, 200:] = True
    text = torch.randint(3, 100, (2, 40))
    text_mask = torch.zeros(2, 40, dtype=torch.bool)
    text_mask[0, 30:] = True
    with torch.no_grad():
        out = model(images, mask, text, text_mask)
    assert torch.isfinite(out.model_output.pred_boxes).all()
    for counter in (fe.fused_qkv_attention, fe.fused_mlp, fa.flash_attention_forward):
        assert counter.launches == 0


VIDEO_GPT_TINY = dict(text_seq_len=8, video_seq_len=4, resolution=8, downsample=(2, 2, 2),
                      d_model=192, n_head=2, dropout=0.0, attn_dropout=0.0,
                      num_decoder_layers=1, text_vocab_size=60,
                      vqvae_kwargs=dict(encoder_hidden_dim=16, n_res_layers=1,
                                        attn_hidden_dim=16, num_embeddings=32,
                                        embedding_dim=8, decoder_hidden_dim=16))


def test_video_gpt_entry_points_raise_without_cuda(monkeypatch):
    from multimodal_tpu_torch.examples.mugen.text_video_gpt import text_video_gpt
    from multimodal_tpu_torch.models.video_gpt.model import video_gpt, video_vqvae
    from multimodal_tpu_torch.serving.video_gpt_server import VideoGPTServer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        text_video_gpt(**VIDEO_GPT_TINY)
    with pytest.raises(RuntimeError, match="CUDA"):
        video_vqvae(**VIDEO_GPT_TINY["vqvae_kwargs"])
    with pytest.raises(RuntimeError, match="CUDA"):
        video_gpt(input_shape=(4, 8, 8), latent_shape=(2, 4, 4), d_model=48, n_head=2,
                  num_decoder_layers=1, vqvae_kwargs=VIDEO_GPT_TINY["vqvae_kwargs"])
    gpt = text_video_gpt(device="cpu", **VIDEO_GPT_TINY)
    with pytest.raises(RuntimeError, match="CUDA"):
        VideoGPTServer(gpt, in_seq_len=8)


def test_cpu_video_gpt_launches_no_kernel():
    """Text-to-video serving and sampling on the CPU at widths the fused
    MLP takes (192 -> 768 -> 192): its plain version runs, no kernel."""
    from multimodal_tpu_torch.examples.mugen.text_video_gpt import text_video_gpt
    from multimodal_tpu_torch.serving.video_gpt_server import VideoGPTServer
    from multimodal_tpu_torch.utils.generate import GenerationUtil

    fe.reset_launch_counts()
    gpt = text_video_gpt(device="cpu", **VIDEO_GPT_TINY)
    assert fe.fused_mlp_available(192, 768, 192)
    server = VideoGPTServer(gpt, in_seq_len=8, n_slots=2, max_new_tokens=4, device="cpu")
    server.submit(list(range(1, 9)), request_id=0)
    assert len(server.run()[0].tokens) == 4
    out = GenerationUtil(gpt).sample(torch.arange(1, 9)[None], max_seq_len=32)
    assert out.decoded.shape == (1, 4, 8, 8, 3)
    assert fe.fused_mlp.launches == 0


def test_cpu_tensors_launch_no_kernel():
    fe.reset_launch_counts()
    r = np.random.RandomState(0)
    qkv = torch.from_numpy(r.randn(2, 9, 3 * 32).astype(np.float32)).requires_grad_()
    fe.fused_qkv_attention(qkv, 4, True).sum().backward()
    x = torch.from_numpy(r.randn(5, 64).astype(np.float32)).requires_grad_()
    w1, w2 = torch.randn(64, 128), torch.randn(128, 64)
    fe.fused_mlp(x, w1, torch.zeros(128), w2, torch.zeros(64), "quick_gelu").sum().backward()
    assert qkv.grad is not None and x.grad is not None
    model = clip_model.CLIP(
        CLIPViTEncoder(embedding_dim=16, patch_size=16, image_size=32, width=64, heads=2,
                       layers=1),
        CLIPTextEncoder(embedding_dim=16, vocab_size=100, width=64, dim_feedforward=128,
                        heads=2, layers=1),
    )
    clip_model.init_parameters_(model, torch.Generator().manual_seed(0))
    with torch.inference_mode():
        model(torch.zeros(1, 32, 32, 3), torch.ones(1, 77, dtype=torch.long))
    # the LM path on the CPU: a prompt past the flash threshold, int8 decode
    fa.reset_launch_counts()
    qa.reset_launch_counts()
    lm = long_context_lm(device="cpu", dtype=torch.float32, **TINY_LM)
    engine = InferenceEngine(lm, n_slots=2, max_len=1024, cache_dtype="int8", device="cpu",
                             prefill_batch=2, decode_steps=2)
    engine.submit(Request(list(r.randint(0, 64, size=attn.FLASH_MIN_SEQ + 5)), 3))
    engine.submit(Request([1, 2, 3], 2))
    assert [len(o.tokens) for o in engine.run()] in ([2, 3], [3, 2])
    assert fe.fused_qkv_attention.launches == 0
    assert fe.fused_mlp.launches == 0
    assert fe.fused_qkv_attention_bwd.launches == 0
    assert fe.fused_mlp_bwd.launches == 0
    assert fa.flash_attention_forward.launches == 0
    assert qa.quantized_cache_attention.launches == 0


def test_cpu_lm_training_launches_no_kernel():
    """A packed LM train step on the CPU (remat, flash attention with
    segment ids, a differentiated bias too): the backward runs the plain
    versions of #7-#9."""
    fa.reset_launch_counts()
    fe.reset_launch_counts()
    model, trainer = lm_train.main([
        "--device", "cpu", "--packed-docs", "synthetic", "--seq-len", "64", "--batch-size", "2",
        "--n-layer", "1", "--d-model", "64", "--n-head", "2", "--vocab-size", "64",
        "--steps", "2"])
    assert trainer.step == 2 and all(np.isfinite(r["loss"]) for r in trainer.logger.records)
    q = torch.randn(1, 2, attn.FLASH_MIN_SEQ, 32, requires_grad=True)
    bias = torch.zeros(1, 2, 1, attn.FLASH_MIN_SEQ, requires_grad=True)
    fa.flash_attention(q, q, q, bias, True).sum().backward()
    out, lse = fa.flash_attention_lse(q, q, q, True)
    (out.sum() + lse.sum()).backward()
    assert bias.grad is not None and q.grad is not None
    for counter in (fa.flash_attention_forward, fa.flash_attention_bwd,
                    fa.flash_attention_bwd_dbias, fe.fused_mlp, fe.fused_mlp_bwd):
        assert counter.launches == 0


FLAVA_TINY = ["model.image_size=32", "model.patch_size=8", "model.vocab_size=300",
              "data.batch_size=4", "data.text_len=8"] + [
    f"model.overrides.{k}={v}" for k, v in dict(
        image_hidden_size=64, image_num_hidden_layers=1, image_num_attention_heads=2,
        image_intermediate_size=128, text_hidden_size=64, text_num_hidden_layers=1,
        text_num_attention_heads=2, text_intermediate_size=128, multimodal_hidden_size=64,
        multimodal_num_hidden_layers=1, multimodal_num_attention_heads=2,
        multimodal_intermediate_size=128, text_and_image_proj_size=32,
        max_position_embeddings=16).items()]


def test_flava_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        flava_model(image_size=32, patch_size=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        flava_model_for_pretraining(image_size=32, patch_size=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        flava_pretrain.main(FLAVA_TINY + ["train.steps=1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        flava_model_for_classification(num_classes=2, image_size=32, patch_size=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        flava_finetune.main(FLAVA_TINY + ["train.steps=1"])


def test_cpu_flava_training_launches_no_kernel():
    """Two FLAVA pretraining steps on the CPU at widths the fused kernels
    take: the plain versions of #3 and of the MLP backward run, no kernel."""
    fe.reset_launch_counts()
    fa.reset_launch_counts()
    model, trainer = flava_pretrain.main(["--device", "cpu", *FLAVA_TINY, "train.steps=2"])
    assert trainer.step == 2 and all(np.isfinite(r["loss"]) for r in trainer.logger.records)
    for counter in (fe.fused_qkv_attention, fe.fused_qkv_attention_bwd, fe.fused_mlp,
                    fe.fused_mlp_bwd, fe.fused_mlp_bwd_acc, fa.flash_attention_forward):
        assert counter.launches == 0


HOST_ONLY = {"regex", "PIL", "ftfy", "datasets"}  # absent on the card's machine
# modules that import PIL or HF datasets inside the functions that need them
LAZY = {"PIL": {"multimodal_tpu_torch/data/datamodules.py",
                "multimodal_tpu_torch/data/webdataset.py"},
        "datasets": {"multimodal_tpu_torch/data/datasets.py"}}
BPE_PATH = ROOT / "tests" / "assets" / "clip_merges.bpe"


def test_every_module_imports_and_tokenizes_without_regex_pil_ftfy():
    """The card's machine has no regex, PIL or ftfy: every module still
    imports, and the text transform (Python and native) tokenizes."""
    blocked = "; ".join(f"sys.modules[{name!r}] = None"
                        for name in sorted(FORBIDDEN | HOST_ONLY))
    imports = "; ".join(f"importlib.import_module({m!r})" for m in _port_modules())
    code = (f"import importlib, sys; {blocked}; {imports}; "
            "from multimodal_tpu_torch.transforms.clip_transform import CLIPTextTransform; "
            f"p = {str(BPE_PATH)!r}; "
            "a = CLIPTextTransform(p)(\"It's a photo of 2 cats!\"); "
            "b = CLIPTextTransform(p, native=True)(\"It's a photo of 2 cats!\"); "
            "print(a[:12].tolist() == b[:12].tolist(), a[:12].tolist())")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    from multimodal_tpu_torch.transforms.clip_transform import CLIPTextTransform

    want = CLIPTextTransform(str(BPE_PATH))("It's a photo of 2 cats!")[:12].tolist()
    assert proc.stdout.strip() == f"True {want}"
    assert want[0] == 49406 and 49407 in want


def test_no_host_only_imports_at_module_level():
    """regex and ftfy appear nowhere in the port; PIL only inside the
    functions of the data modules' image-file decoding, HF datasets only
    inside
    data/datasets.py's arrow and hub loaders."""
    offenders = []
    for f in sorted((ROOT / "multimodal_tpu_torch").rglob("*.py")):
        tree = ast.parse(f.read_text(), str(f))
        top = set(map(id, tree.body))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for n in names:
                root = n.split(".")[0]
                lazy = (id(node) not in top
                        and f.relative_to(ROOT).as_posix() in LAZY.get(root, ()))
                if root in HOST_ONLY and not lazy:
                    offenders.append(f"{f.name}: {n}")
    assert not offenders


@pytest.mark.parametrize("cxx", ["/nonexistent/g++", "false"])
def test_native_tokenizers_raise_when_the_build_fails(cxx):
    """No fallback hides the native library: with a compiler that is missing
    or fails, each native tokenizer and the native resampler raise and name
    the compiler."""
    code = ("import numpy as np\n"
            "from multimodal_tpu_torch.native.bpe import NativeCLIPBPETokenizer\n"
            "from multimodal_tpu_torch.native.resample import resample_native\n"
            "from multimodal_tpu_torch.native.wordpiece import NativeWordPieceTokenizer\n"
            "for make in (lambda: NativeCLIPBPETokenizer("
            f"{str(BPE_PATH)!r}, num_merges=100), "
            "lambda: NativeWordPieceTokenizer(['[UNK]', 'a']), "
            "lambda: resample_native(np.zeros((4, 4, 3), np.uint8), (2, 2), 'bicubic')):\n"
            "    try:\n"
            "        make()\n"
            "    except RuntimeError as e:\n"
            f"        assert {cxx!r} in str(e), e\n"
            "        print('raised')\n")
    env = {**os.environ, "CXX": cxx}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120, env=env)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["raised", "raised", "raised"]


def test_clip_resnet_builders_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in ("clip_rn50", "clip_rn101", "clip_rn50x4", "clip_rn50x16", "clip_rn50x64"):
        with pytest.raises(RuntimeError, match="CUDA"):
            getattr(clip_model, name)()


def test_flava_data_path_runs_without_pil_or_datasets(tmp_path):
    """With PIL and HF datasets blocked, the FLAVA transform and the
    recipe's real batches run over a jsonl of .npy images (the card's
    machine has neither)."""
    import json

    r = np.random.RandomState(0)
    with open(tmp_path / "pairs.jsonl", "w") as f:
        for i in range(4):
            np.save(tmp_path / f"{i}.npy", r.randint(0, 256, (40, 36, 3)).astype(np.uint8))
            f.write(json.dumps({"image": str(tmp_path / f"{i}.npy"), "text": "a cat"}) + "\n")
    blocked = "; ".join(f"sys.modules[{name!r}] = None" for name in sorted(HOST_ONLY))
    code = (f"import sys; {blocked}\n"
            "from multimodal_tpu_torch.examples.flava import pretrain as p\n"
            "cfg = p.build_config(None, ['data.path=" + str(tmp_path / "pairs.jsonl") + "', "
            "'data.batch_size=2', 'model.image_size=32', 'model.patch_size=8'], "
            "defaults=p.DEFAULTS)\n"
            "b = next(p.real_batches(cfg))\n"
            "print(sorted((k, tuple(v.shape)) for k, v in b.items()))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "('image_for_codebook', (2, 32, 32, 3))" in proc.stdout
    assert "('image_patches_mask', (2, 4, 4))" in proc.stdout


ALBEF_TINY = dict(hidden=64, ff=128, heads=2, layers=1, vocab=50)


def _albef_tiny():
    from multimodal_tpu_torch.examples.albef.model import ALBEFModelForRetrieval
    from multimodal_tpu_torch.models.albef.image_encoder import ALBEFVisionEncoder
    from multimodal_tpu_torch.models.albef.model import ALBEFModel, ALBEFModelWithSimilarity
    from multimodal_tpu_torch.models.albef.multimodal_encoder import ALBEFMultimodalEncoder
    from multimodal_tpu_torch.modules.encoders.bert_text_encoder import bert_text_encoder

    t = ALBEF_TINY
    albef = ALBEFModel(
        ALBEFVisionEncoder(image_size=32, patch_size=8, num_hidden_layers=t["layers"],
                           num_attention_heads=t["heads"], hidden_size=t["hidden"],
                           mlp_dim=t["ff"]),
        bert_text_encoder(hidden_size=t["hidden"], num_hidden_layers=t["layers"],
                          num_attention_heads=t["heads"], intermediate_size=t["ff"],
                          dropout=0.0, vocab_size=t["vocab"], max_position_embeddings=16),
        ALBEFMultimodalEncoder(hidden_size=t["hidden"], num_hidden_layers=t["layers"],
                               num_attention_heads=t["heads"], intermediate_size=t["ff"]))
    sim = ALBEFModelWithSimilarity(albef, torch.nn.Linear(t["hidden"], 8),
                                   torch.nn.Linear(t["hidden"], 8), embed_size=8, queue_size=8)
    return ALBEFModelForRetrieval(sim, hidden_size=t["hidden"])


def test_albef_entry_points_raise_without_cuda(monkeypatch):
    """The ALBEF constructors of state (the queues, the momentum copy)
    default to CUDA and raise without it."""
    from multimodal_tpu_torch.models.albef.model import init_albef_queues
    from multimodal_tpu_torch.utils.common import momentum_copy

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_albef_queues(8, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        momentum_copy(torch.nn.Linear(2, 2))


def test_cpu_albef_retrieval_step_launches_no_kernel():
    """An ALBEF retrieval step on the CPU at widths the fused kernels take
    (text S = 8 with padding, image S = 17): the plain versions run, no
    kernel; gradients reach every parameter of the trained model."""
    from multimodal_tpu_torch.examples.albef.model import albef_retrieval_train_step
    from multimodal_tpu_torch.models.albef.model import init_albef_queues
    from multimodal_tpu_torch.utils.common import momentum_copy

    fe.reset_launch_counts()
    fa.reset_launch_counts()
    torch.manual_seed(0)
    model = _albef_tiny()
    model_m = momentum_copy(model.model_with_similarity, device="cpu")
    queues = init_albef_queues(8, 8, device="cpu")
    r = np.random.RandomState(0)
    atts = np.ones((4, 8), np.int64)
    atts[1, 5:] = 0
    text = torch.from_numpy(r.randint(1, 50, (4, 8)) * atts)
    loss = albef_retrieval_train_step(
        model, model_m, queues, torch.from_numpy(r.randn(4, 32, 32, 3).astype(np.float32)),
        text, torch.from_numpy(atts), torch.arange(4), torch.Generator().manual_seed(0))
    loss.backward()
    assert torch.isfinite(loss) and int(queues.queue_ptr) == 4
    assert all(p.grad is not None for p in model.parameters())
    for counter in (fe.fused_qkv_attention, fe.fused_qkv_attention_bwd, fe.fused_mlp,
                    fe.fused_mlp_bwd, fe.fused_mlp_bwd_acc, fa.flash_attention_forward,
                    fa.flash_attention_bwd):
        assert counter.launches == 0


def test_clip_image_transform_runs_without_pil(tmp_path):
    """With PIL blocked (the card's machine has none), the CLIP image
    transform takes uint8 arrays through the port's resampler, train and
    eval."""
    blocked = "; ".join(f"sys.modules[{name!r}] = None" for name in sorted(HOST_ONLY))
    code = (f"import sys; {blocked}\n"
            "import numpy as np\n"
            "from multimodal_tpu_torch.transforms.clip_transform import CLIPImageTransform\n"
            "im = np.random.RandomState(0).randint(0, 256, (50, 40, 3)).astype(np.uint8)\n"
            "for train in (False, True):\n"
            "    t = CLIPImageTransform(24, is_train=train, rng=np.random.RandomState(1))\n"
            "    print(tuple(t(im).shape))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split("\n")[:2] == ["(24, 24, 3)", "(24, 24, 3)"]


COCA_TINY = dict(vision_patch_size=8, vision_dim_feedforward=128, vision_n_layer=1,
                 vision_n_head=2, vocab_size=100, num_text_positions=40, text_hidden_dim=64,
                 text_n_layer=1, text_n_head=2, text_dim_feedforward=128, text_output_dim=64,
                 fusion_n_layer=1, fusion_n_head=2, fusion_dim_feedforward=128,
                 pooler_input_embed_dim=64, pooler_output_embed_dim=64, pooler_n_head=2,
                 image_size=48, multimodal_output_projection_dim=100, pooler_n_queries=32)


def test_coca_entry_points_raise_without_cuda(monkeypatch):
    from multimodal_tpu_torch.models.coca import coca_model

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build in (coca_model.coca_vit_b_32, coca_model.coca_vit_l_14,
                  lambda: coca_model.coca_vit(**COCA_TINY),
                  lambda: coca_model.coca_for_pretraining(**COCA_TINY)):
        with pytest.raises(RuntimeError, match="CUDA"):
            build()


def test_cpu_coca_and_blip2_steps_launch_no_kernel():
    """A CoCa pretraining step (the text and fusion self-attention past the
    flash threshold with their dense masks, the pooler's 32 queries) and a
    BLIP-2 stage-1 step (32 queries, the ITM 3x batch) on the CPU: the
    plain versions run, no kernel; every trained parameter gets a
    gradient, the frozen tower none."""
    from multimodal_tpu_torch.models.blip2.blip2 import BLIP2
    from multimodal_tpu_torch.models.blip2.qformer_model import QformerForCLM
    from multimodal_tpu_torch.models.coca.coca_model import coca_for_pretraining
    from multimodal_tpu_torch.modules.encoders.vision_transformer import vision_transformer
    from multimodal_tpu_torch.modules.losses.blip2_losses import (
        Blip2Phase1Loss,
        blip2_phase1_loss,
    )

    fe.reset_launch_counts()
    fa.reset_launch_counts()
    r = np.random.RandomState(0)
    coca = coca_for_pretraining(device="cpu", **COCA_TINY)
    texts = torch.from_numpy(r.randint(1, 100, (2, 40)))
    texts[1, 30:] = 0
    images = torch.from_numpy(r.randn(2, 48, 48, 3).astype(np.float32))
    losses = coca(images, texts)
    sum(losses.values()).backward()
    assert all(p.grad is not None for p in coca.parameters())
    torch.manual_seed(0)
    model = BLIP2(QformerForCLM(num_hidden_layers=2, dim_q=64, dim_feedforward=128, num_heads=2,
                                max_position_embeddings=40, vocab_size=100, dim_kv=64),
                  vision_transformer(patch_size=8, hidden_dim=64, dim_feedforward=128,
                                     n_layer=1, n_head=2, image_size=48),
                  dim_q=64, image_encoder_embedding_dim=64, decoder_bos_token_id=99)
    loss = Blip2Phase1Loss(dim_q=64)
    atts = torch.ones(2, 36, dtype=torch.long)
    atts[0, 20:] = 0
    ids = torch.from_numpy(r.randint(1, 99, (2, 36))) * atts
    out = model(images, ids, atts)
    total = blip2_phase1_loss(loss, model, out, ids, atts, torch.Generator().manual_seed(0),
                              decoder_bos_token_id=99, vocab_size=100).total_loss
    total.backward()
    assert torch.isfinite(total)
    assert all(p.grad is None for p in model.vision_encoder.parameters())
    assert all(p.grad is not None for n, p in model.named_parameters()
               if not n.startswith("vision_encoder"))
    for counter in (fe.fused_qkv_attention, fe.fused_qkv_attention_bwd, fe.fused_mlp,
                    fe.fused_mlp_bwd, fe.fused_mlp_bwd_acc, fa.flash_attention_forward,
                    fa.flash_attention_bwd, fa.flash_attention_bwd_dbias):
        assert counter.launches == 0

"""The port's zero-shot protocol (multimodal_tpu_torch/training/
zero_shot.py, data/imagenet_zeroshot.py) held against the JAX package's on
a small CLIP whose weights the converter carries over, strings to top-k."""

import filecmp
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_tpu.data import imagenet_zeroshot as jiz
from multimodal_tpu.models.clip.image_encoder import CLIPViTEncoder as JaxViT
from multimodal_tpu.models.clip.model import CLIP as JaxCLIP
from multimodal_tpu.models.clip.text_encoder import CLIPTextEncoder as JaxText
from multimodal_tpu.training import zero_shot as jzs
from multimodal_tpu.transforms.clip_transform import CLIPTextTransform as JaxTextTransform
from multimodal_tpu_torch.data import imagenet_zeroshot as piz
from multimodal_tpu_torch.models.clip.image_encoder import CLIPViTEncoder
from multimodal_tpu_torch.models.clip.model import CLIP
from multimodal_tpu_torch.models.clip.text_encoder import CLIPTextEncoder
from multimodal_tpu_torch.training import zero_shot as pzs
from multimodal_tpu_torch.transforms.clip_transform import CLIPTextTransform
from multimodal_tpu_torch.utils.checkpoint import clip_state_dict_from_jax

BPE_PATH = os.path.join(os.path.dirname(__file__), "assets", "clip_merges.bpe")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# fp32 through one-layer towers, normalised: the same arithmetic in two
# frameworks, sums in another order
ATOL = 1e-5
VISION = dict(embedding_dim=32, patch_size=16, image_size=32, width=64, heads=2, layers=1)
TEXT = dict(embedding_dim=32, context_length=77, vocab_size=49408, width=64,
            dim_feedforward=128, heads=2, layers=1)


@pytest.fixture(scope="module")
def small():
    jax_model = JaxCLIP(JaxViT(**VISION), JaxText(**TEXT))
    variables = jax.jit(jax_model.init)(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)),
                                        jnp.zeros((1, 77), jnp.int32))
    variables = jax.tree_util.tree_map(np.asarray, jax.device_get(variables))
    port = CLIP(CLIPViTEncoder(**VISION), CLIPTextEncoder(**TEXT)).eval()
    port.load_state_dict(clip_state_dict_from_jax(variables, 1, 1), strict=True)
    jax_text = jax.jit(lambda ids: jax_model.apply(variables, ids, method=JaxCLIP.encode_text))
    jax_image = jax.jit(lambda x: jax_model.apply(variables, x, method=JaxCLIP.encode_image))

    def port_text(ids):
        with torch.inference_mode():
            return port.encode_text(ids)

    def port_image(images):
        with torch.inference_mode():
            return port.encode_image(torch.as_tensor(images))

    return dict(jax_text=lambda ids: jax_text(jnp.asarray(ids)), jax_image=jax_image,
                jax_tokenize=JaxTextTransform(BPE_PATH), port_text=port_text,
                port_image=port_image, port_tokenize=CLIPTextTransform(BPE_PATH))


def test_asset_copy_equal_jax():
    assert filecmp.cmp(os.path.join(ROOT, "multimodal_tpu_torch/data/assets/imagenet_zeroshot.json"),
                       os.path.join(ROOT, "multimodal_tpu/data/assets/imagenet_zeroshot.json"),
                       shallow=False)
    assert piz.imagenet_classnames() == jiz.imagenet_classnames()
    assert piz.imagenet_templates() == jiz.imagenet_templates()
    assert len(piz.imagenet_classnames()) == 1000 and len(piz.imagenet_templates()) == 80
    assert pzs.DEFAULT_PROMPT_TEMPLATES == jzs.DEFAULT_PROMPT_TEMPLATES


@pytest.mark.parametrize("templates", [None, slice(0, 3)])
def test_classifier_equal_jax(small, templates):
    names = piz.imagenet_classnames()[:10]
    tpl = pzs.DEFAULT_PROMPT_TEMPLATES if templates is None else \
        piz.imagenet_templates()[templates]
    want = jzs.build_zero_shot_classifier(small["jax_text"], small["jax_tokenize"], names, tpl,
                                          batch_size=4)
    got = pzs.build_zero_shot_classifier(small["port_text"], small["port_tokenize"], names,
                                         tpl, batch_size=4)
    assert got.shape == (32, 10) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    np.testing.assert_allclose(np.linalg.norm(got.numpy(), axis=0), 1.0, atol=1e-6)


def test_accuracy_equal_jax():
    r = np.random.RandomState(0)
    classifier = r.randn(16, 40).astype(np.float32)
    classifier /= np.linalg.norm(classifier, axis=0)
    emb = r.randn(64, 16).astype(np.float32)
    labels = r.randint(0, 40, size=64)
    labels[:20] = (emb[:20] @ classifier).argmax(-1)  # some top-1 hits
    want = jzs.zero_shot_accuracy(jnp.asarray(emb), jnp.asarray(labels), jnp.asarray(classifier))
    got = pzs.zero_shot_accuracy(torch.from_numpy(emb), torch.from_numpy(labels),
                                 torch.from_numpy(classifier))
    assert got == want
    assert got["top1"] >= 20 / 64
    got3 = pzs.zero_shot_accuracy(emb, labels, torch.from_numpy(classifier), top_k=(1, 3, 10))
    assert got3 == jzs.zero_shot_accuracy(jnp.asarray(emb), jnp.asarray(labels),
                                          jnp.asarray(classifier), top_k=(1, 3, 10))


def test_imagenet_eval_equal_jax(small):
    r = np.random.RandomState(1)
    names = piz.imagenet_classnames()[100:112]
    tpl = piz.imagenet_templates()[:2]
    batches = [{"image": r.randn(n, 32, 32, 3).astype(np.float32),
                "labels": r.randint(0, 12, size=n)} for n in (5, 7)]
    want = jiz.imagenet_zero_shot_eval(small["jax_image"], small["jax_text"],
                                       small["jax_tokenize"], batches, names, tpl)
    got = piz.imagenet_zero_shot_eval(small["port_image"], small["port_text"],
                                      small["port_tokenize"], batches, names, tpl)
    assert got == want
    assert set(got) == {"top1", "top5"}

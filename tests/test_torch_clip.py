"""The port's CLIP (multimodal_tpu_torch/models/clip) held against the JAX
package's, through the weight carry-over utils/checkpoint.py:
clip_state_dict_from_jax."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_tpu.models.clip.image_encoder import CLIPViTEncoder as JaxViT
from multimodal_tpu.models.clip.model import CLIP as JaxCLIP
from multimodal_tpu.models.clip.model import clip_vit_b32 as jax_clip_vit_b32
from multimodal_tpu.models.clip.text_encoder import CLIPTextEncoder as JaxText
from multimodal_tpu.utils.checkpoint import clip_params_from_torch
from multimodal_tpu_torch.models.clip.image_encoder import CLIPViTEncoder
from multimodal_tpu_torch.models.clip.model import CLIP, clip_vit_b32
from multimodal_tpu_torch.models.clip.text_encoder import CLIPTextEncoder
from multimodal_tpu_torch.utils.checkpoint import clip_state_dict_from_jax

# fp32 through two reduced towers: the same arithmetic in two frameworks,
# sums in another order
ATOL = 1e-4
VISION = dict(embedding_dim=32, patch_size=16, image_size=64, width=128, heads=2, layers=2)
TEXT = dict(embedding_dim=32, context_length=77, vocab_size=1000, width=128,
            dim_feedforward=512, heads=2, layers=2)


def _token_ids(r, n):
    ids = r.randint(1, 998, size=(n, 77)).astype(np.int32)
    for i, length in enumerate(r.randint(3, 76, size=n)):
        ids[i, length] = 999  # EOT: the highest id
        ids[i, length + 1:] = 0
    return ids


@pytest.fixture(scope="module")
def reduced():
    jax_model = JaxCLIP(JaxViT(**VISION), JaxText(**TEXT))
    variables = jax_model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), jnp.zeros((1, 77), jnp.int32)
    )
    variables = jax.tree_util.tree_map(np.asarray, variables)
    port = CLIP(CLIPViTEncoder(**VISION), CLIPTextEncoder(**TEXT)).eval()
    port.load_state_dict(clip_state_dict_from_jax(variables, 2, 2), strict=True)
    r = np.random.RandomState(0)
    images = r.randn(3, 64, 64, 3).astype(np.float32)
    ids = _token_ids(r, 3)
    return jax_model, variables, port, images, ids


def test_encode_image_matches_jax(reduced):
    jax_model, variables, port, images, _ = reduced
    want = jax_model.apply(variables, jnp.asarray(images), method=JaxCLIP.encode_image)
    with torch.inference_mode():
        got = port.encode_image(torch.from_numpy(images))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_encode_text_matches_jax(reduced):
    jax_model, variables, port, _, ids = reduced
    want = jax_model.apply(variables, jnp.asarray(ids), method=JaxCLIP.encode_text)
    with torch.inference_mode():
        got = port.encode_text(torch.from_numpy(ids))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_call_matches_jax(reduced):
    jax_model, variables, port, images, ids = reduced
    want = jax_model.apply(variables, jnp.asarray(images), jnp.asarray(ids))
    with torch.inference_mode():
        got = port(torch.from_numpy(images), torch.from_numpy(ids))
    np.testing.assert_allclose(got.embeddings_a.numpy(), np.asarray(want.embeddings_a), atol=ATOL)
    np.testing.assert_allclose(got.embeddings_b.numpy(), np.asarray(want.embeddings_b), atol=ATOL)


def test_weight_round_trip(reduced):
    """clip_params_from_torch(clip_state_dict_from_jax(p)) == p, leaf for leaf."""
    _, variables, _, _, _ = reduced
    back = clip_params_from_torch(clip_state_dict_from_jax(variables, 2, 2), 2, 2)
    want = jax.tree_util.tree_leaves_with_path(variables)
    got = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        assert g.shape == w.shape, path
        np.testing.assert_array_equal(g, w, err_msg=str(path))


def test_full_width_builder_matches_jax_shapes():
    """clip_vit_b32 on the meta device has the JAX init's parameters: the
    same names (through the carry-over), shapes and count."""
    shapes = jax.eval_shape(
        jax_clip_vit_b32().init, jax.random.PRNGKey(0),
        jnp.zeros((1, 224, 224, 3)), jnp.zeros((1, 77), jnp.int32),
    )
    # zero arrays from calloc: never touched, so no memory is committed
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
    want = {k: tuple(v.shape) for k, v in clip_state_dict_from_jax(zeros).items()}
    model = clip_vit_b32(device="meta")
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert got == want
    n_jax = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes))
    assert sum(p.numel() for p in model.parameters()) == n_jax

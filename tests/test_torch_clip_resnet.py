"""The port's CLIP ResNet towers (multimodal_tpu_torch/models/clip/
resnet_encoder.py and the clip_rn* builders) held against the JAX package's,
through utils/checkpoint.py:clip_resnet_state_dict_from_jax."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_tpu.models.clip import model as jax_clip
from multimodal_tpu.models.clip.model import CLIP as JaxCLIP
from multimodal_tpu.models.clip.resnet_encoder import ResNetForCLIP as JaxResNet
from multimodal_tpu.models.clip.text_encoder import CLIPTextEncoder as JaxText
from multimodal_tpu_torch.models.clip import model as port_clip
from multimodal_tpu_torch.models.clip.model import CLIP
from multimodal_tpu_torch.models.clip.resnet_encoder import ResNetForCLIP
from multimodal_tpu_torch.models.clip.text_encoder import CLIPTextEncoder
from multimodal_tpu_torch.ops import attention as attn
from multimodal_tpu_torch.utils.checkpoint import clip_resnet_state_dict_from_jax

# fp32 through five convolution stages and the attention pool: the same
# arithmetic in two frameworks, sums in another order. Outputs are O(1).
ATOL = 2e-4
# the running statistics after one train-mode forward: batch means and
# variances of fp32 activations, E[x^2] - E[x]^2 on both sides
STATS_RTOL, STATS_ATOL = 1e-4, 1e-5
# width 8 puts 256 channels (4 heads of 64) into the pool; 192 pixels make
# a 6 x 6 grid, 37 tokens: past FLASH_MIN_SEQ, so the flash wrapper's CPU
# route runs
RESNET = dict(layers=(1, 1, 1, 1), output_dim=32, heads=4, input_resolution=192, width=8)
TEXT = dict(embedding_dim=32, context_length=77, vocab_size=100, width=64,
            dim_feedforward=128, heads=2, layers=1)
BUILDERS = ("clip_rn50", "clip_rn101", "clip_rn50x4", "clip_rn50x16", "clip_rn50x64")


def _random_variables(shapes, r):
    """Variables of the shapes ``jax.eval_shape`` gave for ``init``, drawn
    from ``r`` (faster than running ``init`` op by op): kernels and
    embeddings at their init's scale, every bias, norm scale and BatchNorm
    statistic drawn too. With the JAX init's zero bn3 scales the bottleneck
    branches would add nothing, and unit statistics would hide a swapped
    mean and variance."""

    def leaf(path, s):
        name = path[-1].key
        if name == "kernel":
            return r.normal(0, np.prod(s.shape[:-1]) ** -0.5, s.shape)
        if name in ("positional_embedding", "cls_token_embedding"):
            return r.normal(0, s.shape[-1] ** -0.5, s.shape)
        if name == "embedding":
            return r.normal(0, 0.02, s.shape)
        if name == "scale":
            return r.uniform(0.5, 1.5, s.shape)
        if name == "var":
            return r.uniform(0.5, 1.5, s.shape)
        return r.normal(0, 0.1, s.shape)  # biases, BatchNorm means

    tree = jax.tree_util.tree_map_with_path(lambda p, s: leaf(p, s).astype(np.float32), shapes)
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def narrow():
    jax_model = JaxCLIP(JaxResNet(**RESNET), JaxText(**TEXT))
    res = RESNET["input_resolution"]
    shapes = jax.eval_shape(jax_model.init, jax.random.PRNGKey(0),
                            jax.ShapeDtypeStruct((1, res, res, 3), jnp.float32),
                            jax.ShapeDtypeStruct((1, 77), jnp.int32))
    r = np.random.RandomState(0)
    variables = _random_variables(shapes, r)
    port = CLIP(ResNetForCLIP(**RESNET), CLIPTextEncoder(**TEXT)).eval()
    port.load_state_dict(clip_resnet_state_dict_from_jax(variables, 1), strict=True)
    images = r.randn(2, res, res, 3).astype(np.float32)
    return jax_model, variables, port, images


def test_encode_image_matches_jax(narrow, monkeypatch):
    jax_model, variables, port, images = narrow
    routes = []
    monkeypatch.setattr(attn, "flash_attention",
                        lambda *a, **k: routes.append(a[0].shape) or attn.attention_plain(
                            *a[:3], a[3], a[4], a[5], a[6], a[7])[0])
    want = jax.jit(lambda v, x: jax_model.apply(v, x, method=JaxCLIP.encode_image))(
        variables, jnp.asarray(images))
    with torch.inference_mode():
        got = port.encode_image(torch.from_numpy(images))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    assert routes == [(2, 4, 37, 64)]  # the pool took the flash route once


def test_tower_matches_jax_unnormalized(narrow):
    jax_model, variables, port, images = narrow
    tower = JaxResNet(**RESNET)
    want = jax.jit(tower.apply)({"params": variables["params"]["encoder_a"],
                                 "batch_stats": variables["batch_stats"]["encoder_a"]},
                                jnp.asarray(images))
    with torch.inference_mode():
        got = port.encoder_a(torch.from_numpy(images))
    scale = float(np.abs(np.asarray(want)).max())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL * max(1.0, scale))


def test_train_mode_forward_and_running_stats(narrow):
    """One train-mode forward: batch statistics normalise, and the running
    ones move by flax's momentum 0.9 (torch's 0.1)."""
    _, variables, _, images = narrow
    tower = JaxResNet(**RESNET)
    want, updated = jax.jit(lambda v, x: tower.apply(v, x, deterministic=False,
                                                     mutable=["batch_stats"]))(
        {"params": variables["params"]["encoder_a"],
         "batch_stats": variables["batch_stats"]["encoder_a"]}, jnp.asarray(images))
    port = ResNetForCLIP(**RESNET)
    sd = clip_resnet_state_dict_from_jax(variables, 1)
    port.load_state_dict({k[len("encoder_a."):]: v for k, v in sd.items()
                          if k.startswith("encoder_a.")})
    port.train()
    with torch.no_grad():
        got = port(torch.from_numpy(images))
    scale = float(np.abs(np.asarray(want)).max())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL * max(1.0, scale))
    new = {"params": variables["params"],
           "batch_stats": {"encoder_a": jax.device_get(updated["batch_stats"])}}
    want_sd = clip_resnet_state_dict_from_jax(new, 1)
    got_sd = port.state_dict()
    names = [k for k in got_sd if k.endswith(("running_mean", "running_var"))]
    assert len(names) == 2 * (3 + 4 * 3 + 4)  # stem 3, 4 blocks x 3, 4 downsamples
    for k in names:
        np.testing.assert_allclose(got_sd[k].numpy(), want_sd[f"encoder_a.{k}"].numpy(),
                                   rtol=STATS_RTOL, atol=STATS_ATOL, err_msg=k)
        assert not np.allclose(got_sd[k].numpy(), sd[f"encoder_a.{k}"].numpy())


@pytest.mark.parametrize("name", BUILDERS)
def test_full_width_parameter_shapes_match_jax(name):
    """Every parameter and statistic of the full-width builders, by name and
    shape: JAX's through jax.eval_shape (no compute) and the converter, the
    port's built on the meta device."""
    jax_model = getattr(jax_clip, name)()
    res = jax_model.encoder_a.input_resolution
    shapes = jax.eval_shape(jax_model.init, jax.random.PRNGKey(0),
                            jax.ShapeDtypeStruct((1, res, res, 3), jnp.float32),
                            jax.ShapeDtypeStruct((1, 77), jnp.int32))
    # np.empty reserves no memory it does not touch, and the converter only
    # transposes views
    arrays = jax.tree_util.tree_map(lambda s: np.empty(s.shape, np.float32), shapes)
    want = {k: tuple(v.shape) for k, v in clip_resnet_state_dict_from_jax(arrays).items()}
    model = getattr(port_clip, name)(device="meta")
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert got == want
    assert model.encoder_a.input_resolution == res

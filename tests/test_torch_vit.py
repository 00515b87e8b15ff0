"""The port's shared ViT stack held against the JAX package: random masking
(1-d and 2-d) with JAX's own noise, ``PatchEmbeddings`` (mask token, patch
drop with the noise the JAX module drew, no CLS), ``VisionTransformer`` on
the fused attention route (S <= 256) and the flash route (S = 577, ALBEF's
ViT-B/16 length at 384) through their plain versions, ``GlobalAveragePooler``
and the ``vit_*`` builders' parameter shapes.

Weights are the JAX modules' own, carried by path
(``utils/checkpoint.py:state_dict_from_jax_tree``); inputs come from a numpy
seed. fp32 throughout: the same arithmetic in two frameworks, sums in
another order; ATOL is set from the readings (up to 2e-6 on outputs of
unit scale).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_tpu.modules.encoders import vision_transformer as jvit
from multimodal_tpu.modules.layers import patch_embedding as jpe
from multimodal_tpu.modules.masking import random_masking as jrm
from multimodal_tpu_torch.modules.encoders import vision_transformer as tvit
from multimodal_tpu_torch.modules.layers import multi_head_attention as tmha
from multimodal_tpu_torch.modules.layers.patch_embedding import PatchEmbeddings
from multimodal_tpu_torch.modules.masking import random_masking as trm
from multimodal_tpu_torch.ops import attention as tattn
from multimodal_tpu_torch.utils import checkpoint as ckpt
from multimodal_tpu_torch.utils.checkpoint import state_dict_from_jax_tree

ATOL = 2e-5


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _load(module, variables):
    module.load_state_dict(state_dict_from_jax_tree(_np(variables)["params"]), strict=True)
    return module


@pytest.mark.parametrize("ratio", [0.25, 0.5, 0.75])
def test_random_masking_matches_jax_with_its_noise(ratio):
    r = np.random.RandomState(0)
    x = r.randn(3, 16, 5).astype(np.float32)
    key = jax.random.PRNGKey(7)
    want = jrm.random_masking(key, jnp.asarray(x), ratio)
    noise = torch.from_numpy(np.array(jax.random.uniform(key, (3, 16))))
    got = trm.random_masking(torch.from_numpy(x), ratio, noise=noise)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # drawn from a generator: the same rules
    drawn = trm.random_masking(torch.from_numpy(x), ratio,
                               generator=torch.Generator().manual_seed(0))
    assert drawn.x_masked.shape == got.x_masked.shape
    assert drawn.mask.sum(1).tolist() == [16 - int(16 * (1 - ratio))] * 3


def test_random_masking_refuses_keeping_nothing():
    with pytest.raises(ValueError, match="at least 1"):
        trm.random_masking(torch.zeros(1, 4, 2), 0.9)


@pytest.mark.parametrize("ratios", [(0.5, 0.25), (0.0, 0.75)])
def test_random_masking_2d_matches_jax_with_its_noise(ratios):
    r = np.random.RandomState(1)
    x = r.randn(2, 4 * 8, 3).astype(np.float32)
    key = jax.random.PRNGKey(3)
    want = jrm.random_masking_2d(key, jnp.asarray(x), ratios[0], ratios[1], 4, 8)
    kh, kw = jax.random.split(key)
    noise = (torch.from_numpy(np.array(jax.random.uniform(kh, (2, 4)))),
             torch.from_numpy(np.array(jax.random.uniform(kw, (2, 8)))))
    got = trm.random_masking_2d(torch.from_numpy(x), ratios[0], ratios[1], 4, 8, noise=noise)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


class _NoiseRecorder:
    """Wraps a JAX masking function to keep the key it was given."""

    def __init__(self, fn):
        self.fn, self.keys = fn, []

    def __call__(self, rng, *args, **kwargs):
        self.keys.append(rng)
        return self.fn(rng, *args, **kwargs)


@pytest.mark.parametrize("kind", ["plain", "mask_token", "drop_1d", "drop_2d", "no_cls"])
def test_patch_embeddings_match_jax(kind, monkeypatch):
    r = np.random.RandomState(2)
    b, size, patch, hid = 2, 16, 4, 24
    img = r.randn(b, size, size, 3).astype(np.float32)
    kw = dict(image_size=size, patch_size=patch, hidden_size=hid)
    if kind == "mask_token":
        kw["use_image_masking"] = True
    if kind == "drop_1d":
        kw["patch_drop_rate"] = 0.5
    if kind == "drop_2d":
        kw["patch_drop_rate"] = (0.5, 0.25)
    if kind == "no_cls":
        kw["include_cls_embed"] = False
    mask = (r.rand(b, (size // patch) ** 2) > 0.5) if kind == "mask_token" else None
    jm = jpe.PatchEmbeddings(**kw)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(img),
                        image_patches_mask=None if mask is None else jnp.asarray(mask))
    # the zero-initialised tables get values, so that each term shows
    variables = jax.tree.map(lambda a: a + 0.1 * jax.random.normal(jax.random.PRNGKey(1),
                                                                   a.shape), variables)
    deterministic = not kind.startswith("drop")
    rec = _NoiseRecorder(jrm.random_masking if kind == "drop_1d" else jrm.random_masking_2d)
    monkeypatch.setattr(jpe, "random_masking" if kind == "drop_1d" else "random_masking_2d", rec)
    want = jm.apply(variables, jnp.asarray(img),
                    image_patches_mask=None if mask is None else jnp.asarray(mask),
                    deterministic=deterministic, rngs={"patch_drop": jax.random.PRNGKey(9)})
    noise = None
    n = (size // patch) ** 2
    if kind == "drop_1d":
        noise = torch.from_numpy(np.array(jax.random.uniform(rec.keys[0], (b, n))))
    elif kind == "drop_2d":
        kh, kw_ = jax.random.split(rec.keys[0])
        noise = (torch.from_numpy(np.array(jax.random.uniform(kh, (b, 4)))),
                 torch.from_numpy(np.array(jax.random.uniform(kw_, (b, 4)))))
    tm = _load(PatchEmbeddings(**kw), variables)
    got = tm(torch.from_numpy(img), None if mask is None else torch.from_numpy(mask),
             deterministic=deterministic, noise=noise)
    np.testing.assert_allclose(got.embeddings.detach().numpy(), np.asarray(want.embeddings),
                               atol=ATOL)
    for g, w in ((got.random_mask, want.random_mask), (got.ids_restore, want.ids_restore)):
        assert (g is None) == (w is None)
        if g is not None:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_patch_embeddings_refusals():
    with pytest.raises(NotImplementedError, match="A6.5"):
        PatchEmbeddings(image_size=16, patch_size=4, hidden_size=8, use_fixed_sincos_pos=True)
    with pytest.raises(ValueError, match="divisible"):
        PatchEmbeddings(image_size=18, patch_size=4, hidden_size=8)
    with pytest.raises(ValueError, match="doesn't match"):
        PatchEmbeddings(image_size=16, patch_size=4, hidden_size=8)(torch.zeros(1, 8, 8, 3))


class _Recorder:
    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, *args, **kwargs):
        self.calls += 1
        return self.fn(*args, **kwargs)


@pytest.mark.parametrize("case", [
    # (image, patch, width, heads, layers): S = 17 takes #1's route; S = 577
    # (ALBEF's ViT-B/16 at 384) is past #1's 256 and takes the flash route
    ("fused_s17", 16, 4, 32, 2, 2),
    ("flash_s577", 48, 2, 32, 2, 1),
])
def test_vision_transformer_matches_jax(case, monkeypatch):
    name, size, patch, width, heads, layers = case
    r = np.random.RandomState(3)
    img = r.randn(2, size, size, 3).astype(np.float32)
    kw = dict(patch_size=patch, hidden_dim=width, dim_feedforward=2 * width, n_layer=layers,
              n_head=heads, image_size=size)
    jm = jvit.vision_transformer(**kw, pooler=jvit.GlobalAveragePooler(width, 8))
    variables = jm.init(jax.random.PRNGKey(4), jnp.asarray(img))
    variables = jax.tree.map(lambda a: a + 0.02 * jax.random.normal(jax.random.PRNGKey(5),
                                                                    a.shape), variables)
    want = jm.apply(variables, jnp.asarray(img))
    fused = _Recorder(tmha.fused_qkv_attention)
    flash = _Recorder(tattn.flash_attention)
    monkeypatch.setattr(tmha, "fused_qkv_attention", fused)
    monkeypatch.setattr(tattn, "flash_attention", flash)
    tm = _load(tvit.vision_transformer(**kw, pooler=tvit.GlobalAveragePooler(width, 8)),
               variables)
    got = tm(torch.from_numpy(img))
    seq = (size // patch) ** 2 + 1
    assert got.last_hidden_state.shape == (2, seq, width)
    assert (fused.calls, flash.calls) == ((layers, 0) if seq <= 256 else (0, layers))
    np.testing.assert_allclose(got.last_hidden_state.detach().numpy(),
                               np.asarray(want.last_hidden_state), atol=ATOL)
    np.testing.assert_allclose(got.pooler_output.detach().numpy(),
                               np.asarray(want.pooler_output), atol=ATOL)
    assert len(got.hidden_states) == len(want.hidden_states) == layers + 1
    for g, w in zip(got.hidden_states, want.hidden_states):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), atol=ATOL)


@pytest.mark.parametrize("builder", ["vit_b_16", "vit_b_32", "vit_l_16", "vit_l_32",
                                     "vit_h_14"])
def test_vit_builders_parameter_shapes_match_jax(builder, monkeypatch):
    """Every parameter of the full-size builders, by name and shape (JAX's
    through ``jax.eval_shape``, carried by the converter as zero-stride
    views into meta tensors; the port's built on the meta device: no memory,
    no compute)."""
    size = 224
    jm = getattr(jvit, builder)(image_size=size)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, size, size, 3), jnp.float32))
    monkeypatch.setattr(ckpt, "_t", lambda a: torch.empty(np.shape(a), device="meta"))
    views = jax.tree.map(lambda s: np.broadcast_to(np.float32(0), s.shape), shapes["params"])
    want = {k: tuple(v.shape) for k, v in ckpt.state_dict_from_jax_tree(views).items()}
    with torch.device("meta"):
        tm = getattr(tvit, builder)(image_size=size)
    got = {k: tuple(v.shape) for k, v in tm.state_dict().items()}
    assert got == want

"""The port's video VQ-VAE (multimodal_tpu_torch/modules/layers/conv.py,
codebook.py, attention.py, models/vqvae.py, models/video_gpt/video_vqvae.py)
held against the JAX package at VideoGPT test widths (``VQVAE_SMALL``:
hidden 16, one residual layer, 32 codes of width 8): the SAME padding
helpers equal, ``SamePadConv3d`` and ``SamePadConvTranspose3d`` against
flax at odd sizes and strides (1, 2, 2) and (2, 2, 2), the codebook's
indices exactly and its EMA update (``is_init`` set, every usage above the
threshold) to 1e-6 relative, the axial-attention block, and the VQ-VAE's
encode indices exactly and decode to 1e-4 relative, in eval mode and one
training-mode forward (batch statistics). Weights carried by
``video_vqvae_state_dict_from_jax``; one JAX init for the module. fp32.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_tpu.models.video_gpt.model import video_vqvae as jax_video_vqvae
from multimodal_tpu.modules.layers import codebook as jcb
from multimodal_tpu.modules.layers import conv as jconv
from multimodal_tpu.modules.losses.vqvae import commitment_loss as jax_commitment_loss
from multimodal_tpu.utils.common import shift_dim as jax_shift_dim
from multimodal_tpu_torch.models.video_gpt.model import video_vqvae
from multimodal_tpu_torch.modules.layers import codebook as tcb
from multimodal_tpu_torch.modules.layers import conv as tconv
from multimodal_tpu_torch.modules.losses.vqvae import commitment_loss
from multimodal_tpu_torch.utils.common import shift_dim
from multimodal_tpu_torch.utils.checkpoint import (
    conv3d_weight_from_jax,
    conv_transpose3d_weight_from_jax,
    video_vqvae_state_dict_from_jax,
)
from tests.test_torch_mugen import _close, _draw, jit

# the packages' __init__ rebinds ``video_vqvae`` to the builder function
jvv = importlib.import_module("multimodal_tpu.models.video_gpt.video_vqvae")
tvv = importlib.import_module("multimodal_tpu_torch.models.video_gpt.video_vqvae")

VQVAE_SMALL = dict(encoder_hidden_dim=16, n_res_layers=1, attn_hidden_dim=16,
                   num_embeddings=32, embedding_dim=8, decoder_hidden_dim=16)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("kernel,stride,shape", [
    (3, 1, (5, 7, 9)), (3, (1, 2, 2), (5, 7, 9)), (4, (2, 2, 2), (5, 8, 7)),
    ((1, 3, 2), (2, 1, 3), (6, 5, 4)), (2, 3, (7, 7, 7))])
def test_padding_helpers_match_jax(kernel, stride, shape):
    pads = jconv.calculate_same_padding(kernel, stride, shape)
    assert tconv.calculate_same_padding(kernel, stride, shape) == pads
    assert (tconv.calculate_transpose_padding(kernel, stride, shape, pads)
            == jconv.calculate_transpose_padding(kernel, stride, shape, pads))
    assert tconv.to_tuple_tuple(3, 3, 2) == jconv.to_tuple_tuple(3, 3, 2)
    assert tconv.to_tuple_tuple((1, 2, 2), 3, 2) == jconv.to_tuple_tuple((1, 2, 2), 3, 2)
    x = np.arange(120).reshape(2, 3, 4, 5)
    for src, dest in ((1, -1), (-1, 1), (0, 2), (3, 3)):
        np.testing.assert_array_equal(shift_dim(torch.from_numpy(x), src, dest).numpy(),
                                      np.asarray(jax_shift_dim(jnp.asarray(x), src, dest)))


@pytest.mark.parametrize("kernel,stride,shape", [
    (3, (1, 2, 2), (5, 7, 9)), (3, (2, 2, 2), (5, 7, 9)), (4, (2, 2, 2), (4, 6, 5)),
    (1, 1, (3, 4, 5)), (2, (1, 3, 3), (3, 5, 4))])
def test_same_pad_convs_match_flax(kernel, stride, shape):
    r = np.random.RandomState(0)
    x = r.randn(2, *shape, 5).astype(np.float32)
    conv = jconv.SamePadConv3d(6, kernel, stride)
    v = _np(conv.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    t = tconv.SamePadConv3d(5, 6, kernel, stride)
    t.conv.weight.data = torch.tensor(conv3d_weight_from_jax(v["params"]["conv"]["kernel"]))
    t.conv.bias.data = torch.tensor(v["params"]["conv"]["bias"])
    _close(t(torch.from_numpy(x)), conv.apply(v, jnp.asarray(x)))

    convt = jconv.SamePadConvTranspose3d(6, kernel, stride)
    v = _np(convt.init(jax.random.PRNGKey(1), jnp.asarray(x)))
    t = tconv.SamePadConvTranspose3d(5, 6, kernel, stride)
    t.convt.weight.data = torch.tensor(
        conv_transpose3d_weight_from_jax(v["params"]["convt"]["kernel"]))
    t.convt.bias.data = torch.tensor(v["params"]["convt"]["bias"])
    want = convt.apply(v, jnp.asarray(x))
    assert want.shape[1:-1] == tuple(d * s for d, s in zip(shape, tconv._to_tuple(stride, 3)))
    _close(t(torch.from_numpy(x)), want)


def _codebook_stats(r, n=32, d=8):
    emb = r.randn(n, d).astype(np.float32)
    return {"embedding": emb, "code_avg": emb * 3.0,
            "code_usage": (3.0 + r.rand(n)).astype(np.float32), "is_init": np.array(True)}


def test_codebook_indices_and_ema_update_match_jax():
    r = np.random.RandomState(2)
    stats = _codebook_stats(r)
    z = r.randn(3, 2, 4, 4, 8).astype(np.float32)
    z[0, 0, 0, 0] = stats["embedding"][5]  # an exact hit
    jm = jcb.Codebook(32, 8)
    variables = {"vq_stats": {k: jnp.asarray(v) for k, v in stats.items()}}
    want = jm.apply(variables, jnp.asarray(z))
    tm = tcb.Codebook(32, 8)
    tm.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in stats.items()})
    got = tm(torch.from_numpy(z))
    np.testing.assert_array_equal(got.codebook_indices.numpy(), np.asarray(want.codebook_indices))
    assert int(got.codebook_indices[0, 0, 0, 0]) == 5
    _close(got.quantized, want.quantized, rel=1e-6)

    # training: the EMA update, the output looked up before it
    want, new = jm.apply(variables, jnp.asarray(z), deterministic=False,
                         rngs={"vq": jax.random.PRNGKey(3)}, mutable=["vq_stats"])
    got = tm(torch.from_numpy(z), deterministic=False,
             generator=torch.Generator().manual_seed(3))
    np.testing.assert_array_equal(got.codebook_indices.numpy(), np.asarray(want.codebook_indices))
    _close(got.quantized, want.quantized, rel=1e-6)
    for k in ("embedding", "code_usage", "code_avg"):
        w = np.asarray(new["vq_stats"][k])
        np.testing.assert_allclose(getattr(tm, k).numpy(), w, rtol=1e-6,
                                   atol=1e-6 * float(np.abs(w).max()), err_msg=k)
    assert bool(tm.is_init)


def test_codebook_lazy_init_and_dead_code_reset():
    """Not comparable with JAX (its draws): the first training call fills
    the codebook with encoder rows, and codes below the usage threshold
    are redrawn from them."""
    tm = tcb.Codebook(16, 4)
    z = torch.randn(2, 3, 4)
    tm(z, deterministic=False, generator=torch.Generator().manual_seed(0))
    assert bool(tm.is_init)
    rows = z.reshape(-1, 4)
    # with 6 rows for 16 codes the rows are tiled with noise of std 0.005
    dist = torch.cdist(tm.code_avg, rows).min(dim=1).values
    assert float(dist.max()) < 0.05
    assert torch.isfinite(tm.embedding).all()


def test_axial_attention_block_matches_jax():
    r = np.random.RandomState(4)
    x = r.randn(2, 3, 4, 5, 16).astype(np.float32)
    jm = jvv.AxialAttentionBlock(3, 16, 2)
    v = _np(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    tm = tvv.AxialAttentionBlock(3, 16, 2)
    tm.load_state_dict(video_vqvae_state_dict_from_jax(v), strict=True)
    _close(tm(torch.from_numpy(x)), jm.apply(v, jnp.asarray(x)))


def test_generic_video_vqvae_builder_matches_jax():
    """``video_vqvae``'s generic builder (one kernel size and stride for
    every layer): the parameter tree maps onto the port's module exactly,
    and the codes of a clip are equal."""
    args = (3, 16, 3, 2, 2, 1, 16, 32, 8, 16, 3, 2, 2)
    jm = jvv.video_vqvae(*args)
    video = np.random.RandomState(8).rand(1, 4, 8, 8, 3).astype(np.float32)
    variables = _np(_draw(jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(video)),
                          8))
    variables["vq_stats"]["codebook"] = _codebook_stats(np.random.RandomState(9))
    tm = tvv.video_vqvae(*args).eval()
    tm.load_state_dict(video_vqvae_state_dict_from_jax(variables), strict=True)
    assert tm.latent_shape((4, 8, 8)) == jm.encoder.get_latent_shape((4, 8, 8)) == (1, 2, 2)
    want = jit(lambda v, x: jm.apply(v, x, method=type(jm).encode))(variables,
                                                                    jnp.asarray(video))
    with torch.no_grad():
        np.testing.assert_array_equal(tm.encode(torch.from_numpy(video)).numpy(),
                                      np.asarray(want))


@pytest.fixture(scope="module")
def vqvae_setup():
    jm = jax_video_vqvae(**VQVAE_SMALL)
    video = np.random.RandomState(5).rand(2, 4, 8, 8, 3).astype(np.float32)
    variables = _np(jit(lambda x: jm.init({"params": jax.random.PRNGKey(0),
                                           "vq": jax.random.PRNGKey(1)}, x))(jnp.asarray(video)))
    r = np.random.RandomState(6)
    variables["batch_stats"] = jax.tree.map(  # statistics away from 0 / 1
        lambda a: (r.rand(*a.shape) + 0.5).astype(np.float32), variables["batch_stats"])
    variables["vq_stats"]["codebook"] = _codebook_stats(r)
    tm = video_vqvae(device="cpu", **VQVAE_SMALL)
    tm.load_state_dict(video_vqvae_state_dict_from_jax(variables), strict=True)
    return jm, variables, tm, video


def test_vqvae_encode_decode_match_jax(vqvae_setup):
    jm, variables, tm, video = vqvae_setup
    encode = jit(lambda v, x: jm.apply(v, x, return_embeddings=True, method=type(jm).encode))
    want_ids, want_q = encode(variables, jnp.asarray(video))
    with torch.no_grad():
        ids, quantized = tm.encode(torch.from_numpy(video), return_embeddings=True)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want_ids))
    assert ids.shape == (2, 2, 4, 4) and tm.latent_shape((4, 8, 8)) == (2, 4, 4)
    _close(quantized, want_q)
    decode = jit(lambda v, i: jm.apply(v, i, method=type(jm).decode))
    with torch.no_grad():
        _close(tm.decode(ids), decode(variables, want_ids))


def test_vqvae_training_forward_matches_jax(vqvae_setup):
    """One training-mode forward: batch statistics in every BatchNorm, the
    running statistics' update, the codebook's EMA, and the commitment
    loss's value and gradient in the encoder output."""
    jm, variables, tm, video = vqvae_setup
    tm = video_vqvae(device="cpu", **VQVAE_SMALL)
    tm.load_state_dict(video_vqvae_state_dict_from_jax(variables), strict=True)
    want, new = jm.apply(variables, jnp.asarray(video), deterministic=False,
                         rngs={"vq": jax.random.PRNGKey(7)}, mutable=["batch_stats", "vq_stats"])
    got = tm(torch.from_numpy(video), deterministic=False,
             generator=torch.Generator().manual_seed(7))
    np.testing.assert_array_equal(got.codebook_output.codebook_indices.numpy(),
                                  np.asarray(want.codebook_output.codebook_indices))
    _close(got.decoded, want.decoded)
    sd = tm.state_dict()
    for name, value in video_vqvae_state_dict_from_jax(
            {"params": variables["params"], **_np(new)}).items():
        if "running" in name or "codebook" in name:
            _close(sd[name].float(), np.asarray(value, np.float32), rel=1e-5)

    enc = got.codebook_output.encoded_flat
    enc.retain_grad()
    loss = commitment_loss(got.codebook_output.quantized_flat, enc)
    loss.backward()
    want_loss, want_grad = jax.value_and_grad(lambda e: jax_commitment_loss(
        want.codebook_output.quantized_flat, e))(want.codebook_output.encoded_flat)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    _close(enc.grad, want_grad)

"""The port's MUGEN video modules (multimodal_tpu_torch/transforms/
video_transform.py, examples/mugen/video_clip.py) held against the JAX
package at small size: the video transform's antialiased linear resize
(down and up, time and space), the SAME max-pools at odd and even sizes,
S3D in eval mode and for one training-mode step (the output and every
running statistic), an inception block's output, statistics and gradients
through batch statistics, and the projection head, the weights carried by
``videoclip_state_dict_from_jax``. JAX weights are drawn with numpy onto
``jax.eval_shape``'s tree (no JAX init compiles). fp32 throughout; outputs,
statistics and gradients to 1e-4 of each tensor's largest element.
``test_torch_mugen_retrieval.py`` holds the recipe.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from multimodal_tpu.examples.mugen import video_clip as jvc
from multimodal_tpu.transforms.video_transform import VideoTransform as JVideoTransform
from multimodal_tpu_torch.examples.mugen import video_clip as tvc
from multimodal_tpu_torch.transforms.video_transform import VideoTransform
from multimodal_tpu_torch.utils.checkpoint import videoclip_state_dict_from_jax

REL = 1e-4
# jit for the JAX side: LLVM at -O0 compiles S3D's programs about a fifth
# faster; the HLO, so the arithmetic, is the same
jit = functools.partial(jax.jit, compiler_options={"xla_backend_optimization_level": 0})


def _close(got, want, rel=REL):
    want = np.asarray(want, np.float32)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, want, atol=rel * max(1.0, float(np.abs(want).max())),
                               rtol=0)


def _draw(shapes, seed):
    """numpy weights on a JAX tree of ``eval_shape`` structs: fan-in scaled
    kernels, BatchNorm and LayerNorm scales near 1, positive variances,
    small biases, means and embeddings."""
    r = np.random.RandomState(seed)

    def draw(path, s):
        name = getattr(path[-1], "key", "")
        x = r.standard_normal(s.shape).astype(np.float32)
        if name == "kernel":
            x /= np.sqrt(np.prod(s.shape[:-1]))
        elif name == "scale":
            x = 1.0 + 0.1 * x
        elif name == "var":
            x = 1.0 + 0.5 * np.abs(x)
        elif name == "logit_scale":
            x = np.float32(0.07) + 0.01 * x
        else:
            x *= 0.05
        return jnp.asarray(x)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("shape,time_samples,size", [
    ((2, 40, 48, 40, 3), 32, (32, 24)),   # downscale on every axis
    ((1, 6, 10, 12, 3), 9, (16, 20)),     # upscale on every axis
])
def test_video_transform_matches_jax(shape, time_samples, size):
    v = np.random.RandomState(0).randint(0, 256, shape).astype(np.uint8)
    want = jit(JVideoTransform(time_samples, size))(jnp.asarray(v))
    got = VideoTransform(time_samples, size)(torch.from_numpy(v))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    _close(got, want)


@pytest.mark.parametrize("size", [(7, 12, 13), (8, 9, 10)])
@pytest.mark.parametrize("window,strides", [((1, 3, 3), (1, 2, 2)), ((3, 3, 3), (2, 2, 2)),
                                            ((2, 2, 2), (2, 2, 2)), ((3, 3, 3), (1, 1, 1))])
def test_same_max_pool_matches_flax(size, window, strides):
    x = np.random.RandomState(1).standard_normal((2, *size, 3)).astype(np.float32)
    want = nn.max_pool(jnp.asarray(x), window, strides=strides, padding="SAME")
    got = tvc.same_max_pool3d(torch.from_numpy(x).permute(0, 4, 1, 2, 3), window, strides)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 4, 1).numpy(), np.asarray(want))


@pytest.fixture(scope="module")
def s3d_setup():
    x = np.random.RandomState(2).standard_normal((1, 8, 32, 32, 3)).astype(np.float32)
    jm = jvc.S3D()
    variables = _draw(jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(x)), 3)
    return jm, variables, x


def _port_s3d(variables):
    m = tvc.S3D()
    sd = videoclip_state_dict_from_jax(_np(variables))
    m.load_state_dict(sd, strict=True)
    return m


def test_s3d_eval_matches_jax(s3d_setup):
    jm, variables, x = s3d_setup
    want = jit(jm.apply)(variables, jnp.asarray(x))
    with torch.no_grad():
        got = _port_s3d(variables)(torch.from_numpy(x))
    assert tuple(got.shape) == (1, 1024)
    _close(got, want)


def test_s3d_training_step_matches_jax(s3d_setup):
    """Batch statistics in the output; the running statistics after the
    step equal flax's (momentum 0.9, the biased batch variance)."""
    jm, variables, x = s3d_setup
    apply = jit(functools.partial(jm.apply, deterministic=False, mutable=["batch_stats"]))
    want, updated = apply(variables, jnp.asarray(x))
    m = _port_s3d(variables)
    with torch.no_grad():
        got = m(torch.from_numpy(x), deterministic=False)
    _close(got, want)
    stats = videoclip_state_dict_from_jax({"params": {}, "batch_stats": _np(
        updated["batch_stats"])})
    buffers = dict(m.named_buffers())
    assert set(stats) == set(buffers)
    for name, value in stats.items():
        _close(buffers[name], value)
        # and the statistics moved
        assert not torch.equal(buffers[name], videoclip_state_dict_from_jax(
            {"params": {}, "batch_stats": _np(variables["batch_stats"])})[name])


def test_projection_matches_jax():
    x = np.random.RandomState(4).standard_normal((3, 40)).astype(np.float32)
    jm = jvc.Projection(16)
    params = _draw(jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(x)), 5)
    m = tvc.Projection(40, 16)
    m.load_state_dict(videoclip_state_dict_from_jax(_np(params)), strict=True)
    with torch.no_grad():
        _close(m(torch.from_numpy(x)), jit(jm.apply)(params, jnp.asarray(x)))


def test_batch_statistics_gradients_match_jax():
    """An inception block in training mode: output, running statistics and
    every gradient (through the batch mean and flax's E[x^2] - E[x]^2)."""
    x = np.random.RandomState(9).standard_normal((2, 4, 6, 6, 16)).astype(np.float32)
    g = np.random.RandomState(10).standard_normal((2, 4, 6, 6, 40)).astype(np.float32)
    jm = jvc.InceptionBlock3d(8, 8, 12, 4, 8, 12)
    variables = _draw(jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(x)), 11)

    def loss_fn(p, x):
        y, upd = jm.apply({**variables, "params": p}, x, deterministic=False,
                          mutable=["batch_stats"])
        return jnp.sum(y * g), (y, upd)

    (_, (want, updated)), (gp, gx) = jit(jax.value_and_grad(
        loss_fn, argnums=(0, 1), has_aux=True))(variables["params"], jnp.asarray(x))
    m = tvc.InceptionBlock3d(16, 8, 8, 12, 4, 8, 12)
    m.load_state_dict(videoclip_state_dict_from_jax(_np(variables)), strict=True)
    xt = torch.from_numpy(x).permute(0, 4, 1, 2, 3).requires_grad_()
    y = m(xt, deterministic=False)
    (y * torch.from_numpy(g).permute(0, 4, 1, 2, 3)).sum().backward()
    _close(y.permute(0, 2, 3, 4, 1), want)
    _close(xt.grad.permute(0, 2, 3, 4, 1), gx)
    params, buffers = dict(m.named_parameters()), dict(m.named_buffers())
    for name, value in videoclip_state_dict_from_jax({"params": _np(gp)}).items():
        _close(params[name].grad, value)
    for name, value in videoclip_state_dict_from_jax(
            {"params": {}, "batch_stats": _np(updated["batch_stats"])}).items():
        _close(buffers[name], value)

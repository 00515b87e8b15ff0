"""The port's MUGEN retrieval recipe (multimodal_tpu_torch/examples/mugen/
{retrieval_train,data}.py) held against the JAX package at small size: the
contrastive loss and every gradient against ``jax.grad`` with the weights
carried by ``videoclip_state_dict_from_jax`` (``test_torch_mugen_data.py``
holds the data module and the recall eval).

S3D runs on its running statistics in the gradient check: with batch
statistics a randomly initialised S3D is chaotic (the two packages'
convolutions differ by about 1e-6 in fp32 and the batch-normalized stack
doubles that about every layer, to 1e-2 at mixed5c), so the training-mode
arithmetic is held block by block in ``test_torch_mugen.py``. The text
tower is DistilBERT-config in both packages (6 x 768); here both packages'
``bert_text_encoder`` is patched to 2 layers of width 64 so that
``jax.grad`` compiles in seconds. fp32 throughout; the loss to 1e-5, the
gradients to 1e-4 of each tensor's largest element.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_tpu.examples.mugen import retrieval_train as jrt
from multimodal_tpu.examples.mugen import video_clip as jvc
from multimodal_tpu_torch.examples.mugen import retrieval_train as trt
from multimodal_tpu_torch.examples.mugen import video_clip as tvc
from multimodal_tpu_torch.utils.checkpoint import videoclip_state_dict_from_jax
from tests.test_torch_mugen import _close, _draw, _np, jit

SMALL_TEXT = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=2,
                  intermediate_size=128)


@pytest.fixture(scope="module")
def small_text():
    """Both packages' MUGEN text tower at 2 layers of width 64."""
    mp = pytest.MonkeyPatch()
    for mod in (jvc, tvc):
        build = mod.bert_text_encoder
        mp.setattr(mod, "bert_text_encoder",
                   lambda build=build, **kw: build(**{**kw, **SMALL_TEXT}))
    yield
    mp.undo()


def _batch(b=2, seed=6):
    r = np.random.RandomState(seed)
    video = r.standard_normal((b, 8, 32, 32, 3)).astype(np.float32)
    text = r.randint(1, 500, (b, 8)).astype(np.int32)
    text[1, 5:] = 0
    return video, text


@pytest.fixture(scope="module")
def retrieval_setup(small_text):
    video, text = _batch()
    jm = jrt.VideoCLIPForRetrieval(vocab_size=500)
    variables = _draw(jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(video),
                                     jnp.asarray(text)), 7)
    cfg = {"model": {**jrt.DEFAULTS["model"], "vocab_size": 500}}
    tm = trt.build_model(cfg, device="cpu")
    tm.load_state_dict(videoclip_state_dict_from_jax(_np(variables)), strict=True)
    return jm, variables, tm, (video, text)


def test_retrieval_gradients_match_jax(retrieval_setup):
    """The contrastive loss and every parameter's gradient against
    ``jax.grad``, S3D on its running statistics."""
    jm, variables, tm, (video, text) = retrieval_setup

    def loss_fn(p):
        return jm.apply({**variables, "params": p}, jnp.asarray(video), jnp.asarray(text))

    want_loss, grads = jit(jax.value_and_grad(loss_fn))(variables["params"])
    tm.zero_grad()
    loss = tm(torch.from_numpy(video), torch.from_numpy(text).long())
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    want_grads = videoclip_state_dict_from_jax({"params": _np(grads)})
    got = dict(tm.named_parameters())
    assert set(want_grads) == set(got)
    for name, g in want_grads.items():
        _close(got[name].grad, g)

"""The port's MDETR VQA fine-tuning recipe (multimodal_tpu_torch/examples/mdetr/
vqa_finetune.py, training/ema.py) held against the JAX package at the JAX
VQA test's widths (``TINY``: d_model 32, 2 + 2 layers, a 2-layer text
encoder, ResNet layers (1, 1, 1, 1), 32 x 32 images, the six GQA heads): the
loss's total and every term (fp32, 1e-5 relative), two ``finetune_vqa``
steps at batch 2 with EMA (the EMA to 1e-5 of each tensor's largest
element, the parameters to 1e-5 but where Adam's normalisation meets
rounding noise: the key-projection biases, whose gradient is zero in exact
arithmetic, and at most one element in a million, each within the two
steps' bound 2 x 2 x lr; EMA in chunks, as JAX applies it), and
``evaluate_vqa``'s weighted accuracies (equal). JAX weights drawn with numpy
onto ``jax.eval_shape``'s tree; carried by ``mdetr_state_dict_from_jax``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_tpu.examples.mdetr import vqa_finetune as jvqa
from multimodal_tpu.models.mdetr import model as jmodel
from multimodal_tpu.parallel.mesh import create_mesh
from multimodal_tpu.training.ema import update_ema as jax_update_ema
from multimodal_tpu_torch.data.device_prefetch import to_device
from multimodal_tpu_torch.examples.mdetr import vqa_finetune as tvqa
from multimodal_tpu_torch.models.mdetr import model as tmodel
from multimodal_tpu_torch.training.ema import init_ema, update_ema
from multimodal_tpu_torch.utils.checkpoint import mdetr_state_dict_from_jax
from tests.test_torch_mugen import _close, _draw, _np, jit

TINY = dict(num_queries=6, num_classes=10, embedding_dim=32, transformer_d_model=32,
            transformer_num_heads=2, transformer_encoder_layers=2,
            transformer_decoder_layers=2, transformer_dim_feedforward=64,
            transformer_dropout=0.0,
            text_encoder_kwargs=dict(num_hidden_layers=2, num_attention_heads=2,
                                     intermediate_size=64, vocab_size=100,
                                     max_position_embeddings=32),
            resnet_layers=(1, 1, 1, 1))
HEADS = {"answer_type": 5, "answer_obj": 3, "answer_rel": 1594, "answer_attr": 403,
         "answer_cat": 678, "answer_global": 111}


def _batch(r, b=8, max_boxes=3, num_classes=10, text_len=8):
    """The JAX VQA test's GQA-format batch."""
    images, image_mask = jmodel.pad_images([r.rand(32, 32, 3).astype(np.float32)
                                            for _ in range(b)])
    text, text_mask = jmodel.pad_text([r.randint(2, 99, text_len) for _ in range(b)])
    positive_map = np.zeros((b, max_boxes, num_classes + 1), np.float32)
    positive_map[..., 0] = 1.0
    answer_type = r.randint(0, 5, (b,))
    return {
        "images": images, "image_mask": image_mask, "text": text,
        "text_attention_mask": text_mask, "positive_map": positive_map,
        "target_boxes": np.tile(np.asarray([0.5, 0.5, 0.2, 0.2], np.float32),
                                (b, max_boxes, 1)),
        "valid": np.asarray([[True] + [False] * (max_boxes - 1)] * b),
        "answers": {k: r.randint(0, n, (b,)) for k, n in HEADS.items()},
        "answer_type_mask": {
            "answer_type": np.ones((b,), bool), "answer_obj": answer_type == 0,
            "answer_attr": answer_type == 1, "answer_rel": answer_type == 2,
            "answer_cat": answer_type == 3, "answer_global": answer_type == 4},
    }


def _batches(seed, b=8):
    r = np.random.RandomState(seed)
    while True:
        yield _batch(r, b)


@pytest.fixture(scope="module")
def vqa_setup():
    batch = _batch(np.random.RandomState(0), b=2)
    jm = jmodel.mdetr_for_vqa(num_extra_query_embeddings=6, **TINY)
    args = tuple(jnp.asarray(batch[k]) for k in ("images", "image_mask", "text",
                                                  "text_attention_mask"))
    params = _draw(jax.eval_shape(jm.init, jax.random.PRNGKey(0), *args), 2)
    params = _np(jax.tree_util.tree_map_with_path(  # frozen statistics: positive variances
        lambda p, x: jnp.abs(x) + 0.5 if getattr(p[-1], "key", "") == "running_var" else x,
        params))

    def port():
        tm = tmodel.mdetr_for_vqa(num_extra_query_embeddings=6, device="cpu", **TINY)
        tm.load_state_dict(mdetr_state_dict_from_jax(params), strict=True)
        return tm

    return jm, params, port


def test_vqa_loss_terms_match_jax(vqa_setup):
    jm, params, port = vqa_setup
    batch = _batch(np.random.RandomState(1), b=2)
    want_total, want_aux = jit(jvqa.vqa_loss_fn(jm))(params, batch, jax.random.PRNGKey(0))
    total, aux = tvqa.vqa_loss_fn()(port(), to_device(batch, torch.device("cpu")))
    np.testing.assert_allclose(total.item(), float(want_total), rtol=1e-5)
    assert set(aux) == set(want_aux)
    for k, v in want_aux.items():
        np.testing.assert_allclose(float(aux[k].detach()), float(v), rtol=1e-5, atol=1e-7,
                                   err_msg=k)


def test_finetune_two_steps_and_ema_match_jax(vqa_setup):
    jm, params, port = vqa_setup
    # the JAX trainer on a one-device mesh: the test's batch of 2 needs no
    # split, and the step compiles without the SPMD partitioner
    one = {"strategy": "ddp", "mesh": create_mesh(devices=jax.devices()[:1])}
    state, ema = jvqa.finetune_vqa(jm, params, _batches(2, 2), num_steps=2, steps_per_epoch=2,
                                   epochs=1, lr_drop=1, trainer_kwargs=one)
    tm, tema = tvqa.finetune_vqa(port(), _batches(2, 2), num_steps=2, steps_per_epoch=2,
                                 epochs=1, lr_drop=1)
    assert int(state["step"]) == 2
    got, got_ema = tm.state_dict(), tema.state_dict()
    names = {n for n, _ in tm.named_parameters()}
    want = mdetr_state_dict_from_jax(_np(state["params"]))
    want_ema = mdetr_state_dict_from_jax(_np(ema))
    moved = beyond = total = 0
    adam_bound = 2 * 2 * 5e-5  # two steps of at most lr each, a sign apart
    for name in names:
        _close(got_ema[name], want_ema[name], rel=1e-5)
        moved += int(not torch.equal(got[name], got_ema[name]))
        diff = (got[name] - want[name]).abs()
        assert float(diff.max()) <= adam_bound, name
        if name.endswith("k_proj.bias"):
            # the gradient of a key bias is zero in exact arithmetic (the
            # softmax ignores a shift shared by a row's scores), so each
            # side's Adam step is +-lr from its own rounding noise
            continue
        beyond += int((diff > 1e-5).sum())
        total += diff.numel()
    # every other element within 1e-5 but for at most one in a million:
    # where a step's gradient element sits at the rounding level, Adam's
    # normalisation turns the noise into a step of up to lr
    assert beyond <= total // 1_000_000, (beyond, total)
    assert moved > len(names) // 2  # the EMA trails the parameters

    # the EMA's chunk rule: after a chunk of n steps, n updates toward the
    # chunk's final parameters
    start = port()
    e = init_ema(start)
    for _ in range(2):
        update_ema(e, tm, 0.9998)
    j = jax.tree_util.tree_map(jnp.asarray, params)
    for _ in range(2):
        j = jax_update_ema(j, state["params"], 0.9998)
    _close(e.state_dict()["model.query_embed"], mdetr_state_dict_from_jax(_np(j))[
        "model.query_embed"], rel=1e-6)


def test_evaluate_vqa_matches_jax(vqa_setup):
    jm, params, port = vqa_setup
    gen = _batches(3)
    batches = [next(gen), next(gen)]
    want = jvqa.evaluate_vqa(jm, params, batches)
    got = tvqa.evaluate_vqa(port(), batches)
    assert set(got) == set(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=1e-6), k
    assert 0.0 <= got["answer_total_accuracy"] <= 1.0

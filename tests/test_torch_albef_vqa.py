"""The port's ALBEF task models held against the JAX package at small
widths (``tests/test_torch_albef.py``'s models and helpers): the VQA model's
loss and every gradient against ``jax.grad``, ``vqa_answer_loss`` (the VQA
step's weighted multi-answer loss) against a composition of the JAX module's
parts, ``retrieval_rerank``, both schedules over a grid of (epoch, batch),
and ``albef_state_dict_from_jax`` round trips of the three ALBEF models.
fp32; tolerances as in ``tests/test_torch_albef.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_tpu.examples.albef import model as jex
from multimodal_tpu.examples.albef import recipes as jrec
from multimodal_tpu.modules.losses import albef as jloss
from multimodal_tpu_torch.examples.albef import model as tex
from multimodal_tpu_torch.examples.albef import recipes as trec
from multimodal_tpu_torch.utils.checkpoint import albef_state_dict_from_jax
from tests.test_torch_albef import (B, FF, H, HEADS, LAYERS, VOCAB, _batch, _close,
                                    _close_tree, _jax_albef, _np, _perturb, _port_albef,
                                    _port_sim, _retrieval_variables, _t, sim_setup)  # noqa: F401

def _jax_vqa():
    dec = jex.ALBEFDecoder(vocab_size=VOCAB, hidden_size=H, num_hidden_layers=LAYERS,
                           num_attention_heads=HEADS, intermediate_size=FF,
                           max_position_embeddings=16)
    return jex.ALBEFModelForVQA(model=_jax_albef(), decoder=dec)


def _port_vqa():
    dec = tex.ALBEFDecoder(vocab_size=VOCAB, hidden_size=H, num_hidden_layers=LAYERS,
                           num_attention_heads=HEADS, intermediate_size=FF,
                           max_position_embeddings=16)
    return tex.ALBEFModelForVQA(_port_albef(), dec)


@pytest.fixture(scope="module")
def vqa_setup():
    image, question, q_atts, _ = _batch(seed=30)
    r = np.random.RandomState(31)
    n_ans, length = 3, 5
    a_atts = np.zeros((B, n_ans, length), np.int32)
    for i in range(B):
        for j in range(r.randint(1, n_ans + 1)):
            a_atts[i, j, : r.randint(2, length + 1)] = 1
    answers = (r.randint(1, VOCAB, (B, n_ans, length)) * a_atts).astype(np.int32)
    weights = (r.rand(B, n_ans) * a_atts.max(-1)).astype(np.float32)
    jm = _jax_vqa()
    v = jax.jit(jm.init)(jax.random.PRNGKey(12), jnp.asarray(image), jnp.asarray(question),
                         jnp.asarray(q_atts), jnp.asarray(answers[:, 0]),
                         jnp.asarray(a_atts[:, 0]))
    v = _perturb(v, 13, 0.02)
    model = _port_vqa()
    model.load_state_dict(albef_state_dict_from_jax(_np(v["params"])), strict=True)
    return jm, v, model, (image, question, q_atts, answers, a_atts, weights)


def test_vqa_model_loss_and_gradients_match_jax(vqa_setup):
    jm, v, model, (image, question, q_atts, answers, a_atts, _) = vqa_setup
    args = [jnp.asarray(a) for a in (image, question, q_atts, answers[:, 0], a_atts[:, 0])]
    want = jax.jit(jm.apply)(v, *args)
    grads = jax.jit(jax.grad(lambda p: jnp.sum(jm.apply(p, *args))))(v)
    model.zero_grad()
    got = model(_t(image), _t(question).long(), _t(q_atts), _t(answers[:, 0]).long(),
                _t(a_atts[:, 0]))
    got.sum().backward()
    assert got.shape == (B,)
    _close(got, want, 1e-5)
    _close_tree({k: p.grad for k, p in model.named_parameters()}, grads)


@pytest.mark.parametrize("counted", [False, True])
def test_vqa_answer_loss_matches_a_jax_composition(vqa_setup, counted):
    """The VQA step's loss: the question fused once, repeated for its
    answers, decoded, CLM-weighted and summed over the batch / its size.
    The JAX side decodes every row; the port decodes every row, or with
    ``counted`` only each question's real answers (the padding rows weigh
    0), and the two agree."""
    jm, v, model, (image, question, q_atts, answers, a_atts, weights) = vqa_setup
    n_ans, length = answers.shape[1:]

    def jfn(p):
        fused = jm.apply(p, jnp.asarray(image), jnp.asarray(question), jnp.asarray(q_atts),
                         method=jex.ALBEFModelForVQA.encode_question)
        fused = jnp.repeat(fused, n_ans, axis=0)
        rows = jnp.asarray(answers.reshape(-1, length))
        atts = jnp.asarray(a_atts.reshape(-1, length))
        scores = jm.apply(p, rows, atts, fused, method=lambda m, a, t, f: m.decoder(a, t, f))
        loss = jloss.causal_language_modeling_loss(jnp.where(atts.astype(bool), rows, -100),
                                                   scores)
        return jnp.sum(jnp.asarray(weights.reshape(-1)) * loss) / B

    want, grads = jax.jit(jax.value_and_grad(jfn))(v)
    model.zero_grad()
    counts = a_atts.max(-1).sum(-1) if counted else None
    if counted:
        assert counts.min() >= 1 and counts.max() <= n_ans and counts.sum() < B * n_ans
    got = tex.vqa_answer_loss(model, _t(image), _t(question).long(), _t(q_atts),
                              _t(answers).long(), _t(a_atts), _t(weights), counts)
    got.backward()
    _close(got, want, 1e-5)
    _close_tree({k: p.grad for k, p in model.named_parameters()}, grads)


def test_retrieval_rerank_matches_jax():
    r = np.random.RandomState(14)
    sim = r.randn(5, 9).astype(np.float32)
    itm = r.randn(5, 9).astype(np.float32)

    def jfn(i, cand):
        return jnp.asarray(itm)[i, cand]

    want = jex.retrieval_rerank(jnp.asarray(sim), jfn, k_test=4)
    got = tex.retrieval_rerank(_t(sim), lambda i, cand: _t(itm)[i, cand], k_test=4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (torch.isfinite(got).sum(1) == 4).all()


def test_schedules_match_jax_over_a_grid():
    for epoch in range(8):
        for batch in (0, 1, 50, 99, 100, 101, 250, 1000):
            np.testing.assert_allclose(
                trec.albef_alpha_schedule(epoch, batch, 300),
                float(jrec.albef_alpha_schedule(epoch, batch, 300)), rtol=1e-6)
            for kw in ({}, {"warmup_steps": 2, "step_size": 40, "max_epochs": 5}):
                np.testing.assert_allclose(trec.albef_cosine_lr(epoch, batch, **kw),
                                           float(jrec.albef_cosine_lr(epoch, batch, **kw)),
                                           rtol=1e-6)


def _jax_key(path) -> str:
    import re

    parts = [re.sub(r"^layer_(\d+)$", r"layers.\1", p.key) for p in path[:-1]
             if p.key != "LayerNorm_0"]
    last = path[-1].key
    return ".".join(parts + ["weight" if last in ("kernel", "scale", "embedding") else last])


@pytest.mark.parametrize("kind", ["similarity", "retrieval", "vqa"])
def test_state_dict_round_trips(kind, sim_setup, vqa_setup):
    """JAX tree -> the port's module (strict) -> its state_dict -> back to
    each JAX leaf, exactly (kernels transposed back, the conv OIHW -> HWIO)."""
    if kind == "vqa":
        tree, model = vqa_setup[1], _port_vqa()
    elif kind == "retrieval":
        tree, model = _retrieval_variables(sim_setup[1]), tex.ALBEFModelForRetrieval(
            _port_sim(), hidden_size=H)
    else:
        tree, model = sim_setup[1], _port_sim()
    model.load_state_dict(albef_state_dict_from_jax(_np(tree["params"])), strict=True)
    back = model.state_dict()
    leaves = jax.tree_util.tree_flatten_with_path(_np(tree)["params"])[0]
    assert len(leaves) == len(back)
    for path, leaf in leaves:
        got = back[_jax_key(path)].numpy()
        if path[-1].key == "kernel":
            got = got.transpose(2, 3, 1, 0) if got.ndim == 4 else got.T
        np.testing.assert_array_equal(got, leaf)



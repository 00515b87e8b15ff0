"""The port's ALBEF held against the JAX package at small widths: the
vision and multimodal encoders, ``albef_forward_with_momentum``,
``albef_with_similarity_forward`` (similarities, targets, the enqueue and
the ring's wrap on later steps, the hard negatives with JAX's indices), the
ITC and CLM losses, ``albef_retrieval_train_step`` (the loss, every
gradient against ``jax.grad`` and the new momentum tree), the VQA model's
loss and gradients and ``vqa_answer_loss``, ``retrieval_rerank``, the
schedules, ``albef_state_dict_from_jax`` round trips, and the hard-negative
draw's own properties.

Weights are the JAX modules' own, carried by path
(``utils/checkpoint.py:albef_state_dict_from_jax``); inputs come from a
numpy seed. The port draws its hard negatives with ``torch.multinomial``,
JAX with ``jax.random.categorical``: the comparisons replace the port's draw
(``models/albef/model.py:hard_negative_indices``) with JAX's indices. fp32
throughout; ATOL on outputs of unit scale, gradients to 2e-5 of each
tensor's largest element (readings up to about 1e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from multimodal_tpu.examples.albef import model as jex
from multimodal_tpu.examples.albef import recipes as jrec
from multimodal_tpu.models.albef import model as jalbef
from multimodal_tpu.models.albef.image_encoder import ALBEFVisionEncoder as JVision
from multimodal_tpu.models.albef.multimodal_encoder import ALBEFMultimodalEncoder as JMulti
from multimodal_tpu.modules.encoders.bert_text_encoder import bert_text_encoder as j_bert
from multimodal_tpu.modules.losses import albef as jloss
from multimodal_tpu_torch.examples.albef import model as tex
from multimodal_tpu_torch.examples.albef import recipes as trec
from multimodal_tpu_torch.models.albef import model as talbef
from multimodal_tpu_torch.models.albef.image_encoder import ALBEFVisionEncoder
from multimodal_tpu_torch.models.albef.multimodal_encoder import ALBEFMultimodalEncoder
from multimodal_tpu_torch.modules.encoders.bert_text_encoder import bert_text_encoder
from multimodal_tpu_torch.modules.losses import albef as tloss
from multimodal_tpu_torch.utils.checkpoint import albef_state_dict_from_jax
from multimodal_tpu_torch.utils.common import momentum_copy

H, FF, HEADS, LAYERS, VOCAB, EMB, QUEUE, B, S = 32, 64, 2, 2, 60, 8, 8, 4, 6
IMAGE, PATCH = 16, 8
ATOL = 2e-5
GRAD_REL = 2e-5


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_albef(momentum=0.9):
    return jalbef.ALBEFModel(
        JVision(image_size=IMAGE, patch_size=PATCH, num_hidden_layers=LAYERS,
                num_attention_heads=HEADS, hidden_size=H, mlp_dim=FF),
        j_bert(hidden_size=H, num_hidden_layers=LAYERS, num_attention_heads=HEADS,
               intermediate_size=FF, dropout=0.0, vocab_size=VOCAB, max_position_embeddings=16),
        JMulti(hidden_size=H, num_hidden_layers=LAYERS, num_attention_heads=HEADS,
               intermediate_size=FF),
        momentum=momentum)


def _port_albef(momentum=0.9):
    return talbef.ALBEFModel(
        ALBEFVisionEncoder(image_size=IMAGE, patch_size=PATCH, num_hidden_layers=LAYERS,
                           num_attention_heads=HEADS, hidden_size=H, mlp_dim=FF),
        bert_text_encoder(hidden_size=H, num_hidden_layers=LAYERS, num_attention_heads=HEADS,
                          intermediate_size=FF, dropout=0.0, vocab_size=VOCAB,
                          max_position_embeddings=16),
        ALBEFMultimodalEncoder(hidden_size=H, num_hidden_layers=LAYERS,
                               num_attention_heads=HEADS, intermediate_size=FF),
        momentum=momentum)


def _jax_sim():
    return jalbef.ALBEFModelWithSimilarity(albef_model=_jax_albef(), vision_proj=nn.Dense(EMB),
                                           text_proj=nn.Dense(EMB), embed_size=EMB,
                                           queue_size=QUEUE)


def _port_sim():
    return talbef.ALBEFModelWithSimilarity(_port_albef(), torch.nn.Linear(H, EMB),
                                           torch.nn.Linear(H, EMB), embed_size=EMB,
                                           queue_size=QUEUE)


def _perturb(tree, seed, scale=0.05):
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    keys = jax.random.split(jax.random.PRNGKey(seed), len(leaves))
    return jax.tree_util.tree_unflatten(
        treedef, [a + scale * jax.random.normal(k, a.shape, a.dtype) for a, k in zip(leaves, keys)])


def _batch(seed=0, b=B):
    r = np.random.RandomState(seed)
    image = r.randn(b, IMAGE, IMAGE, 3).astype(np.float32)
    atts = np.ones((b, S), np.int32)
    atts[1, 4:] = 0
    atts[b - 1, 2:] = 0
    text = (r.randint(1, VOCAB, (b, S)) * atts).astype(np.int32)
    idx = np.asarray([3, 7, 3, 9][:b], np.int32)
    return image, text, atts, idx


def _jax_queues(seed=2):
    q = jalbef.init_albef_queues(jax.random.PRNGKey(seed), embed_size=EMB, queue_size=QUEUE)
    ids = np.full((1, QUEUE), -100, np.int32)
    ids[0, [1, 5]] = [3, 9]  # queue entries of the batch's images: soft targets
    return q._replace(idx_queue=jnp.asarray(ids))


def _port_queues(jq):
    return talbef.ALBEFQueues(*(torch.from_numpy(np.array(a)) for a in jq))


def _t(x):
    return torch.from_numpy(np.array(x))


def _port_batch(image, text, atts, idx):
    return _t(image), _t(text).long(), _t(atts), _t(idx).long()


def _jax_negatives(sim, rng):
    """The JAX step's draw, replayed from its similarities and key."""
    bs = sim.sim_i2t.shape[0]
    diag = jnp.eye(bs, dtype=bool)
    neg = jnp.finfo(jnp.float32).min
    rng_i, rng_t = jax.random.split(rng)
    img = jax.random.categorical(rng_i, jnp.where(diag, neg, sim.sim_t2i[:, :bs]), axis=1)
    txt = jax.random.categorical(rng_t, jnp.where(diag, neg, sim.sim_i2t[:, :bs]), axis=1)
    return torch.from_numpy(np.array(img)).long(), torch.from_numpy(np.array(txt)).long()


def _use_negatives(monkeypatch, pairs):
    """Makes the port's draws return ``pairs`` in turn."""
    it = iter(pairs)
    monkeypatch.setattr(talbef, "hard_negative_indices", lambda *a, **k: next(it))


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=atol, rtol=1e-4)


def _close_tree(sd_got, jax_tree, rel=GRAD_REL):
    want = albef_state_dict_from_jax(_np(jax_tree.get("params", jax_tree)))
    assert sorted(sd_got) == sorted(want)
    for k, w in want.items():
        w = w.numpy()
        tol = rel * max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(sd_got[k].detach().numpy(), w, atol=tol, rtol=1e-4,
                                   err_msg=k)


@pytest.fixture(scope="module")
def sim_setup():
    image, text, atts, idx = _batch()
    jm = _jax_sim()
    variables = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(image),
                                 jnp.asarray(text), jnp.asarray(atts))
    variables = _perturb(variables, 1, 0.02)
    variables_m = _perturb(variables, 3)
    return jm, variables, variables_m, (image, text, atts, idx)


def _port_sim_pair(variables, variables_m):
    model = _port_sim()
    model.load_state_dict(albef_state_dict_from_jax(_np(variables["params"])), strict=True)
    model_m = momentum_copy(model, device="cpu")
    model_m.load_state_dict(albef_state_dict_from_jax(_np(variables_m["params"])), strict=True)
    assert not list(model_m.parameters())
    return model, model_m


def test_vision_encoder_matches_jax(sim_setup):
    jm, variables, _, (image, *_rest) = sim_setup
    enc = ALBEFVisionEncoder(image_size=IMAGE, patch_size=PATCH, num_hidden_layers=LAYERS,
                             num_attention_heads=HEADS, hidden_size=H, mlp_dim=FF)
    jp = variables["params"]["albef_model"]["vision_encoder"]
    enc.load_state_dict(albef_state_dict_from_jax(_np(jp)), strict=True)
    want = JVision(image_size=IMAGE, patch_size=PATCH, num_hidden_layers=LAYERS,
                   num_attention_heads=HEADS, hidden_size=H, mlp_dim=FF).apply(
        {"params": jp}, jnp.asarray(image))
    got = enc(_t(image))
    assert got.shape == (B, (IMAGE // PATCH) ** 2 + 1, H)
    _close(got, want)


@pytest.mark.parametrize("masked", [False, True])
def test_multimodal_encoder_matches_jax(sim_setup, masked):
    _, variables, _, (_, _, atts, _) = sim_setup
    r = np.random.RandomState(4)
    text = r.randn(B, S, H).astype(np.float32)
    image = r.randn(B, 5, H).astype(np.float32)
    jp = variables["params"]["albef_model"]["multimodal_encoder"]
    mask = jnp.asarray(atts) if masked else None
    want = JMulti(hidden_size=H, num_hidden_layers=LAYERS, num_attention_heads=HEADS,
                  intermediate_size=FF).apply({"params": jp}, jnp.asarray(text), mask,
                                              jnp.asarray(image))
    enc = ALBEFMultimodalEncoder(hidden_size=H, num_hidden_layers=LAYERS,
                                 num_attention_heads=HEADS, intermediate_size=FF)
    enc.load_state_dict(albef_state_dict_from_jax(_np(jp)), strict=True)
    got = enc(_t(text), _t(atts) if masked else None, _t(image))
    _close(got, want)


def test_forward_with_momentum_matches_jax(sim_setup):
    _, variables, variables_m, batch = sim_setup
    jm = _jax_albef()
    jv = {"params": variables["params"]["albef_model"]}
    jv_m = {"params": variables_m["params"]["albef_model"]}
    want, want_m = jalbef.albef_forward_with_momentum(
        jm, jv, jv_m, *(jnp.asarray(a) for a in batch[:3]), deterministic=True)
    model = _port_albef()
    model.load_state_dict(albef_state_dict_from_jax(_np(jv["params"])), strict=True)
    model_m = momentum_copy(model, device="cpu")
    model_m.load_state_dict(albef_state_dict_from_jax(_np(jv_m["params"])), strict=True)
    got = talbef.albef_forward_with_momentum(model, model_m, *_port_batch(*batch)[:3],
                                             deterministic=True)
    for g, w in zip(got, want):
        _close(g, w)
    _close_tree(model_m.state_dict(), want_m)


def test_similarity_forward_matches_jax_over_steps(sim_setup, monkeypatch):
    """Three steps from one queue: similarities, targets, embeddings, the
    negative pass and the new momentum tree and queues after each; the ring
    wraps at the second step and the third overwrites the first's columns."""
    jm, variables, variables_m, batch = sim_setup
    jq = _jax_queues()
    model, model_m = _port_sim_pair(variables, variables_m)
    queues = _port_queues(jq)
    jv, jv_m = variables, variables_m
    for step in range(3):
        image, text, atts, idx = _batch(seed=10 + step)
        rng = jax.random.PRNGKey(20 + step)
        want, jv_m, jq = jalbef.albef_with_similarity_forward(
            jm, jv, jv_m, jq, jnp.asarray(image), jnp.asarray(text), jnp.asarray(atts),
            jnp.asarray(idx), rng, deterministic=True)
        _use_negatives(monkeypatch, [_jax_negatives(want.similarity, rng)])
        got = talbef.albef_with_similarity_forward(model, model_m, queues,
                                                   *_port_batch(image, text, atts, idx),
                                                   deterministic=True)
        for g, w in zip(got.similarity, want.similarity):
            _close(g, w)
        _close(got.sim_targets, want.sim_targets)
        for name in ("image_embeddings", "text_embeddings", "multimodal_embeddings",
                     "multimodal_embeddings_neg"):
            _close(getattr(got, name), getattr(want, name))
        _close_tree(model_m.state_dict(), jv_m)
        for g, w in zip((queues.image_queue, queues.text_queue), (jq.image_queue, jq.text_queue)):
            _close(g, w)
        np.testing.assert_array_equal(queues.idx_queue.numpy(), np.asarray(jq.idx_queue))
        assert int(queues.queue_ptr) == int(jq.queue_ptr) == (B * (step + 1)) % QUEUE
    # the third step's targets saw the first two steps' ids in the queue
    assert float(want.sim_targets[0].sum()) == pytest.approx(1.0)


def test_enqueue_refuses_a_batch_that_does_not_divide_the_queue(sim_setup):
    _, variables, variables_m, _ = sim_setup
    model, model_m = _port_sim_pair(variables, variables_m)
    queues = _port_queues(_jax_queues())
    image, text, atts, idx = _batch(b=3)
    with pytest.raises(ValueError, match="divisible"):
        talbef.albef_with_similarity_forward(model, model_m, queues,
                                             *_port_batch(image, text, atts, idx))


@pytest.mark.parametrize("alpha", [0.0, 0.4])
def test_itc_loss_matches_jax(alpha):
    r = np.random.RandomState(5)
    sims = [r.randn(4, 12).astype(np.float32) * 3 for _ in range(4)]
    targets = r.rand(4, 12).astype(np.float32)
    targets /= targets.sum(1, keepdims=True)

    def jfn(a, b):
        return jloss.image_text_contrastive_loss(a, b, jnp.asarray(sims[2]), jnp.asarray(sims[3]),
                                                 jnp.asarray(targets), alpha=alpha)

    want, (ga, gb) = jax.value_and_grad(jfn, argnums=(0, 1))(jnp.asarray(sims[0]),
                                                              jnp.asarray(sims[1]))
    a, b = (_t(s).requires_grad_() for s in sims[:2])
    got = tloss.ImageTextContrastiveLoss()(a, b, _t(sims[2]), _t(sims[3]), _t(targets),
                                           alpha=alpha)
    got.backward()
    _close(got, want, 1e-6)
    _close(a.grad, ga, 1e-6)
    _close(b.grad, gb, 1e-6)
    # without targets: the identity
    _close(tloss.image_text_contrastive_loss(a, b),
           jloss.image_text_contrastive_loss(jnp.asarray(sims[0]), jnp.asarray(sims[1])), 1e-6)


@pytest.mark.parametrize("alpha", [0.0, 0.5])
def test_clm_loss_matches_jax(alpha):
    r = np.random.RandomState(6)
    scores = r.randn(3, 7, 11).astype(np.float32)
    scores_m = r.randn(3, 7, 11).astype(np.float32)
    labels = r.randint(0, 11, (3, 7)).astype(np.int32)
    labels[0, 4:] = -100
    labels[2, 1:] = -100

    def jfn(s):
        return jnp.sum(jloss.causal_language_modeling_loss(
            jnp.asarray(labels), s, jnp.asarray(scores_m), alpha=alpha) * jnp.arange(1.0, 4.0))

    want_vec = jloss.causal_language_modeling_loss(jnp.asarray(labels), jnp.asarray(scores),
                                                   jnp.asarray(scores_m), alpha=alpha)
    gw = jax.grad(jfn)(jnp.asarray(scores))
    s = _t(scores).requires_grad_()
    got = tloss.CausalLanguageModelingLoss()(_t(labels), s, _t(scores_m), alpha=alpha)
    (got * torch.arange(1.0, 4.0)).sum().backward()
    assert got.shape == (3,)
    _close(got, want_vec, 1e-5)
    _close(s.grad, gw, 1e-6)


def _retrieval_variables(variables):
    itm = jex.ALBEFModelForRetrieval(_jax_sim(), hidden_size=H).init(
        jax.random.PRNGKey(8), jnp.zeros((1, H)))
    itm = _perturb(itm, 9, 0.5)
    return {"params": {"model_with_similarity": variables["params"],
                       "itm_head": itm["params"]["itm_head"]}}


def test_retrieval_train_step_loss_gradients_and_momentum_match_jax(sim_setup, monkeypatch):
    _, variables, variables_m, batch = sim_setup
    jr = jex.ALBEFModelForRetrieval(_jax_sim(), hidden_size=H)
    jv = _retrieval_variables(variables)
    jv_m = _retrieval_variables(variables_m)
    jq = _jax_queues()
    rng = jax.random.PRNGKey(11)
    jb = [jnp.asarray(a) for a in batch]

    def step(v):
        loss, new_m, new_q = jex.albef_retrieval_train_step(jr, v, jv_m, jq, *jb, rng,
                                                            alpha=0.4)
        return loss, (new_m, new_q)

    (want, (want_m, want_q)), grads = jax.jit(jax.value_and_grad(step, has_aux=True))(jv)
    sim, _, _ = jalbef.albef_with_similarity_forward(
        jr.model_with_similarity, {"params": jv["params"]["model_with_similarity"]},
        {"params": jv_m["params"]["model_with_similarity"]}, jq, *jb, rng, deterministic=True)
    _use_negatives(monkeypatch, [_jax_negatives(sim.similarity, rng)])

    model = tex.ALBEFModelForRetrieval(_port_sim(), hidden_size=H)
    model.load_state_dict(albef_state_dict_from_jax(_np(jv["params"])), strict=True)
    model_m = momentum_copy(model.model_with_similarity, device="cpu")
    model_m.load_state_dict(
        albef_state_dict_from_jax(_np(jv_m["params"]["model_with_similarity"])), strict=True)
    queues = _port_queues(jq)
    loss = tex.albef_retrieval_train_step(model, model_m, queues, *_port_batch(*batch),
                                          alpha=0.4)
    loss.backward()
    _close(loss, want, 1e-5)
    _close_tree({k: p.grad for k, p in model.named_parameters()}, grads)
    _close_tree(model_m.state_dict(), want_m["params"]["model_with_similarity"])
    assert int(queues.queue_ptr) == int(want_q.queue_ptr) == B
    _close(queues.text_queue, want_q.text_queue)


def test_hard_negative_draw_properties(monkeypatch):
    """The draw's weights are the softmax of each row less the diagonal
    (read off the call it makes); never the diagonal, and frequencies those
    weights' (5,000 draws a row: 4 sigma of a frequency is at most 0.029);
    at batch 2 the draw is forced; batch 1 is refused. One thread: the test
    makes 10,000 small calls."""
    r = np.random.RandomState(15)
    sim = _t(r.randn(5, 5).astype(np.float32) * 2)
    masked = sim.masked_fill(torch.eye(5, dtype=torch.bool), -torch.inf)
    want = torch.softmax(masked, dim=1)
    seen = []
    multinomial = torch.multinomial

    def record(w, *args, **kwargs):
        seen.append(w)
        return multinomial(w, *args, **kwargs)

    monkeypatch.setattr(torch, "multinomial", record)
    gen = torch.Generator().manual_seed(0)
    talbef.hard_negative_indices(sim, sim * 0.5, gen)
    np.testing.assert_allclose(seen[0].numpy(), torch.softmax(
        (sim * 0.5).masked_fill(torch.eye(5, dtype=torch.bool), -torch.inf), 1).numpy(),
        rtol=1e-6)
    np.testing.assert_allclose(seen[1].numpy(), want.numpy(), rtol=1e-6)
    monkeypatch.setattr(torch, "multinomial", multinomial)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        n = 5_000
        draws = torch.stack([torch.stack(talbef.hard_negative_indices(sim, sim, gen))
                             for _ in range(n)])  # (n, 2, 5)
    finally:
        torch.set_num_threads(threads)
    assert not (draws == torch.arange(5)).any()
    counts = torch.nn.functional.one_hot(draws[:, 0], 5).sum(0).float()
    np.testing.assert_allclose((counts / n).numpy(), want.numpy(), atol=0.03)
    pair = _t(r.randn(2, 2).astype(np.float32))
    img, txt = talbef.hard_negative_indices(pair, pair, gen)
    assert img.tolist() == [1, 0] and txt.tolist() == [1, 0]
    with pytest.raises(ValueError, match="at least 2"):
        talbef.hard_negative_indices(pair[:1, :1], pair[:1, :1], gen)


def test_queues_and_momentum_copy():
    q = talbef.init_albef_queues(EMB, QUEUE, generator=torch.Generator().manual_seed(1),
                                 device="cpu")
    np.testing.assert_allclose(torch.linalg.vector_norm(q.image_queue, dim=0).numpy(), 1.0,
                               rtol=1e-6)
    assert (q.idx_queue == -100).all() and int(q.queue_ptr) == 0
    assert sorted(dict(q.named_buffers())) == ["idx_queue", "image_queue", "queue_ptr",
                                               "text_queue"]
    model = _port_sim()
    model_m = momentum_copy(model, device="cpu")
    assert not list(model_m.parameters())
    assert sorted(dict(model_m.named_buffers())) == sorted(dict(model.named_parameters()))
    with torch.no_grad():
        for p in model.parameters():
            p.add_(1.0)
    before = model_m.temp.clone()
    from multimodal_tpu_torch.utils.common import momentum_update

    momentum_update(model, model_m, 0.9)
    np.testing.assert_allclose(float(model_m.temp),
                               float(before * 0.9 + model.temp.detach() * 0.1),
                               rtol=1e-6)

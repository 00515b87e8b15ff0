"""The port's BLIP-2 stage 1 held against the JAX package at small widths:
``get_causal_mask``, ``QformerEmbedding``, the Q-Former's query pass (its
outputs and cached keys and values), text pass, ``[queries; text]`` pass and
causal-LM pass over the cached query rows (``QformerForCLM``), ``BLIP2``'s
outputs and ``itm_forward``, ``blip2_phase1_loss`` (ITC, ITM, ITG) and every
gradient against ``jax.grad`` with JAX's hard-negative indices substituted
for the port's draw, the frozen tower left without gradient, the weights
carried by path (``utils/checkpoint.py:state_dict_from_jax_tree``) and the
draw's frequencies on their own (the port draws with ``torch.multinomial``,
JAX with ``jax.random.categorical``: the same distribution, other draws).

32 query tokens, 36 text tokens and a 37-token image tower put the
self-attention (masked: the flash path's bias lane), the cross-attention and
the tower on the flash path's plain version; the Q-Former's widths (64, 128)
on the fused MLP's. Weights drawn with numpy for the JAX tree; fp32; outputs
to 3e-5 and gradients to 2e-5 of each tensor's largest element (or
absolutely below 1).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_tpu.models.blip2 import qformer_utils as jutils
from multimodal_tpu.models.blip2.blip2 import BLIP2 as JBLIP2
from multimodal_tpu.models.blip2.qformer_layers import QformerEmbedding as JEmbedding
from multimodal_tpu.models.blip2.qformer_model import QformerForCLM as JQformer
from multimodal_tpu.modules.encoders.vision_transformer import vision_transformer as j_vit
from multimodal_tpu.modules.losses import blip2_losses as jloss
from multimodal_tpu_torch.models.blip2 import qformer_utils as tutils
from multimodal_tpu_torch.models.blip2.blip2 import BLIP2
from multimodal_tpu_torch.models.blip2.qformer_layers import QformerEmbedding
from multimodal_tpu_torch.models.blip2.qformer_model import QformerForCLM
from multimodal_tpu_torch.modules.encoders.vision_transformer import vision_transformer
from multimodal_tpu_torch.modules.losses import blip2_losses as tloss
from multimodal_tpu_torch.utils.checkpoint import state_dict_from_jax_tree

DQ, FF, HEADS, LAYERS, VOCAB, MAXPOS = 64, 128, 2, 2, 300, 48
NQ, S, B, IMG, DV, EMB = 32, 36, 4, 48, 96, 32
BOS = VOCAB - 1
QF = dict(num_hidden_layers=LAYERS, dim_q=DQ, dim_feedforward=FF, num_heads=HEADS,
          max_position_embeddings=MAXPOS, vocab_size=VOCAB, query_length=NQ, dim_kv=DV)
VIT = dict(patch_size=8, hidden_dim=DV, dim_feedforward=128, n_layer=2, n_head=2,
           image_size=IMG)
ATOL = 3e-5
GRAD_REL = 2e-5


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, atol=ATOL):
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want,
                               atol=atol * max(1.0, float(np.abs(want).max())), rtol=1e-4)


def _random_params(shapes, seed):
    """Weights for a JAX parameter tree of ``jax.eval_shape`` structs, drawn
    with numpy: fan-in scaled kernels, LayerNorm scales near 1, the rest
    small, the temperature near its 0.07."""
    r = np.random.RandomState(seed)

    def draw(path, s):
        name = getattr(path[-1], "key", "")
        x = r.standard_normal(s.shape).astype(np.float32)
        if name == "kernel":
            x /= np.sqrt(np.prod(s.shape[:-1]))
        elif name == "scale":
            x = 1.0 + 0.1 * x
        elif name == "temp":
            x = np.float32(0.07) + 0.005 * x
        else:
            x *= 0.05
        return jnp.asarray(x)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _batch(seed=0, b=B):
    r = np.random.RandomState(seed)
    image = r.randn(b, IMG, IMG, 3).astype(np.float32)
    atts = np.ones((b, S), np.int32)
    atts[1, 20:] = 0
    atts[b - 1, 5:] = 0
    ids = (r.randint(1, VOCAB - 1, (b, S)) * atts).astype(np.int32)
    return image, ids, atts


def _jax_models():
    qf = JQformer(**QF)
    return JBLIP2(qformer=qf, vision_encoder=j_vit(**VIT), dim_q=DQ,
                  image_encoder_embedding_dim=DV, embedding_dim=EMB, num_query_token=NQ,
                  decoder_bos_token_id=BOS), jloss.Blip2Phase1Loss(dim_q=DQ)


def _port_models():
    model = BLIP2(QformerForCLM(**QF), vision_transformer(**VIT), dim_q=DQ,
                  image_encoder_embedding_dim=DV, embedding_dim=EMB, num_query_token=NQ,
                  decoder_bos_token_id=BOS)
    return model, tloss.Blip2Phase1Loss(dim_q=DQ)


@pytest.fixture(scope="module")
def setup():
    image, ids, atts = _batch()
    jm, jl = _jax_models()
    pb = _random_params(jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(image),
                                       jnp.asarray(ids), jnp.asarray(atts))["params"], 1)
    pl = _random_params(jax.eval_shape(jl.init, jax.random.PRNGKey(0),
                                       jnp.zeros((1, DQ)))["params"], 2)
    tm, tl = _port_models()
    tm.load_state_dict(state_dict_from_jax_tree(_np(pb)), strict=True)
    tl.load_state_dict(state_dict_from_jax_tree(_np(pl)), strict=True)
    return jm, jl, pb, pl, tm, tl, (image, ids, atts)


@pytest.mark.parametrize("has_query,prefix", [(False, 0), (False, 5), (True, 7)])
def test_get_causal_mask_matches_jax(has_query, prefix):
    r = np.random.RandomState(3)
    atts = (r.rand(3, 6 + prefix) > 0.3).astype(np.float32)
    want = jutils.get_causal_mask(jnp.asarray(atts), (3, 6), has_query=has_query)
    got = tutils.get_causal_mask(_t(atts), (3, 6), has_query=has_query)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("parts", ["ids", "query", "both", "past"])
def test_qformer_embedding_matches_jax(setup, parts):
    _, _, pb, _, _, _, (_, ids, _) = setup
    p = pb["qformer"]["model"]["embeddings"]
    query = np.random.RandomState(4).randn(B, NQ, DQ).astype(np.float32)
    kw = {"ids": dict(input_ids=ids), "query": dict(query_embeddings=query),
          "both": dict(input_ids=ids, query_embeddings=query),
          "past": dict(input_ids=ids[:, :9], past_seq_length=5)}[parts]
    jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    tkw = {k: (_t(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    if "input_ids" in tkw:
        tkw["input_ids"] = tkw["input_ids"].long()
    want = JEmbedding(DQ, MAXPOS, VOCAB).apply({"params": p}, **jkw)
    tm = QformerEmbedding(DQ, MAXPOS, VOCAB)
    tm.load_state_dict(state_dict_from_jax_tree(_np(p)), strict=True)
    _close(tm(**tkw), want)


def test_qformer_passes_match_jax(setup):
    """The query pass with cross-attention (outputs and every layer's cached
    keys and values), the text pass under its padding mask, the
    ``[queries; text]`` pass (``itm_forward``) and the causal-LM pass over
    the cached query rows (``QformerForCLM``)."""
    jm, _, pb, _, tm, _, (image, ids, atts) = setup
    r = np.random.RandomState(6)
    query = r.randn(B, NQ, DQ).astype(np.float32)
    enc = r.randn(B, 37, DV).astype(np.float32)
    jq, pq = JQformer(**QF), {"params": pb["qformer"]}

    @jax.jit
    def jax_passes(pq):
        q_out, kvs = jq.apply(pq, query_embeds=query, encoder_hidden_states=enc,
                              use_cache=True, method=lambda m, **k: m.model(**k))
        t_out, _ = jq.apply(pq, input_ids=ids, attention_mask=atts,
                            method=lambda m, **k: m.model(**k))
        full = jnp.concatenate([jnp.ones((B, NQ), jnp.int32), jnp.asarray(atts)], axis=1)
        vl, _ = jq.apply(pq, input_ids=ids, query_embeds=query, attention_mask=full,
                         encoder_hidden_states=enc, method=lambda m, **k: m.model(**k))
        scores = jq.apply(pq, input_ids=ids, attention_mask=full, past_key_values=kvs)
        return q_out, kvs, t_out, vl, scores

    q_out, kvs, t_out, vl, scores = jax_passes(pq)
    qf = tm.qformer
    with torch.no_grad():
        got_q, got_kvs = qf.model(query_embeds=_t(query), encoder_hidden_states=_t(enc),
                                  use_cache=True)
        got_t, _ = qf.model(input_ids=_t(ids).long(), attention_mask=_t(atts))
        full = torch.cat([torch.ones(B, NQ, dtype=torch.int32), _t(atts)], dim=1)
        got_vl, _ = qf.model(input_ids=_t(ids).long(), query_embeds=_t(query),
                             attention_mask=full, encoder_hidden_states=_t(enc))
        got_scores = qf(input_ids=_t(ids).long(), attention_mask=full,
                        past_key_values=got_kvs)
    _close(got_q, q_out)
    assert len(got_kvs) == LAYERS
    for (gk, gv), (wk, wv) in zip(got_kvs, kvs):
        assert tuple(gk.shape) == (B, HEADS, NQ, DQ // HEADS)
        _close(gk, wk)
        _close(gv, wv)
    _close(got_t, t_out)
    _close(got_vl, vl)
    _close(got_scores, scores)
    with pytest.raises(ValueError, match="both past_key_values and query_embeds"):
        qf(input_ids=_t(ids).long(), query_embeds=_t(query), past_key_values=got_kvs)


def test_blip2_forward_matches_jax(setup):
    jm, _, pb, _, tm, _, (image, ids, atts) = setup
    want = jax.jit(jm.apply)({"params": pb}, jnp.asarray(image), jnp.asarray(ids),
                             jnp.asarray(atts))
    with torch.no_grad():
        got = tm(_t(image), _t(ids).long(), _t(atts))
        vl = tm.itm_forward(_t(ids).long(), _t(atts), got.image_embeddings)
    for name in ("image_embeddings", "image_features", "image_qformer_output",
                 "text_features", "prediction_scores"):
        _close(getattr(got, name), getattr(want, name))
    want_vl = jax.jit(lambda p: jm.apply(p, jnp.asarray(ids), jnp.asarray(atts),
                                         want.image_embeddings, method=JBLIP2.itm_forward))(
        {"params": pb})
    _close(vl, want_vl)
    assert tuple(got.prediction_scores.shape) == (B, S, VOCAB)


def _jax_loss(jm, jl, image, ids, atts, rng):
    def total(pb, pl):
        out = jm.apply({"params": pb}, image, ids, atts)
        losses = jloss.blip2_phase1_loss(jl, {"params": pl}, jm, {"params": pb}, out, ids,
                                         atts, rng, decoder_bos_token_id=BOS,
                                         vocab_size=VOCAB)
        return losses.total_loss, losses

    def negatives(pb, pl):
        # the JAX step's draw, replayed from its similarities and key
        out = jm.apply({"params": pb}, image, ids, atts)
        sim_i2t, sim_t2i = jloss.compute_image_text_similarity(
            out.image_features, out.text_features, pl["temp"])
        diag = jnp.eye(B, dtype=bool)
        rng_i, rng_t = jax.random.split(rng)
        img = jax.random.categorical(
            rng_i, jnp.where(diag, -jnp.inf, jax.nn.log_softmax(sim_t2i, axis=1)), axis=1)
        txt = jax.random.categorical(
            rng_t, jnp.where(diag, -jnp.inf, jax.nn.log_softmax(sim_i2t, axis=1)), axis=1)
        return img, txt

    return jax.jit(jax.value_and_grad(total, argnums=(0, 1), has_aux=True)), jax.jit(negatives)


def _close_grads(module, jax_grads):
    want = state_dict_from_jax_tree(_np(jax_grads))
    got = {k: p.grad for k, p in module.named_parameters() if p.grad is not None}
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        w = w.numpy()
        tol = GRAD_REL * max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(got[k].numpy(), w, atol=tol, rtol=1e-4, err_msg=k)


def test_blip2_phase1_loss_and_gradients_match_jax(setup, monkeypatch):
    """The three losses and every gradient of the model and of the loss
    module (ITM head, temperature); none reaches the frozen tower, whose
    parameters keep no gradient."""
    jm, jl, pb, pl, tm, tl, (image, ids, atts) = setup
    rng = jax.random.PRNGKey(9)
    grad_fn, neg_fn = _jax_loss(jm, jl, jnp.asarray(image), jnp.asarray(ids), jnp.asarray(atts),
                                rng)
    (_, want), (gb, gl) = grad_fn(pb, pl)
    img_idx, txt_idx = (torch.from_numpy(np.array(a)).long() for a in neg_fn(pb, pl))
    assert not bool((img_idx == torch.arange(B)).any() or (txt_idx == torch.arange(B)).any())
    monkeypatch.setattr(tloss, "hard_negative_indices", lambda *a, **k: (img_idx, txt_idx))
    tm.zero_grad(set_to_none=True)
    tl.zero_grad(set_to_none=True)
    out = tm(_t(image), _t(ids).long(), _t(atts))
    got = tloss.blip2_phase1_loss(tl, tm, out, _t(ids).long(), _t(atts),
                                  decoder_bos_token_id=BOS, vocab_size=VOCAB)
    got.total_loss.backward()
    for name in got._fields:
        np.testing.assert_allclose(float(getattr(got, name).detach()),
                                   float(getattr(want, name)), rtol=1e-5, atol=1e-6,
                                   err_msg=name)
    assert all(p.grad is None for p in tm.vision_encoder.parameters())
    assert all(not np.asarray(g).any() for g in jax.tree.leaves(gb["vision_encoder"]))
    gb = {k: v for k, v in gb.items() if k != "vision_encoder"}
    _close_grads(tm, gb)
    _close_grads(tl, gl)


@pytest.mark.parametrize("enabled", [("itc",), ("itm",), ("itg",), ("itc", "itg")])
def test_blip2_phase1_loss_switches(setup, enabled):
    """Disabled terms are 0 and left out of the total; all disabled raises."""
    _, _, _, _, tm, tl, (image, ids, atts) = setup
    loss = tloss.Blip2Phase1Loss(DQ, *(k in enabled for k in ("itc", "itm", "itg")))
    loss.load_state_dict(tl.state_dict())
    with torch.no_grad():
        out = tm(_t(image), _t(ids).long(), _t(atts))
        got = tloss.blip2_phase1_loss(loss, tm, out, _t(ids).long(), _t(atts),
                                      torch.Generator().manual_seed(0),
                                      decoder_bos_token_id=BOS, vocab_size=VOCAB)
    terms = dict(itc=got.image_text_contrastive_loss, itm=got.image_text_matching_loss,
                 itg=got.image_captioning_loss)
    for k, v in terms.items():
        assert (float(v) > 0) == (k in enabled)
    assert float(got.total_loss) == pytest.approx(sum(float(v) for v in terms.values()))
    with pytest.raises(ValueError, match="disabled"):
        tloss.Blip2Phase1Loss(DQ, False, False, False)


@pytest.mark.parametrize("offset", [0, 3])
def test_hard_negative_draw_frequencies(offset):
    """The shared draw (``models/albef/model.py:hard_negative_indices``) as
    ``itm_loss`` calls it, rows of a rank against a gathered batch with the
    diagonal at ``offset``: each index's frequency over 6,000 draws within
    0.02 of the softmax over the row without its diagonal, which is never
    drawn."""
    r = np.random.RandomState(10)
    sim_i2t = torch.from_numpy(r.randn(3, 7).astype(np.float32)) * 2
    sim_t2i = torch.from_numpy(r.randn(3, 7).astype(np.float32)) * 2
    gen = torch.Generator().manual_seed(11)
    # one intra-op thread: 6,000 calls on 3 x 7 tensors spend their time in
    # the thread pool's hand-offs when other processes hold the cores
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        draws = [tloss.hard_negative_indices(sim_i2t, sim_t2i, gen, offset=offset)
                 for _ in range(6000)]
    finally:
        torch.set_num_threads(threads)
    img = torch.stack([d[0] for d in draws])
    txt = torch.stack([d[1] for d in draws])
    diag = torch.arange(7)[None] == torch.arange(3)[:, None] + offset
    for idx, sim in ((img, sim_t2i), (txt, sim_i2t)):
        want = torch.softmax(sim.masked_fill(diag, -torch.inf), dim=1)
        freq = torch.stack([torch.bincount(idx[:, i], minlength=7) for i in range(3)]) / 6000
        assert float(freq[diag].sum()) == 0.0
        np.testing.assert_allclose(freq.numpy(), want.numpy(), atol=0.02)

"""The port's caption servers and the engine's per-request conditioning and
``kv_prefix`` rows, held against the JAX package at small widths.

CoCa: the adapter's full-forward logits against ``CoCaModel``'s
teacher-forced captioning logits, ``encode`` against the JAX server's, and
served greedy captions (an fp32 cache, more requests than slots, 1 and 3
decode ticks a call) equal token for token to the JAX test's standalone
greedy loop over the JAX adapter (``tests/serving/test_caption_server.py``'s
``_ref_greedy``). BLIP-2: ``prime``'s features against ``BLIP2``'s, and
served greedy captions equal to the greedy loop over the JAX ``BLIP2``'s
teacher-forced ``prediction_scores`` (``test_blip2_caption_server.py``'s
``_ref_greedy``). The loops run every request at once on a fixed-width
padded batch: the models are causal, so positions past a row's length
change nothing before it. The engine: the conditioning buffer and its trash
row, the prefix rows in the fp32 and int8 caches (quantized by
``quantize_kv``), slot reuse clearing both, and the validation errors.
Weights drawn with numpy for the JAX trees, carried by path.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_tpu.models.blip2.blip2 import BLIP2 as JBLIP2
from multimodal_tpu.models.blip2.qformer_model import QformerForCLM as JQformer
from multimodal_tpu.models.coca import coca_model as jcoca
from multimodal_tpu.modules.encoders.vision_transformer import vision_transformer as j_vit
from multimodal_tpu.serving.caption_server import CoCaCaptionServer as JCoCaServer
from multimodal_tpu_torch.models.blip2.blip2 import BLIP2
from multimodal_tpu_torch.models.blip2.qformer_model import QformerForCLM
from multimodal_tpu_torch.models.coca import coca_model as tcoca
from multimodal_tpu_torch.modules.encoders.vision_transformer import vision_transformer
from multimodal_tpu_torch.ops.kv_cache import quantize_kv
from multimodal_tpu_torch.serving import engine as eng
from multimodal_tpu_torch.serving.blip2_caption_server import Blip2CaptionServer
from multimodal_tpu_torch.serving.caption_server import CoCaCaptionServer
from multimodal_tpu_torch.serving.engine import InferenceEngine, Request
from multimodal_tpu_torch.utils.checkpoint import state_dict_from_jax_tree

VOCAB, POS, IMG = 120, 12, 32  # CoCa: a caption budget of 11 positions
COCA = dict(vision_patch_size=8, vision_dim_feedforward=128, vision_n_layer=2, vision_n_head=2,
            vocab_size=VOCAB, num_text_positions=POS, text_hidden_dim=64, text_n_layer=2,
            text_n_head=2, text_dim_feedforward=128, text_output_dim=64, fusion_n_layer=2,
            fusion_n_head=2, fusion_dim_feedforward=128, pooler_input_embed_dim=96,
            pooler_output_embed_dim=64, pooler_n_head=2, image_size=IMG,
            multimodal_output_projection_dim=VOCAB, pooler_n_queries=6)
DQ, NQ, BOS, MAXPOS = 64, 4, VOCAB - 1, 32  # BLIP-2
QF = dict(num_hidden_layers=2, dim_q=DQ, dim_feedforward=128, num_heads=2,
          max_position_embeddings=MAXPOS, vocab_size=VOCAB, query_length=NQ, dim_kv=96)
VIT = dict(patch_size=8, hidden_dim=96, dim_feedforward=128, n_layer=2, n_head=2, image_size=16)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _random_params(shapes, seed):
    """Numpy draws for a tree of ``jax.eval_shape`` structs: fan-in scaled
    kernels (and a unit-normal output projection, for well separated
    logits), LayerNorm scales near 1, the rest small."""
    r = np.random.RandomState(seed)

    def draw(path, s):
        name = getattr(path[-1], "key", "")
        x = r.standard_normal(s.shape).astype(np.float32)
        if name == "kernel":
            x /= np.sqrt(np.prod(s.shape[:-1]))
        elif name == "scale":
            x = 1.0 + 0.1 * x
        elif name not in ("query", "embedding"):
            x *= 0.05
        return jnp.asarray(x)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _images(n, size, seed=7):
    return np.random.RandomState(seed).rand(n, size, size, 3).astype(np.float32)


@pytest.fixture(scope="module")
def coca():
    jm = jcoca.coca_vit(**COCA)
    params = _random_params(jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                                           jnp.zeros((1, IMG, IMG, 3)),
                                           jnp.ones((1, POS), jnp.int32))["params"], 1)
    tm = tcoca.coca_vit(device="cpu", **COCA)
    tm.load_state_dict(state_dict_from_jax_tree(_np(params)), strict=True)
    jserver = JCoCaServer(jm, {"params": params}, n_slots=1)
    return jm, params, tm, jserver


@pytest.fixture(scope="module")
def blip2():
    jm = JBLIP2(qformer=JQformer(**QF), vision_encoder=j_vit(**VIT), dim_q=DQ,
                image_encoder_embedding_dim=96, embedding_dim=16, num_query_token=NQ,
                decoder_bos_token_id=BOS)
    ids = jnp.ones((1, 6), jnp.int32)
    params = _random_params(jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                                           jnp.zeros((1, 16, 16, 3)), ids, ids)["params"], 2)
    tm = BLIP2(QformerForCLM(**QF), vision_transformer(**VIT), dim_q=DQ,
               image_encoder_embedding_dim=96, embedding_dim=16, num_query_token=NQ,
               decoder_bos_token_id=BOS)
    tm.load_state_dict(state_dict_from_jax_tree(_np(params)), strict=True)
    return jm, params, tm


def _batched_greedy(logits_fn, prompts, max_new, width):
    """Greedy decoding of every prompt at once on a ``width``-wide padded
    batch: ``logits_fn(ids)`` gives ``(n, width, vocab)``; row i reads its
    next token at its own length."""
    toks = [list(p) for p in prompts]
    for _ in range(max_new):
        ids = np.zeros((len(toks), width), np.int32)
        for i, t in enumerate(toks):
            ids[i, :len(t)] = t
        logits = np.asarray(logits_fn(jnp.asarray(ids)))
        for i, t in enumerate(toks):
            t.append(int(np.argmax(logits[i, len(t) - 1])))
    return [t[len(p):] for t, p in zip(toks, prompts)]


def test_coca_adapter_matches_model_captioning_logits(coca):
    """The adapter's full forward equals ``CoCaModel``'s teacher-forced
    captioning logits on pad-free text (its causal mask is then the
    model's); ``encode`` equals the JAX server's."""
    jm, params, tm, jserver = coca
    images = _images(2, IMG)
    texts = np.random.RandomState(3).randint(1, VOCAB, (2, POS)).astype(np.int32)
    want = jax.jit(jm.apply)({"params": params}, jnp.asarray(images),
                             jnp.asarray(texts)).multimodal_embeddings
    server = CoCaCaptionServer(tm, n_slots=2, device="cpu")
    cap, con = server.encode(torch.from_numpy(images))
    want_cap, want_con = jserver.encode(images)
    np.testing.assert_allclose(cap.numpy(), want_cap, atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(con.numpy(), want_con, atol=2e-6, rtol=1e-5)
    with torch.no_grad():
        got = server.adapter(torch.from_numpy(texts[:, :POS - 1]).long(), conditioning=cap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-5, rtol=1e-4)


@pytest.mark.parametrize("decode_steps", [1, 3])
def test_coca_served_captions_match_jax_greedy(coca, decode_steps):
    """Five requests over two slots (slot reuse, mixed images in flight):
    each caption equals the JAX adapter's standalone greedy decode."""
    _, params, tm, jserver = coca
    n_req, max_new = 5, 6
    images = _images(n_req, IMG)
    cap_jax, _ = jserver.encode(images)
    prompts = [[1 + i, 2 + i] for i in range(n_req)]
    apply = jax.jit(lambda ids: jserver.adapter.apply({"params": params}, ids,
                                                      conditioning=jnp.asarray(cap_jax)))
    want = _batched_greedy(apply, prompts, max_new, POS - 1)
    server = CoCaCaptionServer(tm, n_slots=2, device="cpu", cache_dtype=torch.float32,
                               decode_steps=decode_steps, prefill_batch=2)
    cap, _ = server.encode(torch.from_numpy(images))
    for i in range(n_req):
        server.submit(prompts[i], image_tokens=cap[i], request_id=i, max_new_tokens=max_new)
    outs = {o.request_id: o for o in server.run()}
    assert sorted(outs) == list(range(n_req))
    assert [outs[i].tokens for i in range(n_req)] == want
    # the buffer's trash row was never written
    assert not server.engine.conditioning[-1].any()


def test_coca_int8_serving_and_submit_paths(coca):
    """The int8 cache serves every request to its length; ``image=``
    encodes inside ``submit``; the validation errors."""
    _, _, tm, _ = coca
    server = CoCaCaptionServer(tm, n_slots=2, device="cpu", cache_dtype="int8", decode_steps=2)
    images = _images(3, IMG, seed=9)
    with pytest.raises(ValueError, match="exactly one"):
        server.submit([1, 2])
    with pytest.raises(ValueError, match="position table"):
        server.submit([1, 2], image=torch.from_numpy(images[0]), max_new_tokens=POS)
    server.submit([1], image=torch.from_numpy(images[0]), request_id=0, max_new_tokens=4)
    cap, _ = server.encode(torch.from_numpy(images))
    for i in (1, 2):
        server.submit([1, 5], image_tokens=cap[i], request_id=i)
    outs = {o.request_id: o for o in server.run()}
    assert [len(outs[i].tokens) for i in range(3)] == [4, POS - 3, POS - 3]
    assert all(0 <= t < VOCAB for o in outs.values() for t in o.tokens)


def test_blip2_prime_features_match_jax(blip2):
    jm, params, tm = blip2
    images = _images(2, 16)
    ids = jnp.ones((2, 4), jnp.int32)
    want = jax.jit(jm.apply)({"params": params}, jnp.asarray(images), ids, ids).image_features
    server = Blip2CaptionServer(tm, n_slots=1, device="cpu")
    kvs, feats = server.prime(torch.from_numpy(images))
    np.testing.assert_allclose(feats.numpy(), np.asarray(want), atol=2e-6, rtol=1e-5)
    assert len(kvs) == 2 and len(kvs[0]) == QF["num_hidden_layers"]
    assert tuple(kvs[0][0][0].shape) == (2, NQ, DQ // 2)


@pytest.mark.parametrize("decode_steps", [1, 3])
def test_blip2_served_captions_match_jax_greedy(blip2, decode_steps):
    """Four requests over two slots from BOS prompts of 1-3 tokens: each
    caption equals the greedy loop over the JAX ``BLIP2``'s teacher-forced
    ``prediction_scores``."""
    jm, params, tm = blip2
    n_req, max_new, width = 4, 5, 8
    images = _images(n_req, 16, seed=11)
    prompts = [[BOS], [BOS, 5], [BOS, 7, 9], [BOS, 2]]
    scores = jax.jit(lambda ids: jm.apply({"params": params}, jnp.asarray(images), ids,
                                          jnp.ones_like(ids)).prediction_scores)
    want = _batched_greedy(scores, prompts, max_new, width)
    server = Blip2CaptionServer(tm, n_slots=2, max_text_len=16, device="cpu",
                                cache_dtype=torch.float32, decode_steps=decode_steps)
    kvs, _ = server.prime(torch.from_numpy(images))
    for i in range(n_req):
        server.submit(prompts[i], kv_prefix=kvs[i], request_id=i, max_new_tokens=max_new)
    outs = {o.request_id: o for o in server.run()}
    assert [outs[i].tokens for i in range(n_req)] == want
    assert all(outs[i].prompt_len == NQ + len(prompts[i]) for i in range(n_req))


@pytest.mark.parametrize("cache_dtype", [torch.float32, "int8"])
def test_blip2_prefix_rows_and_slot_reuse(blip2, cache_dtype):
    """At admission a slot holds the request's prefix rows at [0, 4) (int8:
    exactly ``quantize_kv``'s), its prompt's rows from 4 and zeros after:
    a slot reused by a shorter request keeps nothing of the longer one.
    ``_kv_rows_like`` alone likewise; the served run completes."""
    _, _, tm = blip2
    server = Blip2CaptionServer(tm, n_slots=1, max_text_len=16, device="cpu",
                                cache_dtype=cache_dtype)
    engine = server.engine
    kvs, _ = server.prime(torch.from_numpy(_images(2, 16, seed=12)))
    server.submit([BOS, 3, 4, 5, 6], kv_prefix=kvs[0], request_id=0, max_new_tokens=8)
    server.submit([BOS], kv_prefix=kvs[1], request_id=1, max_new_tokens=3)
    assert [o.request_id for o in server.run()] == [0, 1]
    # replay the second admission into the slot the first one filled
    server.submit([BOS, 3, 4, 5, 6], kv_prefix=kvs[0], request_id=2, max_new_tokens=8)
    engine.step()
    server.submit([BOS], kv_prefix=kvs[1], request_id=3, max_new_tokens=3)
    while engine._slots[0].request is not None and engine._slots[0].request.request_id == 2:
        engine.step()
    engine._admit()
    for (ck, cv), (pk, pv) in zip(engine.cache, kvs[1]):
        for cache, pref in ((ck, pk), (cv, pv)):
            if cache_dtype == "int8":
                q, scale = quantize_kv(pref.float())
                assert torch.equal(cache.q[0, :, :NQ], q)
                assert torch.equal(cache.scale[0, :, :NQ], scale)
                rest = cache.q[0, :, NQ + 1:]
            else:
                assert torch.equal(cache[0, :, :NQ], pref)
                rest = cache[0, :, NQ + 1:]
            assert not rest.any()
    assert [len(o.tokens) for o in server.run()] == [8, 3]
    rows = eng._kv_rows_like(engine.cache[0][0], 3, kvs[0][0][0][None].float(), NQ)
    assert (rows.q if cache_dtype == "int8" else rows).shape[0] == 3


def test_engine_conditioning_and_prefix_validation(coca, blip2):
    _, _, ctm, _ = coca
    coca_server = CoCaCaptionServer(ctm, n_slots=1, device="cpu")
    engine = coca_server.engine
    cap, _ = coca_server.encode(torch.from_numpy(_images(1, IMG)))
    with pytest.raises(ValueError, match="conditioning is required"):
        engine.submit(Request([1], max_new_tokens=1))
    with pytest.raises(ValueError, match="conditioning shape"):
        engine.submit(Request([1], max_new_tokens=1, conditioning=cap[0, :3]))
    with pytest.raises(ValueError, match="kv_prefix is required"):
        engine.submit(Request([1], max_new_tokens=1, conditioning=cap[0], kv_prefix=()))
    with pytest.raises(ValueError, match="per-request conditioning"):
        engine.register_prefix("sys", [1, 2])

    _, _, btm = blip2
    server = Blip2CaptionServer(btm, n_slots=1, max_text_len=8, device="cpu")
    engine = server.engine
    kvs, _ = server.prime(torch.from_numpy(_images(1, 16)))
    with pytest.raises(ValueError, match="kv_prefix is required"):
        engine.submit(Request([1], max_new_tokens=1))
    with pytest.raises(ValueError, match="shape"):
        engine.submit(Request([1], max_new_tokens=1,
                              kv_prefix=tuple((k[:, :-1], v[:, :-1]) for k, v in kvs[0])))
    with pytest.raises(ValueError, match="layers"):
        engine.submit(Request([1], max_new_tokens=1, kv_prefix=kvs[0][:1]))
    with pytest.raises(ValueError, match="max_len"):
        engine.submit(Request([1, 2], max_new_tokens=8, kv_prefix=kvs[0]))
    with pytest.raises(ValueError, match="conditioning is required"):
        engine.submit(Request([1], max_new_tokens=1, kv_prefix=kvs[0], conditioning=cap[0]))
    with pytest.raises(ValueError, match="registered prefixes"):
        engine.register_prefix("sys", [1, 2])
    with pytest.raises(ValueError, match="exactly one"):
        server.submit([BOS])
    with pytest.raises(ValueError, match="max_text_len"):
        server.submit([BOS], kv_prefix=kvs[0], max_new_tokens=8)
    with pytest.raises(ValueError, match="text position table"):
        Blip2CaptionServer(btm, max_text_len=MAXPOS + 1, device="cpu")
    with pytest.raises(ValueError, match="kv_prefix_len"):
        InferenceEngine(server.adapter, n_slots=1, max_len=NQ, n_layer=2, n_head=2,
                        head_dim=32, kv_prefix_len=NQ, device="cpu")
    with pytest.raises(ValueError, match="cannot combine"):
        engine.submit(Request([1], max_new_tokens=1, kv_prefix=kvs[0], prefix="sys"))
    # the features still to port keep refusing
    with pytest.raises(NotImplementedError, match="A5"):
        engine.submit(Request([1], max_new_tokens=1, kv_prefix=kvs[0], adapter="a"))
    for kw in (dict(prefill_chunk=4), dict(window=8), dict(draft_model=server.adapter),
               dict(adapters={})):
        with pytest.raises(NotImplementedError, match="A5"):
            InferenceEngine(server.adapter, n_slots=1, max_len=12, n_layer=2, n_head=2,
                            head_dim=32, kv_prefix_len=NQ, device="cpu", **kw)


def test_caption_servers_raise_without_cuda(coca, blip2, monkeypatch):
    """With no device given the servers' engines want CUDA."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        CoCaCaptionServer(coca[2])
    with pytest.raises(RuntimeError, match="CUDA"):
        Blip2CaptionServer(blip2[2])

"""The port's CoCa held against the JAX package at small widths: the
attention poolers (one stage and cascaded), the text decoder's mask, pooled
output and tokens (with padding, and without the CLS token), the multimodal
decoder, ``CoCaModel`` with either pooler, ``CoCaModelWithHeads``,
``CoCaForPretraining``'s two losses and every gradient against ``jax.grad``,
the weights carried by path (``utils/checkpoint.py:state_dict_from_jax_tree``,
no named converter), and the parameter shapes of ``coca_vit_b_32`` and
``coca_vit_l_14`` (JAX's ``eval_shape`` against the port on the meta device).

Widths 64-96 so the fused MLP's plain version runs; 40 text positions and
48 x 48 images (36 patches) so the text and fusion self-attention and the
pooler take the flash path's plain version, with the dense masks on its bias
lane, and the vision tower the fused attention's. Inputs come from a numpy
seed, fp32 throughout; outputs to 3e-5 and gradients to 2e-5 of each
tensor's largest element (or absolutely below 1).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from multimodal_tpu.models.coca import coca_model as jcoca
from multimodal_tpu.models.coca.multimodal_decoder import CoCaMultimodalDecoder as JMulti
from multimodal_tpu.models.coca.text_decoder import CoCaTextDecoder as JText
from multimodal_tpu.modules.layers.attention_pooler import AttentionPooler as JPooler
from multimodal_tpu.modules.layers.attention_pooler import CascadedAttentionPooler as JCascaded
from multimodal_tpu_torch.models.coca import coca_model as tcoca
from multimodal_tpu_torch.models.coca.multimodal_decoder import CoCaMultimodalDecoder
from multimodal_tpu_torch.models.coca.text_decoder import CoCaTextDecoder
from multimodal_tpu_torch.modules.layers.attention_pooler import (
    AttentionPooler,
    CascadedAttentionPooler,
)
from multimodal_tpu_torch.utils import checkpoint as ckpt
from multimodal_tpu_torch.utils.checkpoint import state_dict_from_jax_tree

VOCAB, POS, IMG, B = 300, 40, 48, 3
CFG = dict(vision_patch_size=8, vision_dim_feedforward=128, vision_n_layer=2, vision_n_head=2,
           vocab_size=VOCAB, num_text_positions=POS, text_hidden_dim=64, text_n_layer=2,
           text_n_head=2, text_dim_feedforward=128, text_output_dim=64, fusion_n_layer=2,
           fusion_n_head=2, fusion_dim_feedforward=128, pooler_input_embed_dim=96,
           pooler_output_embed_dim=64, pooler_n_head=2, image_size=IMG,
           multimodal_output_projection_dim=VOCAB, pooler_n_queries=32)
ATOL = 3e-5
GRAD_REL = 2e-5


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, atol=ATOL):
    """Within ``atol`` of the output's largest element (the JAX init's text
    projection, normal at sqrt(width), makes pooled outputs of about 50)."""
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want,
                               atol=atol * max(1.0, float(np.abs(want).max())), rtol=1e-4)


def _batch(seed=0, b=B):
    r = np.random.RandomState(seed)
    images = r.randn(b, IMG, IMG, 3).astype(np.float32)
    texts = r.randint(1, VOCAB, (b, POS)).astype(np.int32)
    texts[1, 25:] = 0  # padding, past the flash path's 32-key tile too
    texts[b - 1, 7:] = 0
    return images, texts


def _random_params(shapes, seed):
    """Weights for a JAX parameter tree of ``jax.eval_shape`` structs, drawn
    with numpy (no JAX init to compile): fan-in scaled kernels, small
    biases and embeddings, LayerNorm scales near 1, unit-normal pooler
    queries, the contrastive temperature near its initial value."""
    r = np.random.RandomState(seed)

    def draw(path, s):
        name = getattr(path[-1], "key", "")
        x = r.standard_normal(s.shape).astype(np.float32)
        if name == "kernel":
            x /= np.sqrt(np.prod(s.shape[:-1]))
        elif name == "scale":
            x = 1.0 + 0.1 * x
        elif name == "logit_scale":
            x = np.float32(np.log(1 / 0.07)) + 0.1 * x
        elif name != "query":
            x *= 0.05
        return jnp.asarray(x)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _load(module, params):
    module.load_state_dict(state_dict_from_jax_tree(_np(params)), strict=True)
    return module


@pytest.fixture(scope="module")
def pretrain_setup():
    """JAX ``CoCaForPretraining`` (cascaded pooler), weights for it drawn
    with numpy and the port's copy. The module tests below apply the JAX
    submodules to subtrees of these weights."""
    images, texts = _batch()
    jm = jcoca.coca_for_pretraining(**CFG)
    params = _random_params(jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(images),
                                           jnp.asarray(texts))["params"], 1)
    tm = _load(tcoca.coca_for_pretraining(device="cpu", **CFG), params)
    return jm, params, tm, (images, texts)


def test_attention_poolers_match_jax(pretrain_setup):
    """Each stage alone (AttentionPooler) and the cascade."""
    _, params, _, _ = pretrain_setup
    p = params["model"]["vision_pooler"]
    x = np.random.RandomState(2).randn(B, 36, 96).astype(np.float32)
    one = _load(AttentionPooler(96, 64, 2, 32), p["poolers_0"])
    _close(one(_t(x)), jax.jit(JPooler(96, 64, 2, 32).apply)({"params": p["poolers_0"]},
                                                            jnp.asarray(x)))
    tm = _load(CascadedAttentionPooler([AttentionPooler(96, 64, 2, 32),
                                        AttentionPooler(64, 64, 2, 1)]), p)
    got = tm(_t(x))
    want = jax.jit(JCascaded([JPooler(96, 64, 2, 32), JPooler(64, 64, 2, 1)]).apply)(
        {"params": p}, jnp.asarray(x))
    assert [tuple(g.shape) for g in got] == [(B, 32, 64), (B, 1, 64)]
    assert [n for n, _ in tm.named_children()] == ["poolers_0", "poolers_1"]
    for g, w in zip(got, want):
        _close(g, w)


TEXT_KW = dict(vocab_size=VOCAB, num_positions=POS, embedding_dim=64, n_layer=2, n_head=2,
               dim_feedforward=128, output_dim=64)


@pytest.mark.parametrize("embed_cls", [True, False])
def test_text_decoder_matches_jax(pretrain_setup, embed_cls):
    """The mask (bool, causal AND key padding with the CLS column always
    open), the pooled output and the tokens; without the CLS token the
    pooled output is the EOT-argmax position's."""
    _, params, _, _ = pretrain_setup
    p = dict(params["model"]["text_decoder"])
    if not embed_cls:
        p["embeddings"] = {k: v for k, v in p["embeddings"].items() if k != "cls_embedding"}
    _, ids = _batch(8)
    jm = JText(embed_cls=embed_cls, **TEXT_KW)
    tm = _load(CoCaTextDecoder(embed_cls=embed_cls, **TEXT_KW), p)
    inp = ids[:, :-1] if embed_cls else ids
    mask_want = jm.apply({"params": p}, jnp.asarray(inp), method=JText.build_mask)
    apply = jax.jit(jm.apply)
    mask_got = tm.build_mask(_t(inp).long())
    assert mask_got.dtype == torch.bool
    np.testing.assert_array_equal(mask_got.numpy(), np.asarray(mask_want))
    if embed_cls:
        assert tuple(mask_got.shape) == (B, 1, POS, POS)
        assert bool(mask_got[1, 0, -1, -1]) and not bool(mask_got[1, 0, -1, 30])
    pooled, tokens = tm(_t(ids).long())
    want_pooled, want_tokens = apply({"params": p}, jnp.asarray(ids))
    _close(pooled, want_pooled)
    _close(tokens, want_tokens)


def test_multimodal_decoder_matches_jax(pretrain_setup):
    _, params, _, _ = pretrain_setup
    p = params["model"]["multimodal_decoder"]
    r = np.random.RandomState(11)
    texts = r.randn(B, POS - 1, 64).astype(np.float32)
    images = r.randn(B, 32, 64).astype(np.float32)
    kw = dict(input_seq_len=POS - 1, text_embedding_dim=64, n_layer=2, n_head=2,
              dim_feedforward=128, output_dim=VOCAB)
    got = _load(CoCaMultimodalDecoder(**kw), p)(_t(texts), _t(images))
    _close(got, jax.jit(JMulti(**kw).apply)({"params": p}, jnp.asarray(texts),
                                            jnp.asarray(images)))
    with pytest.raises(ValueError, match="expected text seq len"):
        CoCaMultimodalDecoder(**kw)(_t(texts[:, :5]), _t(images))


def test_multimodal_decoder_self_attention_is_causal_without_a_mask():
    """The fusion layers' self-attention gets ``is_causal`` and no mask (the
    kernels' causal route, not the dense causal bool on the bias lane);
    their cross-attention gets neither."""
    kw = dict(input_seq_len=8, text_embedding_dim=64, n_layer=2, n_head=2,
              dim_feedforward=128, output_dim=VOCAB)
    m = CoCaMultimodalDecoder(**kw)
    seen = []

    def hook(name):
        def record(_, args, kwargs):
            seen.append((name, kwargs.get("attn_mask"), kwargs.get("is_causal", False)))
        return record

    for layer in m.transformer_decoder.layers:
        layer.attention.register_forward_pre_hook(hook("self"), with_kwargs=True)
        layer.cross_attention.register_forward_pre_hook(hook("cross"), with_kwargs=True)
    m(torch.randn(B, 8, 64), torch.randn(B, 5, 64))
    assert [s[0] for s in seen] == ["self", "cross"] * 2
    assert all(mask is None for _, mask, _ in seen)
    assert [causal for _, _, causal in seen] == [True, False] * 2


@pytest.mark.parametrize("cascaded", [True, False])
def test_coca_model_matches_jax(pretrain_setup, cascaded):
    """``CoCaModel``'s three outputs with the cascaded pooler and with one
    pooler of ``n_queries + 1`` queries (token 0 contrastive)."""
    _, params, _, _ = pretrain_setup
    p = dict(params["model"])
    if not cascaded:
        stage = dict(p["vision_pooler"]["poolers_0"])
        extra = np.random.RandomState(19).randn(1, 64).astype(np.float32)
        stage["query"] = jnp.concatenate([jnp.asarray(extra), stage["query"]])
        p["vision_pooler"] = stage
    images, texts = _batch(14)
    tm = _load(tcoca.coca_vit(device="cpu", cascaded_pooler=cascaded, **CFG), p)
    got = tm(_t(images), _t(texts).long())
    want = jax.jit(jcoca.coca_vit(cascaded_pooler=cascaded, **CFG).apply)(
        {"params": p}, jnp.asarray(images), jnp.asarray(texts))
    assert tuple(got.multimodal_embeddings.shape) == (B, POS - 1, VOCAB)
    for name in ("image_pooled_output", "text_pooled_output", "multimodal_embeddings"):
        _close(getattr(got, name), getattr(want, name))


def test_coca_for_pretraining_losses_and_gradients_match_jax(pretrain_setup):
    jm, params, tm, (images, texts) = pretrain_setup

    def loss_fn(p):
        out = jm.apply({"params": p}, jnp.asarray(images), jnp.asarray(texts))
        return out["contrastive"] + out["captioning"], out

    (_, want), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    tm.zero_grad(set_to_none=True)
    got = tm(_t(images), _t(texts).long())
    (got["contrastive"] + got["captioning"]).backward()
    for k in ("contrastive", "captioning"):
        np.testing.assert_allclose(float(got[k].detach()), float(want[k]), rtol=1e-5,
                                   atol=1e-6)
    want_grads = state_dict_from_jax_tree(_np(grads))
    got_grads = {k: p.grad for k, p in tm.named_parameters()}
    assert sorted(got_grads) == sorted(want_grads)
    for k, w in want_grads.items():
        w = w.numpy()
        tol = GRAD_REL * max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(got_grads[k].numpy(), w, atol=tol, rtol=1e-4, err_msg=k)


def test_coca_for_pretraining_padding_mask_argument(pretrain_setup):
    """An explicit ``text_padding_mask`` of the full position table is cut
    like the ids, and gives what the mask derived from the pad ids gives."""
    _, _, tm, (images, texts) = pretrain_setup
    mask = texts != 0
    mask[0, -3:] = False  # an explicit mask may differ from the pad ids
    with torch.no_grad():
        got = tm(_t(images), _t(texts).long(), _t(mask))
        derived = tm(_t(images), _t(texts).long())
        texts_cut = texts.copy()
        texts_cut[0, -3:] = 0
        want = tm(_t(images), _t(texts_cut).long())
    assert float(got["contrastive"]) == float(want["contrastive"])
    assert float(got["contrastive"]) != float(derived["contrastive"])


def test_coca_model_with_heads_matches_jax(pretrain_setup):
    jm, params, tm, (images, texts) = pretrain_setup
    r = np.random.RandomState(17)
    head = {"kernel": jnp.asarray(r.randn(VOCAB, 7).astype(np.float32) * 0.05),
            "bias": jnp.asarray(r.randn(7).astype(np.float32))}
    jh = jcoca.CoCaModelWithHeads(model=jm.model, heads={"vqa": nn.Dense(7)})
    want = jax.jit(jh.apply)({"params": {"model": params["model"], "heads_vqa": head}},
                             jnp.asarray(images), jnp.asarray(texts))["vqa"]
    heads = tcoca.CoCaModelWithHeads(tm.model, {"vqa": torch.nn.Linear(VOCAB, 7)})
    heads.heads["vqa"].load_state_dict(state_dict_from_jax_tree(_np(head)))
    _close(heads(_t(images), _t(texts).long())["vqa"], want)


@pytest.mark.parametrize("builder", ["coca_vit_b_32", "coca_vit_l_14"])
def test_coca_builders_parameter_shapes_match_jax(builder, monkeypatch):
    """Every parameter of the full-size builders by name and shape: JAX's
    through ``jax.eval_shape``, carried by the path map as zero-stride views
    into meta tensors; the port's built on the meta device."""
    jm = getattr(jcoca, builder)()
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3)),
                            jnp.ones((1, 77), jnp.int32))
    monkeypatch.setattr(ckpt, "_t", lambda a: torch.empty(np.shape(a), device="meta"))
    views = jax.tree.map(lambda s: np.broadcast_to(np.float32(0), s.shape), shapes["params"])
    want = {k: tuple(v.shape) for k, v in ckpt.state_dict_from_jax_tree(views).items()}
    tm = getattr(tcoca, builder)(device="meta")
    got = {k: tuple(v.shape) for k, v in tm.state_dict().items()}
    assert got == want


def test_coca_builder_seeds_and_dtypes():
    """Weights are drawn on the CPU from the seed (the same seed, the same
    weights); ``param_dtype`` casts all but the LayerNorms and the
    temperature."""
    small = dict(CFG, vision_n_layer=1, text_n_layer=1, fusion_n_layer=1)
    a = tcoca.coca_for_pretraining(device="cpu", seed=3, **small)
    b = tcoca.coca_for_pretraining(device="cpu", seed=3, **small)
    c = tcoca.coca_for_pretraining(device="cpu", seed=4, **small)
    assert all(torch.equal(x, y) for x, y in zip(a.state_dict().values(),
                                                 b.state_dict().values()))
    assert not torch.equal(a.model.vision_proj.weight, c.model.vision_proj.weight)
    h = tcoca.coca_for_pretraining(device="cpu", dtype=torch.bfloat16,
                                   param_dtype=torch.float32, **small)
    assert all(p.dtype == torch.float32 for p in h.parameters())
    images, texts = _batch(18, 2)
    out = h(_t(images), _t(texts).long())
    assert all(torch.isfinite(v) for v in out.values())
    assert h.model(_t(images), _t(texts).long()).multimodal_embeddings.dtype == torch.bfloat16

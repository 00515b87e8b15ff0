"""The port's shared encoder stack held against the JAX package:
``MultiHeadSelfAttention`` (its fused route with a key-padding mask on the
key-bias lane, its split-head route, the probability taps),
``TransformerEncoder`` (pre- and post-norm, taps, remat), ``key_padding_bias``,
``BERTTextEmbeddings``, ``BERTTextEncoder`` and ``utils/attention.py``.

Weights are the JAX modules' own, initialised from a PRNG key and carried
into the port by path (``utils/checkpoint.py:state_dict_from_jax_tree``);
inputs come from a numpy seed. On the CPU the port's fused attention and
MLP run their plain versions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_tpu.modules.encoders.bert_text_encoder import bert_text_encoder as j_bert
from multimodal_tpu.modules.layers.multi_head_attention import MultiHeadSelfAttention as JMHSA
from multimodal_tpu.modules.layers.text_embedding import BERTTextEmbeddings as JEmb
from multimodal_tpu.modules.layers.transformer import TransformerEncoder as JEncoder
from multimodal_tpu.ops import fused_encoder as jfe
from multimodal_tpu.utils import attention as jattn
from multimodal_tpu_torch.modules.encoders.bert_text_encoder import bert_text_encoder
from multimodal_tpu_torch.modules.layers import multi_head_attention as tmha
from multimodal_tpu_torch.modules.layers.text_embedding import BERTTextEmbeddings
from multimodal_tpu_torch.modules.layers.transformer import StochasticDepth, TransformerEncoder
from multimodal_tpu_torch.ops import fused_encoder as tfe
from multimodal_tpu_torch.utils import attention as tattn
from multimodal_tpu_torch.utils.checkpoint import state_dict_from_jax_tree

# fp32 throughout: the same arithmetic in two frameworks, sums in another
# order (up to 256-term products, softmax over up to 24 keys).
ATOL = 2e-5


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _load(module: torch.nn.Module, params) -> torch.nn.Module:
    module.load_state_dict(state_dict_from_jax_tree(_np(params)["params"]), strict=True)
    return module


def _padding_mask(r, b, s):
    keep = r.rand(b, s) > 0.3
    keep[:, 0] = True  # every row keeps a visible key
    return keep


class _Recorder:
    """Wraps the layer's fused attention to record that the route ran."""

    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, *args):
        self.calls += 1
        return self.fn(*args)


@pytest.mark.parametrize("mask_kind", [None, "bool", "float"])
def test_mhsa_fused_route_matches_jax(mask_kind, monkeypatch):
    """No taps, no dropout: the port takes #1's route, a key-padding mask on
    its key-bias lane; held against the JAX layer on its XLA path and on its
    fused route (Pallas in interpret mode)."""
    r = np.random.RandomState(1)
    b, s, d, h = 2, 20, 128, 2
    x = r.randn(b, s, d).astype(np.float32)
    mask = None
    if mask_kind is not None:
        keep = _padding_mask(r, b, s)[:, None, None, :]
        mask = keep if mask_kind == "bool" else np.where(keep, 0.0, -1e9).astype(np.float32)
    jm = JMHSA(embed_dim=d, num_heads=h)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    jmask = None if mask is None else jnp.asarray(mask)
    want = np.asarray(jm.apply(params, jnp.asarray(x), attn_mask=jmask))
    monkeypatch.setenv("MMTPU_FORCE_FUSED_ENCODER", "1")
    want_fused = np.asarray(jm.apply(params, jnp.asarray(x), attn_mask=jmask))
    rec = _Recorder(tmha.fused_qkv_attention)
    monkeypatch.setattr(tmha, "fused_qkv_attention", rec)
    tm = _load(tmha.MultiHeadSelfAttention(d, h), params)
    got = tm(torch.from_numpy(x), attn_mask=None if mask is None else torch.from_numpy(mask))
    assert rec.calls == 1
    np.testing.assert_allclose(got.detach().numpy(), want, atol=ATOL)
    np.testing.assert_allclose(got.detach().numpy(), want_fused, atol=ATOL)


@pytest.mark.parametrize("causal", [False, True])
def test_mhsa_taps_take_split_route(causal, monkeypatch):
    """With the probabilities asked for, the split-head route: output and
    fp32 probabilities as the JAX layer's."""
    r = np.random.RandomState(2)
    b, s, d, h = 2, 24, 128, 4
    x = r.randn(b, s, d).astype(np.float32)
    keep = _padding_mask(r, b, s)[:, None, None, :]
    jm = JMHSA(embed_dim=d, num_heads=h)
    params = jm.init(jax.random.PRNGKey(1), jnp.asarray(x))
    want, want_p = jm.apply(params, jnp.asarray(x), attn_mask=jnp.asarray(keep),
                            is_causal=causal, return_attn_weights=True)
    rec = _Recorder(tmha.fused_qkv_attention)
    monkeypatch.setattr(tmha, "fused_qkv_attention", rec)
    tm = _load(tmha.MultiHeadSelfAttention(d, h), params)
    got, got_p = tm(torch.from_numpy(x), attn_mask=torch.from_numpy(keep), is_causal=causal,
                    return_attn_weights=True)
    assert rec.calls == 0
    assert got_p.shape == (b, h, s, s) and got_p.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=ATOL)
    np.testing.assert_allclose(got_p.detach().numpy(), np.asarray(want_p), atol=ATOL)


def test_mhsa_per_query_mask_takes_split_route(monkeypatch):
    """A per-query mask has no key-bias form: the split-head route."""
    r = np.random.RandomState(3)
    b, s, d, h = 2, 16, 128, 2
    x = r.randn(b, s, d).astype(np.float32)
    mask = r.rand(b, 1, s, s) > 0.3
    mask[..., 0] = True
    jm = JMHSA(embed_dim=d, num_heads=h)
    params = jm.init(jax.random.PRNGKey(2), jnp.asarray(x))
    want = np.asarray(jm.apply(params, jnp.asarray(x), attn_mask=jnp.asarray(mask)))
    rec = _Recorder(tmha.fused_qkv_attention)
    monkeypatch.setattr(tmha, "fused_qkv_attention", rec)
    tm = _load(tmha.MultiHeadSelfAttention(d, h), params)
    got = tm(torch.from_numpy(x), attn_mask=torch.from_numpy(mask))
    assert rec.calls == 0
    np.testing.assert_allclose(got.detach().numpy(), want, atol=ATOL)


@pytest.mark.parametrize("kind", ["bool", "float", "broadcast", "per_query", "int"])
def test_key_padding_bias_matches_jax(kind):
    r = np.random.RandomState(4)
    b, s = 3, 10
    keep = _padding_mask(r, b, s)
    mask = {
        "bool": keep[:, None, None, :],
        "float": np.where(keep, 0.0, -1e9).astype(np.float32)[:, None, None, :],
        "broadcast": keep[:1, None, None, :],
        "per_query": np.broadcast_to(keep[:, None, None, :], (b, 1, s, s)).copy(),
        "int": keep[:, None, None, :].astype(np.int32),
    }[kind]
    want = jfe.key_padding_bias(jnp.asarray(mask), b, s)
    got = tfe.key_padding_bias(torch.from_numpy(mask), b, s)
    if want is None:
        assert got is None
        return
    assert got.shape == (b, s) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _encoder_pair(norm_first, seed, n_layer=2, d=128, h=2, ff=256, final_eps=None,
                  remat=False):
    r = np.random.RandomState(seed)
    x = r.randn(2, 18, d).astype(np.float32)
    kw = dict(n_layer=n_layer, d_model=d, n_head=h, dim_feedforward=ff, activation="gelu",
              norm_first=norm_first, final_layer_norm_eps=final_eps)
    jm = JEncoder(**kw)
    params = jm.init(jax.random.PRNGKey(seed), jnp.asarray(x))
    tm = _load(TransformerEncoder(**kw, remat=remat), params)
    return jm, params, tm, x, r


@pytest.mark.parametrize("norm_first,final_eps", [(True, None), (False, None), (True, 1e-6)])
def test_transformer_encoder_matches_jax(norm_first, final_eps):
    """Last hidden state and every per-layer tap (hidden states before each
    layer and after the last, attention probabilities) with a key-padding
    mask."""
    jm, params, tm, x, r = _encoder_pair(norm_first, 5, final_eps=final_eps)
    keep = _padding_mask(r, 2, 18)[:, None, None, :]
    want = jm.apply(params, jnp.asarray(x), attention_mask=jnp.asarray(keep),
                    return_hidden_states=True, return_attn_weights=True)
    got = tm(torch.from_numpy(x), attention_mask=torch.from_numpy(keep),
             return_hidden_states=True, return_attn_weights=True)
    np.testing.assert_allclose(got.last_hidden_state.detach().numpy(),
                               np.asarray(want.last_hidden_state), atol=ATOL)
    assert len(got.hidden_states) == 3 and len(got.attentions) == 2
    for a, b in zip(got.hidden_states + got.attentions, want.hidden_states + want.attentions):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), atol=ATOL)


def test_transformer_encoder_grads_match_jax():
    """Every parameter's gradient and the input's, through the fused MLP's
    #4 route (few rows) and the attention taps, against ``jax.grad``."""
    jm, params, tm, x, _ = _encoder_pair(True, 6)

    def jloss(p, xx):
        out = jm.apply(p, xx, return_attn_weights=True)
        return jnp.sum(out.last_hidden_state ** 2) + jnp.sum(out.attentions[-1] ** 2)

    gp, gx = jax.grad(jloss, argnums=(0, 1))(params, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    out = tm(xt, return_attn_weights=True)
    ((out.last_hidden_state ** 2).sum() + (out.attentions[-1] ** 2).sum()).backward()
    want = state_dict_from_jax_tree(_np(gp)["params"])
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), atol=1e-4)
    for name, p in tm.named_parameters():
        w = want[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), w, atol=1e-4 * max(1.0, np.abs(w).max()),
                                   err_msg=name)


def test_transformer_encoder_remat_same_gradients():
    """``remat`` recomputes each layer in the backward: the same output and
    gradients as without it."""
    _, params, plain, x, _ = _encoder_pair(True, 7)
    remat = _load(TransformerEncoder(n_layer=2, d_model=128, n_head=2, dim_feedforward=256,
                                     activation="gelu", norm_first=True, remat=True), params)
    grads = []
    for m in (plain, remat):
        xt = torch.from_numpy(x).requires_grad_()
        out = m(xt, return_hidden_states=True)
        (out.last_hidden_state.sum() + out.hidden_states[1].pow(2).sum()).backward()
        grads.append([xt.grad] + [p.grad for p in m.parameters()])
    for a, b in zip(*grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)


@pytest.mark.parametrize("offset_pos_ids,token_types", [(False, False), (True, True)])
def test_bert_text_embeddings_match_jax(offset_pos_ids, token_types):
    r = np.random.RandomState(8)
    ids = r.randint(1, 100, (2, 12)).astype(np.int32)
    ids[1, 9:] = 0  # padding
    tt = r.randint(0, 2, (2, 12)).astype(np.int32) if token_types else None
    kw = dict(hidden_size=64, vocab_size=100, max_position_embeddings=32,
              offset_pos_ids=offset_pos_ids)
    jm = JEmb(**kw)
    params = jm.init(jax.random.PRNGKey(3), jnp.asarray(ids))
    want = jm.apply(params, jnp.asarray(ids),
                    token_type_ids=None if tt is None else jnp.asarray(tt))
    tm = _load(BERTTextEmbeddings(**kw), params)
    got = tm(torch.from_numpy(ids), token_type_ids=None if tt is None else torch.from_numpy(tt))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("explicit_mask", [False, True])
def test_bert_text_encoder_matches_jax(explicit_mask):
    """Padding tokens mask their keys in every layer (from the pad id, or
    from ``attention_mask``); post-norm layers, taps on."""
    r = np.random.RandomState(9)
    ids = r.randint(1, 200, (2, 16)).astype(np.int32)
    ids[0, 11:] = 0
    mask = (ids != 0).astype(np.int32) if explicit_mask else None
    kw = dict(hidden_size=128, num_hidden_layers=2, num_attention_heads=2,
              intermediate_size=256, dropout=0.0, vocab_size=200, max_position_embeddings=32)
    jm = j_bert(**kw)
    params = jm.init(jax.random.PRNGKey(4), jnp.asarray(ids))
    want = jm.apply(params, jnp.asarray(ids),
                    attention_mask=None if mask is None else jnp.asarray(mask),
                    return_hidden_states=True, return_attn_weights=True)
    tm = _load(bert_text_encoder(**kw), params)
    got = tm(torch.from_numpy(ids), attention_mask=None if mask is None else torch.from_numpy(mask),
             return_hidden_states=True, return_attn_weights=True)
    np.testing.assert_allclose(got.last_hidden_state.detach().numpy(),
                               np.asarray(want.last_hidden_state), atol=ATOL)
    for a, b in zip(got.attentions, want.attentions):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), atol=ATOL)


@pytest.mark.parametrize("ndim", [2, 3, 4])
def test_extended_attention_mask_matches_jax(ndim):
    r = np.random.RandomState(10)
    shape = {2: (2, 6), 3: (2, 6, 6), 4: (2, 3, 6, 6)}[ndim]
    m = (r.rand(*shape) > 0.4).astype(np.int32)
    np.testing.assert_array_equal(
        tattn.get_extended_attention_mask(torch.from_numpy(m)).numpy(),
        np.asarray(jattn.get_extended_attention_mask(jnp.asarray(m))))


def test_causal_and_combined_masks_match_jax():
    np.testing.assert_array_equal(tattn.get_causal_attention_mask(5, 7).numpy(),
                                  np.asarray(jattn.get_causal_attention_mask(5, 7)))
    r = np.random.RandomState(11)
    a, b = r.rand(2, 1, 5, 5) > 0.3, r.rand(1, 1, 1, 5) > 0.3
    np.testing.assert_array_equal(
        tattn.combine_masks(torch.from_numpy(a), None, torch.from_numpy(b)).numpy(),
        np.asarray(jattn.combine_masks(jnp.asarray(a), None, jnp.asarray(b))))
    assert tattn.combine_masks(None, None) is None


def test_stochastic_depth_drops_whole_rows():
    x = torch.ones(64, 3, 4)
    sd = StochasticDepth(0.5)
    assert torch.equal(sd(x, deterministic=True), x)
    y = sd(x, deterministic=False)
    rows = y.reshape(64, -1)
    assert all(torch.all(r == 0) or torch.all(r == 2.0) for r in rows)


def test_encoder_refuses_moe_and_context_parallelism():
    with pytest.raises(NotImplementedError, match="A4"):
        TransformerEncoder(2, 64, 2, 128, moe_num_experts=4)
    with pytest.raises(NotImplementedError, match="A4"):
        tmha.MultiHeadSelfAttention(64, 2, cp_axis_name="cp")

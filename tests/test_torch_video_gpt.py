"""The port's VideoGPT generation path (multimodal_tpu_torch/modules/layers/
position_embedding.py and attention.py, models/video_gpt/gpt.py and model.py,
utils/generate.py, serving/video_gpt_server.py, examples/mugen/
text_video_gpt.py) held against the JAX package at the JAX serving test's
widths (``video_gpt`` at (4, 8, 8) -> (2, 4, 4), d_model 24, 2 heads, 2
layers, ``VQVAE_SMALL``; to_logit random so greedy decoding is unique):

- ``BroadcastedPositionEmbedding`` (negative ids wrap) and the n-dim
  multi-head attention with a boolean mask and a head mask;
- the GPT's right-shifted causal forward logits to 1e-4 (fp32);
- ``GenerationUtil``'s greedy tokens (``top_k=1``) equal to the JAX
  sampler's on the first 16 steps (the JAX serving test's near-tie near
  step 20 lets later steps fork), and its decoded video;
- the serving adapter's teacher-forced logits equal to the GPT's, and with
  no mask the JAX adapter's (not causal); the
  server's greedy tokens equal to ``GenerationUtil``'s on the first 16
  steps with the bf16 and the int8 cache; ``decode_videos``;
- ``text_video_gpt`` at the slow JAX test's widths: logits, greedy tokens
  against the JAX sampler, the decoded shape and the host tokenizer.

Weights carried by ``video_gpt_state_dict_from_jax``; one JAX init for the
VideoGPT and one for the text model.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_tpu.examples.mugen.text_video_gpt import text_video_gpt as jax_text_video_gpt
from multimodal_tpu.models.video_gpt.model import video_gpt as jax_video_gpt
from multimodal_tpu.modules.layers import attention as jattn
from multimodal_tpu.modules.layers import position_embedding as jpe
from multimodal_tpu.transforms.clip_transform import CLIPBPETokenizer as JaxBPE
from multimodal_tpu.utils.generate import GenerationUtil as JaxGenerationUtil
from multimodal_tpu_torch.examples.mugen.text_video_gpt import text_video_gpt
from multimodal_tpu_torch.models.video_gpt.model import video_gpt
from multimodal_tpu_torch.modules.layers import attention as tattn
from multimodal_tpu_torch.modules.layers import position_embedding as tpe
from multimodal_tpu_torch.serving.video_gpt_server import (
    VideoGPTServer,
    VideoGPTServingAdapter,
    wrap_gpt_variables,
)
from multimodal_tpu_torch.utils.checkpoint import (
    state_dict_from_jax_tree,
    video_gpt_state_dict_from_jax,
)
from multimodal_tpu_torch.utils.generate import GenerationUtil
from tests.test_torch_mugen import _close, jit

VQVAE_SMALL = dict(encoder_hidden_dim=16, n_res_layers=1, attn_hidden_dim=16,
                   num_embeddings=32, embedding_dim=8, decoder_hidden_dim=16)
BPE = "tests/assets/clip_merges.bpe"


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port(model, variables):
    """Load the JAX variables; only the input VQ-VAE's decoder, which the
    JAX model never built, keeps the port's own weights."""
    missing, unexpected = model.load_state_dict(video_gpt_state_dict_from_jax(variables),
                                                strict=False)
    assert not unexpected
    assert all(k.startswith("in_tokenizer.decoder.") for k in missing), missing
    return model


def _init(jm, video, in_tokens, out_tokens):
    """The JAX model's ``init_weights`` init, compiled once (faster than
    running it op by op)."""
    return jit(lambda v, i, o: jm.init({"params": jax.random.PRNGKey(0),
                                        "vq": jax.random.PRNGKey(1)},
                                       v, v, i, o, method=type(jm).init_weights))(
        video, in_tokens, out_tokens)


def _random_to_logit(variables, seed=5):
    k = variables["params"]["to_logit"]["kernel"]
    variables["params"]["to_logit"]["kernel"] = 0.2 * np.random.RandomState(seed).randn(
        *k.shape).astype(np.float32)
    return variables


@pytest.fixture(scope="module")
def small_gpt():
    jm = jax_video_gpt(input_shape=(4, 8, 8), latent_shape=(2, 4, 4), d_model=24, n_head=2,
                       dropout=0.0, attn_dropout=0.0, num_decoder_layers=2,
                       vqvae_kwargs=VQVAE_SMALL)
    video = np.random.RandomState(0).rand(2, 4, 8, 8, 3).astype(np.float32)
    in_tokens = jnp.asarray(np.random.RandomState(1).randint(0, 32, (1, 8)))
    out_tokens = jnp.asarray(np.random.RandomState(2).randint(0, 32, (1, 8)))
    variables = _np(_init(jm, jnp.asarray(video), in_tokens, out_tokens))
    variables = _random_to_logit(variables)
    tm = _port(video_gpt(input_shape=(4, 8, 8), latent_shape=(2, 4, 4), d_model=24, n_head=2,
                         dropout=0.0, attn_dropout=0.0, num_decoder_layers=2,
                         vqvae_kwargs=VQVAE_SMALL, device="cpu"), variables)
    with torch.no_grad():
        in_ids = tm.encode(torch.from_numpy(video), "in").numpy()
    return jm, variables, tm, video, in_ids


def test_broadcasted_position_embedding_matches_jax():
    jm = jpe.BroadcastedPositionEmbedding((2, 3, 4), 24)
    ids = np.array([[0, 5, 23, -1, -24, 30], [7, 11, -5, 2, 47, 12]])
    v = _np(jm.init(jax.random.PRNGKey(0), jnp.asarray(ids)))
    tm = tpe.BroadcastedPositionEmbedding((2, 3, 4), 24)
    tm.load_state_dict(state_dict_from_jax_tree(v["params"]), strict=True)
    got = tm(torch.from_numpy(ids))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(jm.apply(v, jnp.asarray(ids))))
    assert tm.num_positions == 24
    with pytest.raises(ValueError, match="modulo"):
        tpe.BroadcastedPositionEmbedding((2, 3, 4), 20)
    t = np.array([0.0, 3.0, 17.0], np.float32)
    _close(tpe.SinusoidalPositionEmbeddings(7)(torch.from_numpy(t)),
           jpe.SinusoidalPositionEmbeddings(7).apply({}, jnp.asarray(t)), rel=1e-6)


def test_nd_attention_with_masks_matches_jax():
    """Self-attention over a (3, 4) latent with keys and values from a
    second input, a boolean mask whose rows differ per batch and head, and
    a head mask; and the axial module along each axis."""
    r = np.random.RandomState(3)
    q = r.randn(2, 3, 4, 16).astype(np.float32)
    kv = r.randn(2, 3, 4, 12).astype(np.float32)
    mask = r.rand(2, 2, 12, 12) > 0.3
    mask[..., 0] = True
    head_mask = np.array([1.0, 0.5], np.float32)[None, :, None, None]
    jm = jattn.MultiHeadAttention(dim_q=16, dim_kv=12, n_head=2)
    v = _np(jm.init(jax.random.PRNGKey(0), jnp.asarray(q), jnp.asarray(kv)))
    tm = tattn.MultiHeadAttention(16, 12, 2)
    tm.load_state_dict(state_dict_from_jax_tree(v["params"]), strict=True)
    want, want_p = jm.apply(v, jnp.asarray(q), jnp.asarray(kv), jnp.asarray(mask),
                            jnp.asarray(head_mask), return_attn_weights=True)
    got, got_p = tm(torch.from_numpy(q), torch.from_numpy(kv), torch.from_numpy(mask),
                    torch.from_numpy(head_mask), return_attn_weights=True)
    _close(got, want)
    _close(got_p, want_p)
    for axis in (0, 1):
        ja = jattn.MultiHeadAttention(dim_q=16, dim_kv=16, n_head=2,
                                      attn_module=jattn.AxialAttention(axis), add_bias=False)
        va = _np(ja.init(jax.random.PRNGKey(axis), jnp.asarray(q)))
        ta = tattn.MultiHeadAttention(16, 16, 2, attn_module=tattn.AxialAttention(axis),
                                      add_bias=False)
        ta.load_state_dict(state_dict_from_jax_tree(va["params"]), strict=True)
        _close(ta(torch.from_numpy(q)), ja.apply(va, jnp.asarray(q)))
    assert tattn.merge_multihead(tattn.split_multihead(torch.from_numpy(q[:, 0]), 2)).equal(
        torch.from_numpy(q[:, 0]))


def test_gpt_forward_logits_match_jax(small_gpt):
    jm, variables, tm, video, in_ids = small_gpt
    out_ids = np.random.RandomState(4).randint(0, 32, (2, 32))
    want = jm.apply(variables, in_tokens=jnp.asarray(in_ids), out_tokens=jnp.asarray(out_ids),
                    causal=True, right_shift=True)
    with torch.no_grad():
        got = tm(in_tokens=torch.from_numpy(in_ids), out_tokens=torch.from_numpy(out_ids),
                 causal=True, right_shift=True)
    np.testing.assert_array_equal(in_ids, np.asarray(
        jm.apply(variables, jnp.asarray(video), "in", method=type(jm).encode)))
    _close(got.logits, want.logits)
    # the output modality's logits mask: finfo.min on the input columns
    mask = np.zeros((64, 64), np.float32)
    mask[32:, 32:] = mask[:32, :32] = 1
    with torch.no_grad():
        masked = tm.logit_projection(got.decoder_output.last_hidden_states,
                                     torch.from_numpy(mask))
    _close(masked, jm.apply(variables, want.decoder_output.last_hidden_states, jnp.asarray(mask),
                            method=type(jm).logit_projection))
    # init_weights: both tokenizers' encoders, the output decoder, the stack
    ids = np.random.RandomState(5).randint(0, 32, (2, 8))
    want = jit(lambda v, x, i, o: jm.apply(v, x, x, i, o, method=type(jm).init_weights))(
        variables, jnp.asarray(video), jnp.asarray(ids), jnp.asarray(ids[::-1]))
    with torch.no_grad():
        got = tm.init_weights(torch.from_numpy(video), torch.from_numpy(video),
                              torch.from_numpy(ids), torch.from_numpy(ids[::-1].copy()))
    _close(got.logits, want.logits)


def _greedy(tm, video_or_ids, n_steps):
    return GenerationUtil(tm).sample(torch.as_tensor(video_or_ids), max_seq_len=n_steps,
                                     generator=torch.Generator().manual_seed(0), top_k=1)


def test_generation_util_greedy_matches_jax(small_gpt):
    jm, variables, tm, video, _ = small_gpt
    want = JaxGenerationUtil(jm, variables).sample(jnp.asarray(video), max_seq_len=32,
                                                   rng=jax.random.PRNGKey(7), top_k=1)
    got = _greedy(tm, video, 32)
    assert got.tokens.shape == (2, 32) and got.decoded.shape == (2, 4, 8, 8, 3)
    np.testing.assert_array_equal(got.tokens.numpy()[:, :16], np.asarray(want.tokens)[:, :16])
    # the VQ decoding of the JAX sampler's tokens
    with torch.no_grad():
        decoded = tm.decode(torch.tensor(np.asarray(want.tokens)))
    _close(decoded, want.decoded)


def test_adapter_logits_match_gpt_teacher_forced(small_gpt):
    """The adapter's next-token convention (the SOS row, the unshifted
    feed, per-modality position ids) reproduces the GPT's right-shifted
    logits position by position."""
    jm, variables, tm, video, in_ids = small_gpt
    num_in = tm.num_in_tokens
    fed_out = np.random.RandomState(3).randint(0, 32, 7)
    with torch.no_grad():
        ref = tm(in_tokens=torch.from_numpy(in_ids[:1]), out_tokens=torch.from_numpy(fed_out[None]),
                 causal=True, right_shift=True).logits[0]
        adapter = VideoGPTServingAdapter(tm, in_seq_len=in_ids.shape[1])
        seq = [num_in + tm.num_out_tokens] + in_ids[0].tolist() + (fed_out + num_in).tolist()
        n = len(seq)
        got, kvs = adapter(torch.tensor([seq]), attention_mask=torch.ones(n, n).tril().bool(),
                           use_cache=True)
    assert len(kvs) == 2 and kvs[0][0].shape == (1, 2, n, 12)
    _close(got[0, : ref.shape[0], num_in:], ref[:, num_in:])
    assert (got[0, :, :num_in] == torch.finfo(torch.float32).min).all()
    assert set(adapter.state_dict()) == set(wrap_gpt_variables(tm.state_dict()))


def test_adapter_without_mask_matches_jax(small_gpt):
    """Called with no mask and no cache index, the adapter attends over
    every fed token, as the JAX adapter does (its decoder is not causal:
    the engine always passes the mask or a cache index)."""
    from multimodal_tpu.serving.video_gpt_server import VideoGPTServingAdapter as JaxAdapter
    from multimodal_tpu.serving.video_gpt_server import (
        wrap_gpt_variables as jax_wrap_gpt_variables,
    )

    jm, variables, tm, _, in_ids = small_gpt
    num_in = tm.num_in_tokens
    fed_out = np.random.RandomState(6).randint(0, 32, 5)
    seq = np.array([[num_in + tm.num_out_tokens] + in_ids[1].tolist()
                    + (fed_out + num_in).tolist()])
    want, _ = JaxAdapter(jm, in_seq_len=in_ids.shape[1]).apply(
        jax_wrap_gpt_variables(variables), jnp.asarray(seq))
    with torch.no_grad():
        got, _ = VideoGPTServingAdapter(tm, in_seq_len=in_ids.shape[1])(torch.from_numpy(seq))
    _close(got[..., num_in:], np.asarray(want)[..., num_in:])


@pytest.mark.parametrize("cache_dtype", [torch.bfloat16, "int8"])
def test_server_matches_generation_util_greedy(small_gpt, cache_dtype):
    _, _, tm, video, in_ids = small_gpt
    want = _greedy(tm, video, 32).tokens.numpy()
    server = VideoGPTServer(tm, in_seq_len=in_ids.shape[1], n_slots=4, max_new_tokens=32,
                            cache_dtype=cache_dtype, device="cpu")
    for i, row in enumerate(in_ids):
        server.submit(row.tolist(), request_id=i)
    outs = {o.request_id: o.tokens for o in server.run()}
    for i in range(in_ids.shape[0]):
        assert outs[i][:16] == want[i].tolist()[:16], f"row {i} diverged"
        assert len(outs[i]) == 32 and all(0 <= t < 32 for t in outs[i])
    with pytest.raises(ValueError, match="exactly in_seq_len"):
        server.submit(in_ids[0, :-1].tolist())


def test_server_decode_videos_roundtrip(small_gpt):
    _, _, tm, _, in_ids = small_gpt
    server = VideoGPTServer(tm, in_seq_len=in_ids.shape[1], n_slots=2, device="cpu")
    server.submit(in_ids[0].tolist(), request_id=0)
    server.submit(in_ids[1].tolist(), request_id=1, temperature=1.0)
    outs = sorted(server.run(), key=lambda o: o.request_id)
    assert [len(o.tokens) for o in outs] == [32, 32]  # prod((2, 4, 4))
    assert all(0 <= t < 32 for o in outs for t in o.tokens)
    decoded = server.decode_videos(np.asarray([o.tokens for o in outs]))
    assert decoded.shape == (2, 4, 8, 8, 3) and torch.isfinite(decoded).all()
    with torch.no_grad():
        _close(decoded[0], tm.decode(torch.tensor([outs[0].tokens]))[0])


TEXT_WIDTHS = dict(text_seq_len=8, video_seq_len=4, resolution=8, downsample=(2, 2, 2),
                   d_model=24, n_head=2, dropout=0.0, attn_dropout=0.0, num_decoder_layers=2,
                   text_vocab_size=60)


def test_text_video_gpt_matches_jax():
    jm = jax_text_video_gpt(vqvae_kwargs=VQVAE_SMALL, **TEXT_WIDTHS)
    video = jnp.asarray(np.random.RandomState(0).rand(1, 4, 8, 8, 3).astype(np.float32))
    text = np.random.RandomState(1).randint(0, 60, (2, 8))
    out_tokens = jnp.asarray(np.random.RandomState(2).randint(0, 32, (1, 8)))
    variables = _np(_init(jm, video, jnp.asarray(text[:1]), out_tokens))
    variables = _random_to_logit(variables, seed=6)
    tm = text_video_gpt(vqvae_kwargs=VQVAE_SMALL, bpe_path=BPE, device="cpu", **TEXT_WIDTHS)
    tm.load_state_dict(video_gpt_state_dict_from_jax(variables), strict=True)

    out_ids = np.random.RandomState(3).randint(0, 32, (2, 32))
    want = jm.apply(variables, in_tokens=jnp.asarray(text), out_tokens=jnp.asarray(out_ids),
                    causal=True, right_shift=True)
    with torch.no_grad():
        got = tm(in_tokens=torch.from_numpy(text), out_tokens=torch.from_numpy(out_ids),
                 causal=True, right_shift=True)
    _close(got.logits, want.logits)

    want = JaxGenerationUtil(jm, variables).sample(jnp.asarray(text), max_seq_len=32,
                                                   rng=jax.random.PRNGKey(7), top_k=1)
    got = _greedy(tm, text, 32)
    np.testing.assert_array_equal(got.tokens.numpy()[:, :16], np.asarray(want.tokens)[:, :16])
    assert got.decoded.shape == (2, 4, 8, 8, 3) == want.decoded.shape

    prompts = ["mugen jumps over a gap and collects a coin", "a slime monster walks left"]
    ids = tm.in_tokenizer.tokenize_host(prompts)
    bpe = JaxBPE(BPE)
    for row, s in zip(ids, prompts):
        want_ids = bpe.encode(s)[:8]
        assert row.tolist() == want_ids + [0] * (8 - len(want_ids))
    with pytest.raises(ValueError, match="latent shape"):
        text_video_gpt(device="cpu", **{**TEXT_WIDTHS, "downsample": (2, 4, 4)},
                       vqvae_kwargs=VQVAE_SMALL)

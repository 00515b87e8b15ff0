"""The port's LM training path (multimodal_tpu_torch/examples/long_context/train.py,
data/packing.py, packed_next_token_loss, the decoder's remat and segment ids)
held against the JAX package's.

A tiny LongContextLM (2 layers, width 64, 2 heads, d_ff 256, vocab 128) at
sequence 64, so that attention takes the flash path (the port's plain
versions of kernels #6-#8 on the CPU), in fp32 on the CPU with the JAX
model's weights carried over by utils/checkpoint.py. The JAX gradients are
carried over the same way, so each parameter's gradient is compared by name.
Data come from numpy seeds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from multimodal_tpu.data import packing as jpacking
from multimodal_tpu.examples.long_context import train as jtrain
from multimodal_tpu.examples.long_context.model import LongContextLM as JaxLM
from multimodal_tpu.examples.long_context.model import next_token_loss as jax_loss
from multimodal_tpu.examples.long_context.model import (
    packed_next_token_loss as jax_packed_loss,
)
from multimodal_tpu_torch.data import packing as tpacking
from multimodal_tpu_torch.examples.long_context import train as ttrain
from multimodal_tpu_torch.examples.long_context.model import (
    LongContextLM,
    packed_next_token_loss,
)
from multimodal_tpu_torch.ops import attention as tattn
from multimodal_tpu_torch.utils.checkpoint import long_context_lm_state_dict_from_jax

CONFIG = dict(vocab_size=128, max_seq_len=128, n_layer=2, d_model=64, n_head=2,
              dim_feedforward=256)
SEQ = 64
# fp32 through two layers and back: the same arithmetic in two frameworks,
# sums in another order (the port's plain flash and fused-MLP versions
# against the JAX dense paths); relative to the largest value of each
# tensor (readings up to 1.6e-6; 6.4e-6 on the key bias, against the floor
# below).
RTOL = 1e-4


def _docs(n, seed, lo=5, hi=40):
    r = np.random.RandomState(seed)
    return [r.randint(1, CONFIG["vocab_size"], size=r.randint(lo, hi)).astype(np.int32)
            for _ in range(n)]


# --------------------------------------------------------------------------
# data: packing, token windows


@pytest.mark.parametrize("truncate", [True, False])
def test_pack_documents_matches_jax(truncate):
    docs = _docs(30, 0, 1, 90)
    want = jpacking.pack_documents(docs, SEQ + 1, truncate=truncate)
    got = tpacking.pack_documents(docs, SEQ + 1, truncate=truncate)
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    assert tpacking.packing_efficiency(got["segment_ids"]) == \
        jpacking.packing_efficiency(want["segment_ids"])


@pytest.mark.parametrize("drop_last", [False, True])
def test_packed_batches_match_jax(drop_last):
    docs = _docs(23, 1)
    want = list(jpacking.packed_batches(iter(docs), SEQ + 1, 3, drop_last=drop_last))
    got = list(tpacking.packed_batches(iter(docs), SEQ + 1, 3, drop_last=drop_last))
    assert len(got) == len(want) > 1
    for g, w in zip(got, want):
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])


def test_token_batches_and_synthetic_tokens_match_jax():
    np.testing.assert_array_equal(ttrain.synthetic_tokens(128, 5000, seed=3),
                                  jtrain.synthetic_tokens(128, 5000, seed=3))
    stream = ttrain.synthetic_tokens(128, 5000)
    want = jtrain.token_batches(jtrain.TokenWindowDataset(stream, SEQ), 4, seed=2)
    got = ttrain.token_batches(ttrain.TokenWindowDataset(stream, SEQ), 4, seed=2)
    assert len(ttrain.TokenWindowDataset(stream, SEQ)) == len(
        jtrain.TokenWindowDataset(stream, SEQ))
    for _ in range(3):
        np.testing.assert_array_equal(next(got)["tokens"], next(want)["tokens"])


def test_packed_document_batches_match_jax():
    want = jtrain.packed_document_batches(None, CONFIG["vocab_size"], SEQ, 2, seed=5)
    got = ttrain.packed_document_batches(None, CONFIG["vocab_size"], SEQ, 2, seed=5)
    for _ in range(3):
        w, g = next(want), next(got)
        assert g.keys() == w.keys()
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])


# --------------------------------------------------------------------------
# the model: loss and gradients


def _packed_batch(b=2, seed=6):
    """Rows of several short documents, with padding."""
    return next(tpacking.packed_batches(iter(_docs(12, seed)), SEQ + 1, b))


def _window_batch(b=2, seed=7):
    r = np.random.RandomState(seed)
    return {"tokens": r.randint(0, CONFIG["vocab_size"], size=(b, SEQ + 1)).astype(np.int32)}


def test_packed_next_token_loss_matches_jax():
    batch = _packed_batch(3)
    logits = np.random.RandomState(8).randn(3, SEQ, CONFIG["vocab_size"]).astype(np.float32)
    want = jax_packed_loss(jnp.asarray(logits), jnp.asarray(batch["tokens"][:, 1:]),
                           jnp.asarray(batch["segment_ids"]))
    got = packed_next_token_loss(torch.from_numpy(logits),
                                 torch.from_numpy(batch["tokens"][:, 1:]),
                                 torch.from_numpy(batch["segment_ids"]))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    # a row of padding only contributes nothing; all padding gives 0, not NaN
    seg = np.zeros_like(batch["segment_ids"])
    got = packed_next_token_loss(torch.from_numpy(logits),
                                 torch.from_numpy(batch["tokens"][:, 1:]), torch.from_numpy(seg))
    assert got.item() == 0.0


@pytest.fixture(scope="module")
def jax_model():
    model = JaxLM(**CONFIG)
    variables = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    return model, jax.tree_util.tree_map(np.asarray, variables)


def _port(variables, remat=False):
    model = LongContextLM(**CONFIG, remat=remat)
    model.load_state_dict(long_context_lm_state_dict_from_jax(variables), strict=True)
    return model


def _jax_loss_and_grads(model, variables, batch):
    tokens = jnp.asarray(batch["tokens"])
    packed = "segment_ids" in batch

    def loss_fn(v):
        kwargs = {}
        if packed:
            kwargs = dict(segment_ids=jnp.asarray(batch["segment_ids"][:, :-1]),
                          positions=jnp.asarray(batch["positions"][:, :-1]))
        logits = model.apply(v, tokens[:, :-1], **kwargs)
        if packed:
            return jax_packed_loss(logits, tokens[:, 1:], jnp.asarray(batch["segment_ids"]))
        return jax_loss(logits, tokens[:, 1:])

    loss, grads = jax.value_and_grad(loss_fn)(variables)
    return float(loss), long_context_lm_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, grads))


def _port_loss_and_grads(model, batch):
    trainer = ttrain.build_trainer(model)
    model.zero_grad(set_to_none=True)
    loss, _ = trainer.loss_fn(model, {k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    return loss.item(), {n: p.grad.clone() for n, p in model.named_parameters()}


@pytest.mark.parametrize("packed", [False, True], ids=["windows", "packed"])
def test_loss_and_every_gradient_match_jax(jax_model, packed):
    assert SEQ >= tattn.FLASH_MIN_SEQ  # attention takes the flash path
    model, variables = jax_model
    batch = _packed_batch() if packed else _window_batch()
    if packed:
        assert (batch["segment_ids"][:, :-1] > 1).any()  # rows hold several documents
    want_loss, want = _jax_loss_and_grads(model, variables, batch)
    got_loss, got = _port_loss_and_grads(_port(variables), batch)
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-5)
    assert got.keys() == want.keys()
    # The key projection's bias has an exact gradient of 0 (a shift shared
    # by every key leaves the softmax unchanged), so both sides hold only
    # rounding noise there: each tensor is held to at least a hundredth of
    # the largest gradient of the model.
    floor = 1e-2 * max(np.abs(w.numpy()).max() for w in want.values())
    for name, g in got.items():
        w = want[name].numpy()
        np.testing.assert_allclose(g.numpy(), w, atol=RTOL * max(np.abs(w).max(), floor),
                                   rtol=0, err_msg=name)


@pytest.mark.parametrize("packed", [False, True], ids=["windows", "packed"])
def test_remat_gives_the_same_gradients(jax_model, packed):
    _, variables = jax_model
    batch = _packed_batch() if packed else _window_batch()
    loss, grads = _port_loss_and_grads(_port(variables), batch)
    loss_r, grads_r = _port_loss_and_grads(_port(variables, remat=True), batch)
    assert loss_r == loss
    for name, g in grads.items():
        torch.testing.assert_close(grads_r[name], g, rtol=0, atol=0, msg=name)


def test_segment_ids_are_refused_with_a_cache(jax_model):
    _, variables = jax_model
    model = _port(variables)
    toks = torch.zeros((1, 4), dtype=torch.long)
    with pytest.raises(ValueError, match="segment_ids"):
        model(toks, segment_ids=torch.ones((1, 4), dtype=torch.int32), use_cache=True)


# --------------------------------------------------------------------------
# the optimizer: global-norm clipping + AdamW against optax


def _optax_tx():
    return optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(3e-4, weight_decay=0.1))


def test_clipped_adamw_matches_optax():
    """Three steps on given gradients of global norm 0.5, 3 and 0.9: only
    the second is clipped."""
    r = np.random.RandomState(9)
    params = {"a": r.randn(7, 5).astype(np.float32), "b": r.randn(11).astype(np.float32)}
    tparams = {k: torch.from_numpy(v.copy()).requires_grad_() for k, v in params.items()}
    opt = ttrain.ClipByGlobalNormAdamW(list(tparams.values()))
    tx = _optax_tx()
    state = tx.init(params)
    jparams = params
    for norm in (0.5, 3.0, 0.9):
        grads = {k: r.randn(*v.shape).astype(np.float32) for k, v in params.items()}
        total = np.sqrt(sum((g.astype(np.float64) ** 2).sum() for g in grads.values()))
        grads = {k: (g * (norm / total)).astype(np.float32) for k, g in grads.items()}
        updates, state = tx.update(grads, state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for k, t in tparams.items():
            t.grad = torch.from_numpy(grads[k].copy())
        opt.step()
        for k, t in tparams.items():
            np.testing.assert_allclose(t.detach().numpy(), np.asarray(jparams[k]), rtol=0,
                                       atol=1e-6, err_msg=f"{k} at norm {norm}")


def test_build_trainer_steps_match_optax(jax_model):
    """Three ``Trainer.fit`` steps of the recipe's trainer (clipping +
    AdamW, lr 3e-4, weight decay 0.1) on the tiny LM against optax applied
    to the same gradients; the tiny LM's gradients at these weights have a
    global norm above 1, so each step clips."""
    _, variables = jax_model
    model = _port(variables)
    trainer = ttrain.build_trainer(model)
    names = [n for n, _ in model.named_parameters()]
    params = {n: p.detach().numpy().copy() for n, p in model.named_parameters()}
    tx = _optax_tx()
    state = tx.init(params)
    norms = []
    for step in range(3):
        batch = _packed_batch(seed=20 + step) if step == 1 else _window_batch(seed=20 + step)
        _, grads = _port_loss_and_grads(model, batch)
        grads = {n: grads[n].numpy() for n in names}
        norms.append(float(np.sqrt(sum((g.astype(np.float64) ** 2).sum()
                                       for g in grads.values()))))
        updates, state = tx.update(grads, state, params)
        params = optax.apply_updates(params, updates)
        trainer.fit(model, [batch], 1)
        for n, p in model.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(params[n]), rtol=0,
                                       atol=1e-6, err_msg=f"{n} after step {step + 1}")
    assert trainer.step == 3
    assert min(norms) > 1.0, norms  # the clipping branch ran on every step

"""The port's continuous-batching engine (multimodal_tpu_torch/serving/engine.py)
held against the JAX package's InferenceEngine on the same tiny
LongContextLM (weights carried over by long_context_lm_state_dict_from_jax),
and the port's filter_logits_per_row against the JAX package's.

Greedy requests must give identical tokens, with a bf16 and with an int8
cache: more requests than slots (slots are reused), prompts in two length
buckets, an eos id and per-request max_new_tokens. The tiny model in fp32
agrees with the JAX one to about 1e-5 in its logits (test_torch_long_context_lm),
far below the gaps between its top two logits on these prompts.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_tpu.examples.long_context.model import LongContextLM as JaxLM
from multimodal_tpu.serving import InferenceEngine as JaxEngine
from multimodal_tpu.serving import Request as JaxRequest
from multimodal_tpu.utils.generate import filter_logits_per_row as jax_filter
from multimodal_tpu_torch.examples.long_context.model import LongContextLM
from multimodal_tpu_torch.serving.engine import InferenceEngine, Request
from multimodal_tpu_torch.utils.checkpoint import long_context_lm_state_dict_from_jax
from multimodal_tpu_torch.utils.generate import filter_logits_per_row

CONFIG = dict(vocab_size=256, max_seq_len=256, n_layer=2, d_model=128, n_head=4,
              dim_feedforward=512)
ENGINE = dict(n_slots=3, max_len=256, prefill_batch=2, decode_steps=4)


@pytest.fixture(scope="module")
def models():
    jax_model = JaxLM(**CONFIG)
    variables = jax.tree_util.tree_map(
        np.asarray, jax_model.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32)))
    port = LongContextLM(**CONFIG).eval()
    port.load_state_dict(long_context_lm_state_dict_from_jax(variables), strict=True)
    return jax_model, variables, port


def _requests():
    """7 greedy requests: prompts of 10-16 tokens (bucket 16) and 20-32
    (bucket 32), max_new_tokens 3-12; request 2 carries an eos id that its
    greedy path reaches (found below), so it stops early."""
    r = np.random.RandomState(0)
    out = []
    for i in range(7):
        n = int(r.randint(10, 17)) if i % 2 else int(r.randint(20, 33))
        out.append(dict(prompt=r.randint(0, 256, size=n).tolist(),
                        max_new_tokens=int(r.randint(3, 13)), request_id=i))
    return out


def _run_jax(jax_model, variables, cache_dtype, reqs):
    eng = JaxEngine(jax_model, variables, cache_dtype=cache_dtype, **ENGINE)
    for kw in reqs:
        eng.submit(JaxRequest(**kw))
    outs = eng.run()
    return {o.request_id: (o.tokens, o.finish_reason) for o in outs}, eng.stats()


def _run_port(port, cache_dtype, reqs):
    eng = InferenceEngine(port, cache_dtype=cache_dtype, device="cpu", **ENGINE)
    for kw in reqs:
        eng.submit(Request(**kw))
    outs = eng.run()
    return {o.request_id: (o.tokens, o.finish_reason) for o in outs}, eng.stats()


@pytest.mark.parametrize("cache", ["bfloat16", "int8"])
def test_greedy_tokens_match_jax(models, cache):
    jax_model, variables, port = models
    jdt = jnp.bfloat16 if cache == "bfloat16" else "int8"
    tdt = torch.bfloat16 if cache == "bfloat16" else "int8"
    reqs = _requests()
    first, _ = _run_port(port, tdt, reqs)
    # an eos id that request 2 reaches at its third token
    reqs[2]["eos_id"] = first[2][0][2]
    want, want_stats = _run_jax(jax_model, variables, jdt, reqs)
    got, got_stats = _run_port(port, tdt, reqs)
    assert got == want
    assert want[2][1] == "eos" and len(want[2][0]) <= 3
    assert got_stats == pytest.approx(want_stats)
    assert set(got_stats) == set(want_stats)
    assert got_stats["requests_finished"] == len(reqs) and got_stats["live_slots"] == 0


def test_sampled_requests_finish(models):
    """Temperature, top-k and top-p rows share the batch with greedy ones;
    sampled tokens cannot match JAX's generator, so only their counts and
    range are checked, and the greedy rows keep the tokens of an all-greedy
    run (which matches JAX above)."""
    _, _, port = models
    greedy, _ = _run_port(port, "int8", _requests())
    reqs = _requests()
    for i, kw in enumerate(reqs):
        if i % 3 == 1:
            kw.update(temperature=1.0, top_k=5 if i == 1 else None, top_p=0.9 if i == 4 else None)
    got, _ = _run_port(port, "int8", reqs)
    for kw in reqs:
        toks, reason = got[kw["request_id"]]
        assert reason == "length" and len(toks) == kw["max_new_tokens"]
        assert all(0 <= t < CONFIG["vocab_size"] for t in toks)
        if "temperature" not in kw:
            assert toks == greedy[kw["request_id"]][0]


def test_filter_logits_per_row_matches_jax():
    r = np.random.RandomState(3)
    logits = r.randn(6, 50).astype(np.float32)
    logits[5, :10] = 2.5  # ties at the top
    top_k = np.array([0, 1, 3, 10, 50, 4], np.int32)
    top_p = np.array([1.0, 0.9, 0.5, 0.3, 0.95, 1.0], np.float32)
    want = np.asarray(jax_filter(jnp.asarray(logits), jnp.asarray(top_k), jnp.asarray(top_p)))
    got = filter_logits_per_row(torch.from_numpy(logits), torch.from_numpy(top_k),
                                torch.from_numpy(top_p)).numpy()
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    np.testing.assert_allclose(np.where(np.isneginf(got), 0, got),
                               np.where(np.isneginf(want), 0, want), atol=0)


def test_submit_and_constructor_refuse_what_is_not_ported(models):
    _, _, port = models
    eng = InferenceEngine(port, device="cpu", **ENGINE)
    with pytest.raises(NotImplementedError, match="A5"):
        eng.submit(Request([1, 2], 3, adapter="x"))
    # ported since: a plain engine refuses requests that carry them
    for field in ("conditioning", "kv_prefix"):
        with pytest.raises(ValueError, match="required exactly when"):
            eng.submit(Request([1, 2], 3, **{field: torch.zeros(1)}))
    with pytest.raises(ValueError, match="unknown prefix"):
        eng.submit(Request([1, 2], 3, prefix="x"))
    with pytest.raises(NotImplementedError, match="A5"):
        eng.register_prefix("sys", [1, 2], adapter="a")
    with pytest.raises(ValueError, match="empty prefix"):
        eng.register_prefix("sys", [])
    eng.register_prefix("sys", [1, 2])
    with pytest.raises(ValueError, match=r"prefix\(2\) \+ prompt\(248\)"):
        eng.submit(Request([1] * 248, 7, prefix="sys"))
    with pytest.raises(ValueError, match="max_len"):
        eng.submit(Request([1] * 250, 7))
    with pytest.raises(ValueError, match="empty"):
        eng.submit(Request([], 3))
    for kw in (dict(prefill_chunk=16), dict(window=64), dict(sinks=4), dict(adapters={}),
               dict(draft_model=port)):
        with pytest.raises(NotImplementedError, match="A5"):
            InferenceEngine(port, device="cpu", **ENGINE, **kw)
    with pytest.raises(ValueError, match="int8"):
        InferenceEngine(port, device="cpu", cache_dtype=torch.int8, **ENGINE)


PREFIX = list(range(40, 52))  # 12 tokens


@pytest.mark.parametrize("cache", ["bfloat16", "int8"])
def test_registered_prefix_matches_prompt_with_prefix(models, cache):
    """Requests riding a registered prefix (its rows broadcast into each
    slot, int8 rows quantized as a prefill's are) give the tokens of the
    JAX engine's requests on the same prefix, and, with the bf16 cache, of
    the same prompts with the prefix written in; the outputs count the
    prefix in ``prompt_len``."""
    jax_model, variables, port = models
    jdt = jnp.bfloat16 if cache == "bfloat16" else "int8"
    tdt = torch.bfloat16 if cache == "bfloat16" else "int8"
    reqs = _requests()
    eng = InferenceEngine(port, cache_dtype=tdt, device="cpu", **ENGINE)
    eng.register_prefix("sys", PREFIX)
    jeng = JaxEngine(jax_model, variables, cache_dtype=jdt, **ENGINE)
    jeng.register_prefix("sys", PREFIX)
    for kw in reqs:
        eng.submit(Request(**kw, prefix="sys"))
        jeng.submit(JaxRequest(**kw, prefix="sys"))
    outs = eng.run()
    got = {o.request_id: o.tokens for o in outs}
    assert got == {o.request_id: o.tokens for o in jeng.run()}
    assert {o.request_id: o.prompt_len for o in outs} == {
        kw["request_id"]: len(PREFIX) + len(kw["prompt"]) for kw in reqs}
    if cache == "bfloat16":
        written, _ = _run_port(port, tdt, [{**kw, "prompt": PREFIX + kw["prompt"]}
                                           for kw in reqs])
        assert got == {i: toks for i, (toks, _) in written.items()}


def test_cancel(models):
    _, _, port = models
    eng = InferenceEngine(port, device="cpu", **ENGINE)
    reqs = [Request(list(range(1, 12)), 20, request_id=i) for i in range(5)]
    for q in reqs:
        eng.submit(q)
    eng.cancel(reqs[4])  # still queued: retires without a slot
    eng.step()
    eng.cancel(reqs[0])  # live: retires at its next collected token
    outs = {o.request_id: o for o in eng.run()}
    assert outs[4].finish_reason == "cancelled" and outs[4].tokens == []
    assert outs[0].finish_reason == "cancelled" and len(outs[0].tokens) < 20
    assert all(outs[i].finish_reason == "length" for i in (1, 2, 3))

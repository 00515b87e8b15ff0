"""The port's MDETR phrase-grounding path (multimodal_tpu_torch/models/mdetr,
modules/losses/mdetr.py, examples/mdetr) held against the JAX package at
small size: the ResNet backbone at ``resnet_layers=(1, 1, 1, 1)`` on padded
images whose sides 32 does not divide (features, and the mask by
``nearest``'s half-pixel centres), the sine position embedding, the
transformer and ``MDETRForPhraseGrounding`` at d_model 64 with 2 + 2 layers
and 4 heads (every text row of the encoder output, padded ones included),
``mdetr_loss`` (the Hungarian assignment equal, the loss to 1e-5, the
gradients in the predictions at cosine >= 0.9999), ``create_positive_map``,
the data module's batches, ``post_process_flickr`` and the Flickr30k
evaluator's recalls (equal), and the optimizer's learning rates and
updates for 5 steps against optax. Weights carried by
``mdetr_state_dict_from_jax``; JAX weights drawn with numpy onto
``jax.eval_shape``'s tree. fp32; outputs to 1e-4 of their largest element.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from multimodal_tpu.examples.mdetr import data as jdata
from multimodal_tpu.examples.mdetr import flickr_eval as jflickr
from multimodal_tpu.examples.mdetr import optimizer as jopt
from multimodal_tpu.examples.mdetr import postprocessors as jpost
from multimodal_tpu.models.mdetr import image_encoder as jimg
from multimodal_tpu.models.mdetr import model as jmodel
from multimodal_tpu.modules.losses import mdetr as jloss
from multimodal_tpu_torch.examples.mdetr import data as tdata
from multimodal_tpu_torch.examples.mdetr import flickr_eval as tflickr
from multimodal_tpu_torch.examples.mdetr import optimizer as topt
from multimodal_tpu_torch.examples.mdetr import postprocessors as tpost
from multimodal_tpu_torch.models.mdetr import image_encoder as timg
from multimodal_tpu_torch.models.mdetr import model as tmodel
from multimodal_tpu_torch.modules.losses import mdetr as tloss
from multimodal_tpu_torch.utils.checkpoint import mdetr_state_dict_from_jax
from tests.test_torch_mugen import _close, _draw, _np, jit

SMALL = dict(resnet_layers=(1, 1, 1, 1), embedding_dim=64, transformer_d_model=64,
             transformer_num_heads=4, transformer_encoder_layers=2, transformer_decoder_layers=2,
             transformer_dim_feedforward=128, num_queries=10, num_classes=31,
             text_encoder_kwargs=dict(num_hidden_layers=2, num_attention_heads=4,
                                      intermediate_size=128, vocab_size=120))


def _images(seed=0):
    """Two images padded to (70, 90): one fills it, one is 45 x 61; no side
    divides by 32."""
    r = np.random.RandomState(seed)
    images, mask = jmodel.pad_images([r.rand(70, 90, 3).astype(np.float32),
                                      r.rand(45, 61, 3).astype(np.float32)])
    return images, mask


def _text(seed=1):
    r = np.random.RandomState(seed)
    ids = [r.randint(3, 120, n).astype(np.int32) for n in (9, 5)]
    return jmodel.pad_text(ids)  # pad id 1, mask True = padded


@pytest.fixture(scope="module")
def grounding_setup():
    images, image_mask = _images()
    text, text_mask = _text()
    jm = jmodel.mdetr_for_phrase_grounding(contrastive_dim=16, **SMALL)
    args = tuple(map(jnp.asarray, (images, image_mask, text, text_mask)))
    params = _draw(jax.eval_shape(jm.init, jax.random.PRNGKey(0), *args), 2)
    params = jax.tree_util.tree_map_with_path(  # frozen statistics: positive variances
        lambda p, x: jnp.abs(x) + 0.5 if getattr(p[-1], "key", "") == "running_var" else x,
        params)
    tm = tmodel.mdetr_for_phrase_grounding(contrastive_dim=16, device="cpu", **SMALL)
    tm.load_state_dict(mdetr_state_dict_from_jax(_np(params)), strict=True)
    return jm, params, tm, (images, image_mask, text, text_mask)


def test_backbone_features_and_mask_match_jax(grounding_setup):
    jm, params, tm, (images, image_mask, _, _) = grounding_setup
    backbone = jimg.MaskedIntermediateLayer(jimg.ResNetBackbone(layers=(1, 1, 1, 1)))
    bp = {"params": params["params"]["model"]["image_backbone"]}
    want_feats, want_mask = jit(backbone.apply)(bp, jnp.asarray(images),
                                                    jnp.asarray(image_mask))
    with torch.no_grad():
        feats, mask = tm.model.image_backbone(torch.from_numpy(images),
                                              torch.from_numpy(image_mask))
    assert tuple(feats.shape) == want_feats.shape == (2, 3, 3, 2048)
    _close(feats, want_feats)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(want_mask))
    assert mask[1].any() and not mask[0].any()


@pytest.mark.parametrize("size", [(70, 90), (45, 61), (33, 97)])
def test_nearest_mask_resize_matches_jax(size):
    """Half-pixel centres at sizes 32 does not divide, against
    ``jax.image.resize(..., "nearest")``."""
    r = np.random.RandomState(3)
    mask = r.rand(2, *size) > 0.5
    out = (-(-size[0] // 32), -(-size[1] // 32) + 1)
    want = jax.image.resize(jnp.asarray(mask, jnp.float32)[..., None], (2, *out, 1),
                            "nearest")[..., 0] > 0.5
    got = timg.resize_mask_nearest(torch.from_numpy(mask), out)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("scale", [None, 2 * np.pi])
def test_position_embedding_matches_jax(scale):
    mask = np.zeros((2, 5, 7), bool)
    mask[1, 3:] = True
    mask[1, :, 4:] = True
    want = jit(functools.partial(jimg.position_embedding_2d, num_pos_feats=16,
                                     scale=scale))(jnp.asarray(mask))
    got = timg.position_embedding_2d(torch.from_numpy(mask), num_pos_feats=16, scale=scale)
    _close(got, want, rel=1e-6)


def test_phrase_grounding_matches_jax(grounding_setup):
    """Logits, boxes, every decoder state, the text rows of the encoder
    output (the padded ones too) and both contrastive embeddings."""
    jm, params, tm, batch = grounding_setup
    want = jit(jm.apply)(params, *map(jnp.asarray, batch))
    with torch.no_grad():
        got = tm(*map(torch.from_numpy, batch))
    for g, w in ((got.model_output.pred_logits, want.model_output.pred_logits),
                 (got.model_output.pred_boxes, want.model_output.pred_boxes),
                 (got.model_output.transformer_output.decoder_hidden_states,
                  want.model_output.transformer_output.decoder_hidden_states),
                 (got.model_output.transformer_output.text_memory,
                  want.model_output.transformer_output.text_memory)):
        assert tuple(g.shape) == w.shape
        _close(g, w)
    for k in ("query_embeddings", "token_embeddings"):
        _close(got.contrastive_embeddings[k], want.contrastive_embeddings[k])
    # the second caption's padded rows are there and count
    assert batch[3][1].sum() == 4


def _loss_inputs(seed=4, b=3, q=10, tokens=12, text_len=9, m=4):
    r = np.random.RandomState(seed)
    logits = r.standard_normal((b, q, tokens)).astype(np.float32)
    boxes = (0.2 + 0.6 * r.rand(b, q, 4)).astype(np.float32)
    qe = r.standard_normal((b, q, 8)).astype(np.float32)
    qe /= np.linalg.norm(qe, axis=-1, keepdims=True)
    te = r.standard_normal((b, text_len, 8)).astype(np.float32)
    te /= np.linalg.norm(te, axis=-1, keepdims=True)
    valid = np.zeros((b, m), bool)
    valid[0, :3] = valid[1, :1] = valid[2, :4] = True
    target = (0.2 + 0.5 * r.rand(b, m, 4)).astype(np.float32) * valid[..., None]
    pm = (r.rand(b, m, tokens) > 0.7).astype(np.float32) * valid[..., None]
    pm /= pm.sum(-1, keepdims=True) + 1e-6
    align = (r.rand(b, m, text_len) > 0.6).astype(np.float32) * valid[..., None]
    return logits, boxes, qe, te, pm, target, valid, align


def test_mdetr_loss_matches_jax():
    logits, boxes, qe, te, pm, target, valid, align = _loss_inputs()

    def jax_loss(logits, boxes, qe, te):
        out = jloss.mdetr_loss(logits, boxes, jnp.asarray(pm), jnp.asarray(target),
                               jnp.asarray(valid), qe, te, jnp.asarray(align))
        return out.total(), out

    (want_total, want), want_grads = jit(jax.value_and_grad(
        jax_loss, argnums=(0, 1, 2, 3), has_aux=True))(*map(jnp.asarray, (logits, boxes, qe, te)))
    want_assign = jloss.hungarian_assignment_np(np.asarray(jit(jax.vmap(
        jloss.hungarian_cost_matrix))(*map(jnp.asarray, (logits, boxes, pm, target)))), valid)

    inputs = [torch.from_numpy(x).requires_grad_() for x in (logits, boxes, qe, te)]
    cost = tloss.hungarian_cost_matrix(inputs[0], inputs[1], torch.from_numpy(pm),
                                       torch.from_numpy(target))
    np.testing.assert_array_equal(tloss.hungarian_matcher(cost, torch.from_numpy(valid)).numpy(),
                                  want_assign)
    got = tloss.mdetr_loss(*inputs[:2], torch.from_numpy(pm), torch.from_numpy(target),
                           torch.from_numpy(valid), *inputs[2:], torch.from_numpy(align))
    total = got.total()
    total.backward()
    for name in want._fields:
        np.testing.assert_allclose(getattr(got, name).item(), float(getattr(want, name)),
                                   rtol=1e-5, err_msg=name)
    np.testing.assert_allclose(total.item(), float(want_total), rtol=1e-5)
    g = np.concatenate([x.grad.numpy().ravel() for x in inputs])
    w = np.concatenate([np.asarray(x).ravel() for x in want_grads])
    assert g @ w / np.linalg.norm(g) / np.linalg.norm(w) >= 0.9999
    assert tloss.build_weight_dict(vqa_keys=("a",)) == jloss.build_weight_dict(vqa_keys=("a",))


@pytest.mark.parametrize("num_bins", [256, 3])
def test_create_positive_map_matches_jax(num_bins):
    text = "a man in a red shirt  throws a frisbee"
    ids, offsets = jdata.whitespace_tokenize_with_offsets(text)
    assert tdata.whitespace_tokenize_with_offsets(text) == (ids, offsets)
    spans = [[(2, 5)], [(11, 20), (0, 1)], [(30, 38)]]
    np.testing.assert_array_equal(tdata.create_positive_map(offsets, spans, num_bins),
                                  jdata.create_positive_map(offsets, spans, num_bins))


def test_datamodule_batches_match_jax(tmp_path):
    r = np.random.RandomState(5)
    samples = []
    for i, (h, w) in enumerate(((40, 50), (37, 61), (52, 33))):
        path = tmp_path / f"{i}.npy"
        np.save(path, r.randint(0, 256, (h, w, 3)).astype(np.uint8))
        n = i + 1
        samples.append({"image": str(path), "text": f"the dog {i} chases a ball near the tree",
                        "boxes": r.rand(n, 4).tolist(),
                        "tokens_positive": [[(0, 7)], [(19, 25)], [(31, 39)]][:n]})
    kw = dict(max_boxes=2, num_bins=16, text_len=6, batch_size=2, shuffle=False,
              drop_last=False)
    want = list(jdata.MDETRDataModule(samples, **kw).eval_batches())
    got = list(tdata.MDETRDataModule(samples, **kw).eval_batches())
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_array_equal(g[k].numpy(), w[k], err_msg=k)


def _flickr(tmp_path):
    """Two images' Sentences and Annotations in Flickr30k Entities' formats."""
    (tmp_path / "Sentences").mkdir()
    (tmp_path / "Annotations").mkdir()
    sentences = {
        "100": ["[/EN#1/people A man] throws [/EN#2/other a frisbee] .",
                "[/EN#1/people The man] plays in [/EN#3/scene the park] ."],
        "200": ["[/EN#5/animals Two dogs] run on [/EN#6/other the grass] ."],
    }
    boxes = {"100": {"1": [(10, 20, 60, 90)], "2": [(5, 5, 15, 18), (40, 40, 50, 52)]},
             "200": {"5": [(30, 10, 80, 70)], "6": [(0, 50, 100, 99)]}}
    for img, lines in sentences.items():
        (tmp_path / "Sentences" / f"{img}.txt").write_text("\n".join(lines) + "\n")
        objs = "".join(
            f"<object><name>{pid}</name><bndbox><xmin>{b[0]}</xmin><ymin>{b[1]}</ymin>"
            f"<xmax>{b[2]}</xmax><ymax>{b[3]}</ymax></bndbox></object>"
            for pid, bs in boxes[img].items() for b in bs)
        objs += ("<object><name>3</name><nobndbox>0</nobndbox><scene>1</scene></object>"
                 if img == "100" else "")
        (tmp_path / "Annotations" / f"{img}.xml").write_text(
            f"<annotation><size><width>100</width><height>100</height><depth>3</depth>"
            f"</size>{objs}</annotation>")
    (tmp_path / "test.txt").write_text("100\n200\n")
    # phrases with a box: image 100 has 2 + 1, image 200 has 2
    return [("100", 0, 2), ("100", 1, 1), ("200", 0, 2)]


@pytest.mark.parametrize("merge", [False, True])
def test_post_process_and_flickr_recalls_match_jax(tmp_path, merge):
    sents = _flickr(tmp_path)
    r = np.random.RandomState(6)
    b, q, c = len(sents), 10, 12
    logits = r.standard_normal((b, q, c)).astype(np.float32)
    boxes = (0.1 + 0.8 * r.rand(b, q, 4)).astype(np.float32)
    sizes = np.full((b, 2), 100.0, np.float32)
    phrases = [n for _, _, n in sents]
    pm = (r.rand(sum(phrases), c) > 0.6).astype(np.float32)
    want = jpost.post_process_flickr(jnp.asarray(logits), jnp.asarray(boxes),
                                     jnp.asarray(sizes), jnp.asarray(pm), phrases)
    got = tpost.post_process_flickr(torch.from_numpy(logits), torch.from_numpy(boxes),
                                    torch.from_numpy(sizes), torch.from_numpy(pm), phrases)
    np.testing.assert_allclose(np.asarray(sum(got, []), np.float64),
                               np.asarray(sum(want, []), np.float64), rtol=0, atol=1e-4)
    preds = [{"image_id": img, "sentence_id": s, "boxes": bx}
             for (img, s, _), bx in zip(sents, got)]
    want_recalls = jflickr.Flickr30kEntitiesRecallEvaluator(tmp_path, merge=merge).evaluate(preds)
    got_recalls = tflickr.Flickr30kEntitiesRecallEvaluator(tmp_path, merge=merge).evaluate(preds)
    assert got_recalls == want_recalls


@pytest.mark.parametrize("schedule", ["step", "multistep", "linear_with_warmup",
                                      "all_linear_with_warmup"])
def test_optimizer_rates_and_updates_match_optax(schedule):
    """Five AdamW steps on a backbone / text encoder / head tree: each
    group's rate and the parameters against optax's multi_transform."""
    kw = dict(schedule=schedule, lr=1e-4, lr_backbone=1e-5, text_encoder_lr=5e-5,
              num_training_steps=6, steps_per_epoch=1, lr_drop=2, epochs=120,
              fraction_warmup_steps=0.4)
    js, ts = jopt.mdetr_lr_schedules(**kw), topt.mdetr_lr_schedules(**kw)
    r = np.random.RandomState(7)
    init = {g: {"w": r.standard_normal((3, 4)).astype(np.float32)}
            for g in ("image_backbone", "text_encoder", "head")}
    grads = [{g: {"w": r.standard_normal((3, 4)).astype(np.float32)} for g in init}
             for _ in range(5)]
    tx = jopt.build_mdetr_optimizer(init, js)
    params = jax.tree.map(jnp.asarray, init)
    state = tx.init(params)

    def update(grad, state, params):
        updates, state = tx.update(grad, state, params)
        return optax.apply_updates(params, updates), state


    module = torch.nn.Module()
    for g, p in init.items():
        sub = torch.nn.Module()
        sub.w = torch.nn.Parameter(torch.from_numpy(p["w"].copy()))
        module.add_module(g, sub)
    opt, sched = topt.build_mdetr_optimizer(module, ts)
    rates = {group["name"]: [] for group in opt.param_groups}
    for step, grad in enumerate(grads):
        params, state = update(jax.tree.map(jnp.asarray, grad), state, params)
        for group in opt.param_groups:
            rates[group["name"]].append(group["lr"])
        for g, sub in module.named_children():
            sub.w.grad = torch.from_numpy(grad[g]["w"])
        opt.step()
        sched.step()
    for name, got in rates.items():
        want = [float(getattr(js, name)(s)) for s in range(5)]
        np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=name)
    for g, sub in module.named_children():
        np.testing.assert_allclose(sub.w.detach().numpy(), np.asarray(params[g]["w"]),
                                   rtol=1e-5, atol=1e-7)
    assert topt.mdetr_param_labels(module) == {
        "image_backbone.w": "backbone", "text_encoder.w": "text_encoder", "head.w": "rest"}

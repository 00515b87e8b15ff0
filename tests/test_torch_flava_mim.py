"""The dVAE codebook, MIM and the rest of the FLAVA model in the port
(``models/flava/{dalle_vae,image_encoder,model}.py``) held against the JAX
package at the debug config's widths (``examples/flava/configs/debug.yaml``:
width 32, 2 layers a tower, image 32 with patch 8, so the codebook sees 32
pixels and gives a 4 x 4 grid of labels).

The JAX model is initialised with ``image_for_codebook`` (so it has its
dVAE), carried into the port by ``flava_state_dict_from_jax`` and fed
seeded numpy batches of the three kinds the losses take: image-text (ITM,
MMM text, MMM image with codebook labels, contrastive), image-only (MIM)
and text-only (MLM): the six FLAVA objectives.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_tpu.models.flava.dalle_vae import DalleVAEEncoder as JDalle
from multimodal_tpu.models.flava.image_encoder import ImageEmbeddings as JImageEmbeddings
from multimodal_tpu.models.flava.model import (
    flava_model_for_classification as j_classification,
)
from multimodal_tpu.models.flava.model import flava_model_for_pretraining as j_pretraining
from multimodal_tpu_torch.models.flava.dalle_vae import DalleVAEEncoder
from multimodal_tpu_torch.models.flava.image_encoder import (
    ImageEmbeddings,
    ImageTransformerWithVAE,
    flava_image_encoder,
)
from multimodal_tpu_torch.models.flava.model import (
    flava_model_for_classification,
    flava_model_for_pretraining,
)
from multimodal_tpu_torch.utils.checkpoint import (
    dalle_state_dict_from_jax,
    flava_state_dict_from_jax,
    state_dict_from_jax_tree,
)

DEBUG = dict(
    image_hidden_size=32, image_num_hidden_layers=2, image_num_attention_heads=2,
    image_intermediate_size=64, text_hidden_size=32, text_num_hidden_layers=2,
    text_num_attention_heads=2, text_intermediate_size=64, multimodal_hidden_size=32,
    multimodal_num_hidden_layers=2, multimodal_num_attention_heads=2,
    multimodal_intermediate_size=64, text_and_image_proj_size=24, max_position_embeddings=32,
)
B, TEXT, VOCAB = 4, 16, 1000


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _batches():
    r = np.random.RandomState(21)
    text = r.randint(1000 // 2, VOCAB, (B, TEXT)).astype(np.int32)
    mlm = np.where(r.rand(B, TEXT) < 0.3, text, -1).astype(np.int32)
    masked = np.where(mlm >= 0, 103, text).astype(np.int32)
    mask = (r.rand(B, 4, 4) < 0.4).astype(np.int64)
    mask[:, 0, 0] = 1  # every row has a masked patch
    image = r.rand(B, 32, 32, 3).astype(np.float32)
    codebook = (0.1 + 0.8 * r.rand(B, 32, 32, 3)).astype(np.float32)  # map_pixels' range
    itm = np.array([1, 0, 1, 1], np.int32)
    return {
        "vl": dict(image=image, text=text, text_masked=masked, mlm_labels=mlm, itm_labels=itm,
                   image_for_codebook=codebook, image_patches_mask=mask),
        "image": dict(image=image, image_for_codebook=codebook, image_patches_mask=mask),
        "text": dict(text=text, text_masked=masked, mlm_labels=mlm),
    }


LOSSES = {"vl": ["itm_loss", "mmm_text_loss", "mmm_image_loss", "global_contrastive_loss"],
          "image": ["mim_loss"], "text": ["mlm_loss"]}


@pytest.fixture(scope="module")
def pretraining():
    """JAX parameters (dVAE included) and each batch kind's losses in fp32
    and bf16 compute, and the image-only batch's gradients in fp32."""
    batches = _batches()
    out = {"batches": batches}
    for name, dtype in (("fp32", jnp.float32), ("bf16", jnp.bfloat16)):
        jm = j_pretraining(vocab_size=VOCAB, image_size=32, patch_size=8, dtype=dtype, **DEBUG)
        if name == "fp32":
            vl = {k: jnp.asarray(v) for k, v in batches["vl"].items()}
            params = jax.jit(jm.init)(jax.random.PRNGKey(0), **vl)
            out["params"] = _np(params)
        params = out["params"]
        losses = {}

        def run(p, batch):
            res = jm.apply(p, **batch).losses
            out = {k: v for k, v in res._asdict().items() if v is not None}
            return {**out, "total": res.total()}

        for kind, batch in batches.items():
            res = jax.jit(run)(params, {k: jnp.asarray(v) for k, v in batch.items()})
            losses[kind] = {k: np.asarray(v, np.float32) for k, v in res.items()}
        out[name] = losses
        if name == "fp32":
            image = {k: jnp.asarray(v) for k, v in batches["image"].items()}
            out["image_grads"] = _np(jax.jit(jax.grad(
                lambda p: jm.apply(p, **image).losses.total()))(params))
    return out


def _port(params, dtype=torch.float32):
    tm = flava_model_for_pretraining(device="cpu", dtype=dtype, param_dtype=torch.float32,
                                     vocab_size=VOCAB, image_size=32, patch_size=8, **DEBUG)
    tm.load_state_dict(flava_state_dict_from_jax(params), strict=True)
    return tm


def test_flava_state_dict_covers_the_codebook(pretraining):
    """A JAX tree with the dVAE maps onto every port parameter, the dVAE's
    through ``dalle_state_dict_from_jax``; the codebook is frozen."""
    sd = flava_state_dict_from_jax(pretraining["params"])
    tm = _port(pretraining["params"])
    assert set(sd) == set(tm.state_dict())
    dalle = dalle_state_dict_from_jax(pretraining["params"]["params"]["image_codebook"])
    for k, v in dalle.items():
        assert torch.equal(sd[f"image_codebook.{k}"], v), k
    assert not any(p.requires_grad for p in tm.image_codebook.parameters())


@pytest.mark.parametrize("kind,name", [(k, n) for k in LOSSES for n in LOSSES[k] + ["total"]])
def test_six_losses_match_jax_fp32(kind, name, pretraining):
    """Each loss of each batch kind, fp32: the codebook labels are exactly
    the JAX ones here, so MIM and MMM-image see the same targets."""
    tm = _port(pretraining["params"])
    batch = {k: torch.from_numpy(v) for k, v in pretraining["batches"][kind].items()}
    with torch.no_grad():
        losses = tm(**batch).losses
    want = pretraining["fp32"][kind]
    assert set(want) == set(LOSSES[kind]) | {"total"}
    got = losses.total() if name == "total" else getattr(losses, name)
    np.testing.assert_allclose(got.numpy(), want[name], rtol=1e-5, atol=2e-5)


@pytest.mark.parametrize("kind", list(LOSSES))
def test_six_losses_match_jax_bf16(kind, pretraining):
    """bf16 compute over fp32 weights on both sides: each loss within 3% of
    the JAX one (bf16 rounds differently through a different op order; a
    near-tie among the 8,192 codebook logits can move a label)."""
    tm = _port(pretraining["params"], torch.bfloat16)
    batch = {k: torch.from_numpy(v) for k, v in pretraining["batches"][kind].items()}
    with torch.no_grad():
        losses = tm(**batch).losses
    want = pretraining["bf16"][kind]
    for name in LOSSES[kind] + ["total"]:
        got = (losses.total() if name == "total" else getattr(losses, name)).float().numpy()
        np.testing.assert_allclose(got, want[name], rtol=3e-2, atol=1e-2, err_msg=name)


def test_mim_gradients_match_jax(pretraining):
    """The image-only (MIM) step's parameter gradients against ``jax.grad``,
    each within 1e-4 of its tensor's scale; the frozen codebook gets none
    (zeros under JAX's ``stop_gradient``)."""
    tm = _port(pretraining["params"])
    batch = {k: torch.from_numpy(v) for k, v in pretraining["batches"]["image"].items()}
    tm(**batch).losses.total().backward()
    want = flava_state_dict_from_jax(pretraining["image_grads"])
    checked = 0
    for n, p in tm.named_parameters():
        w = want[n].numpy()
        if p.grad is None:
            assert not w.any(), n
            continue
        np.testing.assert_allclose(p.grad.numpy(), w, atol=1e-4 * max(np.abs(w).max(), 1e-3),
                                   err_msg=n)
        checked += 1
    assert checked > 20
    assert all(p.grad is None for p in tm.image_codebook.parameters())


@pytest.fixture(scope="module")
def dalle():
    x = (0.1 + 0.8 * np.random.RandomState(4).rand(3, 32, 40, 3)).astype(np.float32)
    jm = JDalle()
    params = jax.jit(jm.init)(jax.random.PRNGKey(1), jnp.asarray(x))
    logits = jm.apply(params, jnp.asarray(x), method=lambda m, v: m.encoder(v))
    labels = jm.apply(params, jnp.asarray(x))
    probs = jm.apply(params, jnp.asarray(x), method=lambda m, v: m.get_codebook_probs(v))
    tm = DalleVAEEncoder()
    tm.load_state_dict(dalle_state_dict_from_jax(_np(params)), strict=True)
    return dict(x=x, logits=np.asarray(logits), labels=np.asarray(labels),
                probs=np.asarray(probs), model=tm, params=_np(params))


def test_dalle_logits_match_jax(dalle):
    """fp32 logits (b, h/8, w/8, 8192) at rtol 1e-4 of their scale."""
    with torch.no_grad():
        got = dalle["model"].encoder(torch.from_numpy(dalle["x"])).numpy()
    want = dalle["logits"]
    assert got.shape == want.shape == (3, 4, 5, 8192)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


def test_dalle_labels_equal_jax(dalle):
    """fp32 codebook indices exactly equal; probabilities at 1e-5."""
    x = torch.from_numpy(dalle["x"])
    np.testing.assert_array_equal(dalle["model"](x).numpy(), dalle["labels"])
    np.testing.assert_allclose(dalle["model"].get_codebook_probs(x).numpy(), dalle["probs"],
                               atol=1e-5)


def test_dalle_state_dict_from_jax(dalle):
    """By path: ``group_4_block_1.id_path.conv.kernel`` (HWIO) ->
    ``encoder.group_4_block_1.id_path.conv.weight`` (OIHW); no id_path where
    the width does not change."""
    sd = dalle_state_dict_from_jax(dalle["params"])
    enc = dalle["params"]["params"]["encoder"]
    np.testing.assert_array_equal(
        sd["encoder.group_4_block_1.id_path.conv.weight"].numpy(),
        enc["group_4_block_1"]["id_path"]["conv"]["kernel"].transpose(3, 2, 0, 1))
    assert "encoder.group_1_block_1.id_path.conv.weight" not in sd
    assert sd["encoder.output_conv.conv.weight"].shape == (8192, 2048, 1, 1)


def test_dalle_label_grid_in_bf16(dalle):
    """bf16 compute: the logits' cosine to fp32 is at least 0.999 and most
    labels agree (argmax over 8,192 logits flips on near-ties)."""
    x = torch.from_numpy(dalle["x"])
    bf = DalleVAEEncoder(dtype=torch.bfloat16)
    bf.load_state_dict(dalle["model"].state_dict())
    with torch.no_grad():
        got = bf.encoder(x).float().flatten()
    want = torch.from_numpy(dalle["logits"].copy()).flatten()
    assert float(torch.nn.functional.cosine_similarity(got, want, dim=0)) >= 0.999
    assert (bf(x).numpy() == dalle["labels"]).mean() >= 0.5


def test_image_transformer_with_vae_labels(dalle):
    """Labels are the codebook indices where the mask is set, -1 elsewhere;
    the transformer's outputs are those of the plain image transformer."""
    enc = flava_image_encoder(hidden_size=32, num_attention_heads=2, num_hidden_layers=1,
                              intermediate_size=64, image_size=32, patch_size=8,
                              use_image_masking=True)
    model = ImageTransformerWithVAE(enc, dalle["model"])
    x = torch.from_numpy(dalle["x"][:, :, :32])
    mask = torch.from_numpy((np.random.RandomState(2).rand(3, 4, 4) < 0.5).astype(np.int64))
    with torch.no_grad():
        out = model(x, image_patches_mask=mask)
        plain = enc(x, image_patches_mask=mask)
    want = np.where(mask.reshape(3, -1).numpy() == 1, dalle["model"](x).reshape(3, -1).numpy(),
                    -1)
    np.testing.assert_array_equal(out.image_labels.numpy(), want)
    assert torch.equal(out.last_hidden_state, plain.last_hidden_state)


@pytest.mark.parametrize("size", [48, 16, 40])
def test_position_interpolation_matches_jax(size):
    """``interpolate_pos_encoding`` at another grid (6 x 6, 2 x 2, 5 x 5 from
    the model's 4 x 4): the JAX ``jax.image.resize`` cubic resample of
    random position embeddings, fp32 to 1e-5."""
    r = np.random.RandomState(size)
    x = r.rand(2, size, size, 3).astype(np.float32)
    jm = JImageEmbeddings(image_size=32, patch_size=8, hidden_size=16)
    params = _np(jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3))))
    params["params"]["position_embeddings"] = r.randn(1, 17, 16).astype(np.float32)
    params["params"]["cls_token"] = r.randn(1, 1, 16).astype(np.float32)
    want = jm.apply(params, jnp.asarray(x), interpolate_pos_encoding=True)
    tm = ImageEmbeddings(image_size=32, patch_size=8, hidden_size=16, use_image_masking=False)
    tm.load_state_dict(state_dict_from_jax_tree(params["params"]), strict=True)
    with torch.no_grad():
        got = tm(torch.from_numpy(x), interpolate_pos_encoding=True)
    assert got.shape == ((2, (size // 8) ** 2 + 1, 16))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    with pytest.raises(ValueError, match="doesn't match"):
        tm(torch.from_numpy(x))


def _load_classification(tm, params):
    """The JAX classifier never masks an image, so its tree has no image
    mask token; every other parameter maps."""
    res = tm.load_state_dict(flava_state_dict_from_jax(params), strict=False)
    assert res.unexpected_keys == []
    assert res.missing_keys == ["model.image_encoder.embeddings.mask_token"]


@pytest.fixture(scope="module")
def classification():
    r = np.random.RandomState(8)
    batch = dict(image=r.rand(B, 32, 32, 3).astype(np.float32),
                 text=r.randint(1, VOCAB, (B, TEXT)).astype(np.int32),
                 labels=np.array([0, 1, 2, 1], np.int32))
    jm = j_classification(num_classes=3, classifier_in_dim=32, classifier_hidden_sizes=32,
                          vocab_size=VOCAB, image_size=32, patch_size=8, **DEBUG)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    params = jax.jit(jm.init)(jax.random.PRNGKey(3), **jb)
    out = jm.apply(params, **jb)
    return dict(batch=batch, params=_np(params), logits=np.asarray(out.logits),
                loss=np.asarray(out.loss))


def test_classification_matches_jax(classification):
    """``FLAVAForClassification``: the MLP head over the multimodal CLS,
    logits and cross entropy against the JAX model, fp32."""
    tm = flava_model_for_classification(num_classes=3, classifier_in_dim=32,
                                        classifier_hidden_sizes=32, device="cpu",
                                        vocab_size=VOCAB, image_size=32, patch_size=8, **DEBUG)
    _load_classification(tm, classification["params"])
    batch = {k: torch.from_numpy(v) for k, v in classification["batch"].items()}
    with torch.no_grad():
        out = tm(**batch)
    np.testing.assert_allclose(out.logits.numpy(), classification["logits"], atol=2e-5)
    np.testing.assert_allclose(out.loss.numpy(), classification["loss"], atol=2e-5)
    with torch.no_grad():
        bare = tm(image=batch["image"], text=batch["text"])
    assert bare.loss is None and torch.equal(bare.logits, out.logits)


@pytest.mark.parametrize("which", ["image", "text"])
def test_classification_over_one_tower(which, classification):
    """``required_embedding`` picks the image or the text tower's CLS."""
    tm = flava_model_for_classification(num_classes=3, classifier_in_dim=32,
                                        classifier_hidden_sizes=32, device="cpu",
                                        vocab_size=VOCAB, image_size=32, patch_size=8, **DEBUG)
    _load_classification(tm, classification["params"])
    jm = j_classification(num_classes=3, classifier_in_dim=32, classifier_hidden_sizes=32,
                          vocab_size=VOCAB, image_size=32, patch_size=8, **DEBUG)
    batch = classification["batch"]
    inputs = {which: batch[which]}
    want = jm.apply(classification["params"], required_embedding=which,
                    labels=jnp.asarray(batch["labels"]),
                    **{k: jnp.asarray(v) for k, v in inputs.items()})
    with torch.no_grad():
        got = tm(required_embedding=which, labels=torch.from_numpy(batch["labels"]),
                 **{k: torch.from_numpy(v) for k, v in inputs.items()})
    np.testing.assert_allclose(got.logits.numpy(), np.asarray(want.logits), atol=2e-5)
    np.testing.assert_allclose(got.loss.numpy(), np.asarray(want.loss), atol=2e-5)

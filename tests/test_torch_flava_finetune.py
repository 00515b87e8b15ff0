"""The FLAVA finetuning recipe in the port
(``multimodal_tpu_torch/examples/flava/finetune.py``) held against the JAX
recipe at the debug config (``multimodal_tpu/examples/flava/configs/
debug.yaml``): its synthetic batches, the labelled real-data batches of
``ClassificationVLDataModule``, the loss and accuracy of one batch on the
JAX weights, ``main`` on the CPU, and a resumed run bitwise equal to the
uninterrupted one.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_tpu.examples.flava import finetune as jft
from multimodal_tpu_torch.examples.flava import finetune as tft
from multimodal_tpu_torch.training.checkpoint import CheckpointManager
from multimodal_tpu_torch.utils.checkpoint import flava_state_dict_from_jax
from multimodal_tpu_torch.utils.config import build_config

DEBUG_YAML = os.path.join(os.path.dirname(tft.__file__), "configs", "debug.yaml")


def _cfg(*overrides):
    return build_config(DEBUG_YAML, ["data.batch_size=4", *overrides], defaults=tft.DEFAULTS)


@pytest.fixture(scope="module")
def labelled(tmp_path_factory):
    root = tmp_path_factory.mktemp("memes")
    r = np.random.RandomState(7)
    words = "a cat dog on the mat red blue sky tree".split()
    with open(root / "train.jsonl", "w") as f:
        for i in range(14):
            path = str(root / f"{i}.npy")
            np.save(path, r.randint(0, 256, (50, 44, 3)).astype(np.uint8))
            f.write(json.dumps({"image": path, "text": " ".join(r.choice(words, 5)),
                                "label": int(r.randint(2))}) + "\n")
    return str(root / "train.jsonl")


def test_defaults_extend_the_jax_recipe():
    """The JAX recipe's config plus ``train.checkpoint_every`` (the JAX
    recipe never saves)."""
    train = dict(tft.DEFAULTS["train"])
    assert train.pop("checkpoint_every") is None
    assert {**tft.DEFAULTS, "train": train} == jft.DEFAULTS


def test_synthetic_batches_match_jax():
    cfg = _cfg()
    want, got = jft.synthetic_batches(cfg), tft.synthetic_batches(cfg)
    for _ in range(3):
        w, g = next(want), next(got)
        for k in w:
            assert g[k].dtype == w[k].dtype
            np.testing.assert_array_equal(g[k], w[k])
    skipped = tft.synthetic_batches(cfg, start_step=2)
    np.testing.assert_array_equal(next(skipped)["text"], g["text"])


def test_real_batches_match_jax_text_and_labels(labelled):
    """Shuffle, tokens and labels equal the JAX recipe's (its crops draw
    from a running stream, the port's from each batch's RandomState, so the
    pixels are held to their shape and range)."""
    cfg = _cfg(f"data.path={labelled}")
    want, got = jft.real_batches(cfg), tft.real_batches(cfg)
    for _ in range(5):
        w, g = next(want), next(got)
        assert set(g) == set(w) == {"image", "text", "itm_labels", "labels"}
        for k in ("text", "itm_labels", "labels"):
            np.testing.assert_array_equal(g[k].numpy(), w[k])
        assert g["image"].shape == w["image"].shape == (4, 32, 32, 3)
        assert g["image"].dtype == torch.float32
        assert abs(float(g["image"].mean()) - float(w["image"].mean())) < 0.5


def test_loss_matches_jax():
    """One batch through the JAX weights: the loss and the accuracy."""
    cfg = _cfg("model.num_classes=3")
    batch = next(jft.synthetic_batches(cfg))
    m = cfg["model"]
    kwargs = dict(jft.FLAVA_CONFIGS[m["size"]], **m["overrides"])
    jm = jft.flava_model_for_classification(
        num_classes=3, classifier_in_dim=32, classifier_hidden_sizes=32,
        vocab_size=m["vocab_size"], image_size=m["image_size"], patch_size=m["patch_size"],
        **kwargs)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), **jb)
    out = jm.apply(params, **jb)
    tm = tft.build_model(cfg, device="cpu")
    res = tm.load_state_dict(flava_state_dict_from_jax(jax.tree.map(np.asarray, params)),
                             strict=False)
    assert res.missing_keys == ["model.image_encoder.embeddings.mask_token"]
    with torch.no_grad():
        loss, aux = tft.loss_fn(tm, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(loss.numpy(), np.asarray(out.loss), atol=2e-5)
    acc = np.mean(np.argmax(np.asarray(out.logits), -1) == batch["labels"])
    assert float(aux["accuracy"]) == pytest.approx(acc)


@pytest.mark.parametrize("data", ["synthetic", "real"])
def test_main_on_cpu(data, labelled):
    extra = [f"data.path={labelled}"] if data == "real" else []
    model, trainer = tft.main(["--device", "cpu", "--config", DEBUG_YAML, "train.steps=3",
                               "data.batch_size=4", *extra])
    assert trainer.step == 3 and len(trainer.logger.records) == 3
    for r in trainer.logger.records:
        assert np.isfinite(r["loss"]) and 0.0 <= r["accuracy"] <= 1.0
    assert next(model.parameters()).device.type == "cpu"


@pytest.mark.parametrize("data", ["synthetic", "real"])
def test_resume_is_bitwise(data, labelled, tmp_path):
    """4 steps against 2 steps (saved after the last, as the recipe does)
    and a second ``main`` on the checkpoint that trains the remaining 2 on
    the batches the first would have seen next."""
    base = ["--device", "cpu", "--config", DEBUG_YAML, "data.batch_size=4",
            *([f"data.path={labelled}"] if data == "real" else [])]
    whole, wt = tft.main(base + ["train.steps=4"])
    ck = f"train.checkpoint_dir={tmp_path}"
    tft.main(base + ["train.steps=2", ck])
    assert CheckpointManager(str(tmp_path)).latest_step() == 2
    resumed, rt = tft.main(base + ["train.steps=4", ck])
    assert rt.step == 4 and CheckpointManager(str(tmp_path)).latest_step() == 4
    strip = lambda recs: [{k: v for k, v in r.items() if k != "items_per_sec"} for r in recs]
    assert strip(rt.logger.records) == strip(wt.logger.records[2:])
    for (n, a), b in zip(whole.named_parameters(), resumed.parameters()):
        assert torch.equal(a, b), n

"""The FLAVA data layer in the port (``transforms/flava_transform.py``,
``data/{datasets,datamodules,webdataset}.py``, the recipe's tokenizers,
``training/retrieval_eval.py``, ``examples/flava/coco_zero_shot.py``,
``modules/optimizers/anyprecision.py``) held against the JAX package on
seeded numpy inputs. The JAX transform resizes with PIL; the port's C++
copy of PIL's resampler needs none, so the tests compare it with PIL
directly too.
"""

import json
import os
import random
import sys
import tarfile

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image

from multimodal_tpu.data import datamodules as jdm
from multimodal_tpu.data import datasets as jds
from multimodal_tpu.data import webdataset as jwd
from multimodal_tpu.examples.flava import coco_zero_shot as jcoco
from multimodal_tpu.examples.flava import pretrain as jrec
from multimodal_tpu.modules.optimizers import anyprecision_adamw
from multimodal_tpu.training.mlm_collator import MLMCollator as JCollator
from multimodal_tpu.training.retrieval_eval import retrieval_recall_at_k as j_recall
from multimodal_tpu.transforms import flava_transform as jft
from multimodal_tpu_torch.data import datamodules as tdm
from multimodal_tpu_torch.data import datasets as tds
from multimodal_tpu_torch.data import webdataset as twd
from multimodal_tpu_torch.examples.flava import coco_zero_shot as tcoco
from multimodal_tpu_torch.examples.flava import pretrain as trec
from multimodal_tpu_torch.modules.optimizers.anyprecision import AnyPrecisionAdamW
from multimodal_tpu_torch.native.resample import resample_native, two_way_native
from multimodal_tpu_torch.training.mlm_collator import MLMCollator
from multimodal_tpu_torch.training.retrieval_eval import retrieval_recall_at_k
from multimodal_tpu_torch.transforms import flava_transform as tft

WORDS = "a cat dog on the mat red blue sky tree sits under over big small".split()


def _pil(arr):
    return Image.fromarray(np.asarray(arr, np.uint8))


# --------------------------------------------------------------------------
# the resampler and the transform
# --------------------------------------------------------------------------


@pytest.mark.parametrize("boxed", [False, True])
@pytest.mark.parametrize("seed", range(12))
@pytest.mark.parametrize("name,pil", [("bicubic", Image.BICUBIC), ("lanczos", Image.LANCZOS)])
def test_resample_equals_pil(seed, name, pil, boxed):
    """The port's resampler (C++) against PIL's ``resize``, without and
    with a crop box (noise and smooth images; down and up): exactly equal."""
    r = np.random.RandomState(seed)
    h, w = r.randint(8, 300, 2)
    img = r.randint(0, 256, (h, w, 3)).astype(np.uint8)
    if seed % 2:
        img = np.cumsum(img, 1).astype(np.uint8)
    ow, oh = r.randint(4, 260, 2)
    cw, ch = r.randint(1, w + 1), r.randint(1, h + 1)
    left, top = r.randint(0, w - cw + 1), r.randint(0, h - ch + 1)
    box = (left, top, left + cw, top + ch) if boxed else None
    want = np.asarray(Image.fromarray(img).resize((ow, oh), pil, box=box))
    np.testing.assert_array_equal(resample_native(img, (ow, oh), name, box), want)


@pytest.mark.parametrize("shape", [(9, 8), (9, 8, 1), (9, 8, 4)])
def test_native_resample_takes_rgb_only(shape):
    """The C++ copy reads three channels a pixel: other arrays are refused
    before a pointer is passed."""
    img = np.zeros(shape, np.uint8)
    with pytest.raises(ValueError, match="HWC RGB"):
        resample_native(img, (4, 4), "bicubic")
    with pytest.raises(ValueError, match="HWC RGB"):
        two_way_native(img, None, 4, 4, np.zeros(3), np.ones(3))


def _transforms(is_train, seed, **kw):
    j = jft.FLAVAImageTransform(is_train=is_train, rng=np.random.RandomState(seed), **kw)
    t = tft.FLAVAImageTransform(is_train=is_train, rng=np.random.RandomState(seed), **kw)
    j.masked_position_generator.rng = random.Random(seed)
    t.masked_position_generator.rng = random.Random(seed)
    return j, t


def _pixels_close(got, want, scale):
    """Mean |diff| <= 0.5/255 and max <= 2/255 in [0, 1] pixel units
    (``scale`` maps the view's units to them); measured: exactly equal."""
    d = np.abs(got - want) * scale
    assert d.mean() <= 0.5 / 255 and d.max() <= 2 / 255, (d.mean(), d.max())


@pytest.mark.parametrize("is_train", [True, False])
@pytest.mark.parametrize("seed", [0, 5, 9])
def test_flava_transform_matches_jax(is_train, seed):
    """Same seeds: the crop box and the mask exactly equal; the encoder view
    (normalised) and the codebook view (after ``map_pixels``) within
    0.5/255 mean and 2/255 max of PIL's bicubic and LANCZOS."""
    r = np.random.RandomState(100 + seed)
    j, t = _transforms(is_train, seed)
    for shape in ((256, 256, 3), (300, 200, 3), (180, 240, 3)):
        img = r.randint(0, 256, shape).astype(np.uint8)
        want, got = j.transform(_pil(img)), t.transform(img)
        assert set(got) == set(want)
        np.testing.assert_array_equal(got["image_patches_mask"], want["image_patches_mask"])
        assert got["image"].shape == want["image"].shape == (224, 224, 3)
        assert got["image_for_codebook"].shape == (112, 112, 3)
        assert got["image"].dtype == got["image_for_codebook"].dtype == np.float32
        _pixels_close(got["image"], want["image"], np.asarray(jft.IMAGE_PRETRAINING_STD))
        _pixels_close(got["image_for_codebook"], want["image_for_codebook"], 1 / 0.8)
    assert t.rng.randint(1 << 30) == j.rng.randint(1 << 30)  # the same draws were made


def test_flava_transform_plan_draws_first():
    """``plan`` makes the crop and mask draws at once, in the transform's
    order; running the plans later, in any order, gives what ``transform``
    gives in turn. Handed a RandomState, it draws from that alone."""
    imgs = [np.random.RandomState(i).randint(0, 256, (70, 60, 3)).astype(np.uint8)
            for i in range(3)]
    kw = dict(encoder_input_size=32, codebook_input_size=16, mask_window_size=4,
              mask_num_patches=5, mask_min_patches=2)
    _, a = _transforms(True, 7, **kw)
    _, b = _transforms(True, 7, **kw)
    want = [a.transform(im) for im in imgs]
    plans = [b.plan(im) for im in imgs]
    for i in (2, 0, 1):
        got = plans[i]()
        for k in want[i]:
            np.testing.assert_array_equal(got[k], want[i][k])
    own = (b.rng.get_state(), b.masked_position_generator.rng.getstate())
    handed = [b.plan(im, np.random.RandomState(4 + i))() for i, im in enumerate(imgs)]
    np.testing.assert_equal((b.rng.get_state(), b.masked_position_generator.rng.getstate()),
                            own)
    for i, (im, got) in enumerate(zip(imgs, handed)):
        r = np.random.RandomState(4 + i)  # the crop's draws, then the mask's seed
        b._crop_box(70, 60, r)
        _, c = _transforms(True, 4 + i, **kw)
        c.masked_position_generator.rng = random.Random(int(r.randint(2 ** 31)))
        want = c.transform(im)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])


def test_flava_transform_takes_pil_and_gray():
    """A PIL image or a grayscale array give what the RGB array gives."""
    img = np.random.RandomState(3).randint(0, 256, (64, 80)).astype(np.uint8)
    rgb = np.repeat(img[:, :, None], 3, axis=2)
    outs = []
    for x in (img, rgb, Image.fromarray(img)):
        t = tft.FLAVAImageTransform(is_train=False, encoder_input_size=32,
                                    codebook_input_size=16, mask_window_size=4,
                                    mask_num_patches=4, mask_min_patches=2)
        outs.append(t.transform(x))
    for o in outs[1:]:
        np.testing.assert_array_equal(o["image"], outs[0]["image"])
    with pytest.raises(ValueError, match="HWC RGB"):
        t.transform(np.zeros((8, 8, 4), np.uint8))


@pytest.mark.parametrize("window,count,low", [(14, 75, 16), (4, 6, 6), (7, 20, 4)])
def test_masking_generator_matches_jax(window, count, low):
    j = jft.ImageMaskingGenerator(window, count, min_num_patches=low, rng=random.Random(9))
    t = tft.ImageMaskingGenerator(window, count, min_num_patches=low, rng=random.Random(9))
    for _ in range(20):
        np.testing.assert_array_equal(t(), j())


def test_map_pixels_matches_jax():
    x = np.random.RandomState(1).rand(5, 7).astype(np.float32)
    np.testing.assert_array_equal(tft.map_pixels(x), jft.map_pixels(x))
    with pytest.raises(ValueError, match="float"):
        tft.map_pixels(np.zeros(3, np.uint8))


# --------------------------------------------------------------------------
# datasets and data modules
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    """A jsonl of {image: .npy path, text, label}, the same as a .json, an
    image folder of .npy files in 3 class directories, and a .tar shard of
    png + txt members."""
    root = tmp_path_factory.mktemp("flava_data")
    r = np.random.RandomState(0)
    samples = []
    for i in range(20):
        path = str(root / f"img{i}.npy")
        np.save(path, r.randint(0, 256, (r.randint(40, 70), r.randint(40, 70), 3))
                .astype(np.uint8))
        samples.append({"image": path, "text": " ".join(r.choice(WORDS, r.randint(2, 9))),
                        "label": int(i % 3)})
    with open(root / "pairs.jsonl", "w") as f:
        f.writelines(json.dumps(s) + "\n" for s in samples)
    with open(root / "pairs.json", "w") as f:
        json.dump({"data": samples}, f)
    for c in ("cat", "dog", "bird"):
        os.makedirs(root / "folder" / "val" / c)
        for i in range(3):
            np.save(root / "folder" / "val" / c / f"{i}.npy",
                    r.randint(0, 256, (48, 48, 3)).astype(np.uint8))
        (root / "folder" / "val" / c / "notes.txt").write_text("not an image")
    with tarfile.open(root / "shard0.tar", "w") as tf:
        for i in range(12):
            png = root / f"{i:04d}.png"
            Image.fromarray(r.randint(0, 256, (40, 50, 3)).astype(np.uint8)).save(png)
            tf.add(png, arcname=f"{i:04d}.png")
            txt = root / f"{i:04d}.txt"
            txt.write_text(" ".join(r.choice(WORDS, 5)))
            tf.add(txt, arcname=f"{i:04d}.txt")
    return root


@pytest.mark.parametrize("which", ["pairs.jsonl", "pairs.json", "folder"])
def test_load_dataset_matches_jax(which, data_dir):
    want = jds.load_dataset(str(data_dir / which), split="val")
    got = tds.load_dataset(str(data_dir / which), split="val")
    assert len(got) == len(want) > 0
    assert [got[i] for i in range(len(got))] == [want[i] for i in range(len(want))]


def test_hf_datasets_is_named_when_absent(tmp_path, monkeypatch):
    (tmp_path / "state.json").write_text("{}")
    monkeypatch.setitem(__import__("sys").modules, "datasets", None)
    with pytest.raises(ImportError, match="datasets"):
        tds.load_dataset(str(tmp_path))


def _collator(cls, vocab):
    return cls(vocab_size=vocab, mask_token_id=103, mlm_probability=0.15,
               special_token_ids=(0, 101, 102), ignore_index=-1)


def _assert_batches_equal(got, want, float_scale=None):
    assert set(got) == set(want)
    for k in want:
        g, w = got[k].numpy(), np.asarray(want[k])
        assert isinstance(got[k], torch.Tensor) and got[k].device.type == "cpu"
        assert g.dtype == w.dtype and g.shape == w.shape, k
        if g.dtype.kind == "f" and float_scale is not None:
            _pixels_close(g, w, float_scale.get(k, 1.0))
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)


def _vl_modules(data_dir, **kw):
    """The JAX and the port's VLDataModule over the jsonl, each with its
    FLAVA transform seeded alike (the JAX one through PIL)."""
    ds = str(data_dir / "pairs.jsonl")
    jt, tt = _transforms(True, 4, encoder_input_size=32, codebook_input_size=32,
                         mask_window_size=4, mask_num_patches=6, mask_min_patches=6)
    tok = jrec.HashTokenizer(1000, 16)
    j = jdm.VLDataModule(jds.load_dataset(ds), image_transform=lambda im: jt.transform(_pil(im)),
                         text_transform=tok, mlm_collator=_collator(JCollator, 1000),
                         itm_probability=0.3, batch_size=4, seed=3, **kw)
    t = tdm.VLDataModule(tds.load_dataset(ds), image_transform=tt.transform,
                         text_transform=trec.HashTokenizer(1000, 16),
                         mlm_collator=_collator(MLMCollator, 1000), itm_probability=0.3,
                         batch_size=4, seed=3, **kw)
    return j, t


VIEWS = {"image": np.asarray(jft.IMAGE_PRETRAINING_STD), "image_for_codebook": 1 / 0.8}


def test_vl_datamodule_matches_jax(data_dir):
    """Two epochs (10 batches) of train batches: shuffle, ITM negatives,
    MLM masking and the FLAVA transform's crops and masks equal."""
    j, t = _vl_modules(data_dir)
    jit, tit = j.train_batches(), t.train_batches()
    for _ in range(10):
        _assert_batches_equal(next(tit), next(jit), VIEWS)


def test_vl_datamodule_resumes_at_a_step(data_dir):
    """``train_batches(start_step=7)`` starts at the 8th batch: its ITM and
    MLM draws (the batch's RandomState) equal the whole stream's batch 7
    and the JAX module's resumed stream."""
    _, t = _vl_modules(data_dir, prefetch=0)
    whole = t.train_batches()
    batches = [next(whole) for _ in range(9)]
    j, t = _vl_modules(data_dir, prefetch=0)
    want, got = j.train_batches(start_step=7), t.train_batches(start_step=7)
    for i in (7, 8):
        w, g = next(want), next(got)
        for k in ("text", "text_masked", "mlm_labels", "itm_labels"):
            np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k]))
            assert torch.equal(g[k], batches[i][k])


def test_image_datamodule_matches_jax(data_dir):
    """An image folder: train batches (uint8 arrays, labels) and one eval
    pass with a ragged last batch."""
    ds = str(data_dir / "folder")
    kw = dict(batch_size=4, seed=1)
    j = jdm.ImageDataModule(jds.load_dataset(ds, split="val"), **kw)
    t = tdm.ImageDataModule(tds.load_dataset(ds, split="val"), **kw)
    jit, tit = j.train_batches(), t.train_batches()
    for _ in range(4):
        _assert_batches_equal(next(tit), next(jit))
    jev, tev = list(j.eval_batches()), list(t.eval_batches())
    assert [len(b["labels"]) for b in tev] == [4, 4, 1]
    for g, w in zip(tev, jev):
        _assert_batches_equal(g, w)


def test_mlm_datamodule_matches_jax(data_dir):
    ds = str(data_dir / "pairs.jsonl")
    j = jdm.MLMDataModule(jds.load_dataset(ds), jrec.HashTokenizer(500, 12),
                          _collator(JCollator, 500), batch_size=5, seed=2)
    t = tdm.MLMDataModule(tds.load_dataset(ds), trec.HashTokenizer(500, 12),
                          _collator(MLMCollator, 500), batch_size=5, seed=2)
    jit, tit = j.train_batches(), t.train_batches()
    for _ in range(6):
        _assert_batches_equal(next(tit), next(jit))


def test_streaming_vl_datamodule_matches_jax(data_dir):
    """A .tar shard of png + txt members (PIL decodes them on both sides):
    in-batch ITM negatives, MLM masking, the shuffle buffer; and a resume
    at a step skips the same batches."""
    def modules(**kw):
        jt, tt = _transforms(True, 2, encoder_input_size=32, codebook_input_size=16,
                             mask_window_size=2, mask_num_patches=2, mask_min_patches=1)
        common = dict(itm_probability=0.5, batch_size=3, seed=4, shuffle_buffer=5, **kw)
        j = jwd.StreamingVLDataModule(str(data_dir / "*.tar"), image_transform=jt.transform,
                                      text_transform=jrec.HashTokenizer(800, 10),
                                      mlm_collator=_collator(JCollator, 800), **common)
        t = twd.StreamingVLDataModule(str(data_dir / "*.tar"), image_transform=tt.transform,
                                      text_transform=trec.HashTokenizer(800, 10),
                                      mlm_collator=_collator(MLMCollator, 800), **common)
        return j, t

    j, t = modules()
    jit, tit = j.train_batches(), t.train_batches()
    for _ in range(6):  # over an epoch's end
        _assert_batches_equal(next(tit), next(jit), VIEWS)
    j, t = modules(prefetch=0)
    jr, tr = j.train_batches(start_step=5), t.train_batches(start_step=5)
    for k in ("text", "itm_labels", "mlm_labels"):
        np.testing.assert_array_equal(next(tr)[k].numpy(), np.asarray(next(jr)[k]))
    assert twd.expand_shards(str(data_dir)) == jwd.expand_shards(str(data_dir))


def test_jpeg_staging_names_its_queue(data_dir):
    ds = tds.load_dataset(str(data_dir / "pairs.jsonl"))
    with pytest.raises(NotImplementedError, match="A8"):
        tdm.ImageDataModule(ds, jpeg_staging=(64, 64))


def test_prefetcher_raises_in_the_consumer():
    def bad():
        yield 1
        raise KeyError("boom")

    it = tdm._Prefetcher(bad)
    assert next(it) == 1
    with pytest.raises(KeyError, match="boom"):
        next(it)


# --------------------------------------------------------------------------
# the recipe's text transforms and real batches
# --------------------------------------------------------------------------


@pytest.mark.parametrize("vocab,length", [(30522, 77), (1000, 16), (300, 8)])
def test_hash_tokenizer_matches_jax(vocab, length):
    r = np.random.RandomState(vocab)
    texts = [" ".join(r.choice(WORDS, r.randint(0, 40))) for _ in range(30)]
    texts += ["", "UPPER lower MiXeD", "tabs\tand\nnewlines"]
    np.testing.assert_array_equal(trec.HashTokenizer(vocab, length)(texts),
                                  jrec.HashTokenizer(vocab, length)(texts))


@pytest.mark.parametrize("with_vocab", [False, True])
def test_build_text_transform_matches_jax(with_vocab, tmp_path):
    cfg = {"model": dict(trec.DEFAULTS["model"], vocab_size=1000),
           "data": dict(trec.DEFAULTS["data"], text_len=12)}
    if with_vocab:
        vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + WORDS + ["##s", "##er"]
        (tmp_path / "vocab.txt").write_text("\n".join(vocab))
        cfg["data"]["vocab_path"] = str(tmp_path / "vocab.txt")
    texts = ["a cat sits on the mat", "big dogs over the small trees", "",
             " ".join(WORDS * 3)]
    got = trec.build_text_transform(cfg)(texts)
    want = jrec.build_text_transform(cfg)(texts)
    assert got.shape == (4, 12)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_transform_pool_under_contention(data_dir):
    """``VLDataModule`` with the recipe's transform resamples on a thread
    pool into the batch's arrays: with a switch interval of a microsecond,
    every image of 3 batches equals the transform run in turn with the
    same draws from the batch's RandomState."""
    cfg = trec.build_config(None, [f"data.path={data_dir / 'pairs.jsonl'}",
                                   "data.batch_size=16", "model.image_size=64",
                                   "model.patch_size=16"], defaults=trec.DEFAULTS)
    ds = tds.load_dataset(str(data_dir / "pairs.jsonl"))
    seq = trec.flava_train_transform(cfg)
    dm = tdm.VLDataModule(
        ds, image_transform=trec.flava_train_transform(cfg),
        text_transform=trec.HashTokenizer(1000, 8), itm_probability=0.0, batch_size=16,
        seed=2, prefetch=0)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        batches = [b for _, b in zip(range(3), dm.train_batches())]
    finally:
        sys.setswitchinterval(old)
    for epoch, b in enumerate(batches):  # 20 samples: one batch of 16 an epoch
        rng = np.random.RandomState((2, epoch, 0, 0))
        for i, j in enumerate(dm._epoch_indices(epoch)[:16]):
            want = seq.plan(np.load(ds[int(j)]["image"]), rng)()
            for k, v in want.items():
                np.testing.assert_array_equal(b[k][i].numpy(), v, err_msg=f"{epoch} {i} {k}")


def test_real_batches_shapes_and_resume(data_dir):
    """The recipe's ``real_batches`` over a jsonl at the debug config: every
    field of the six losses, at the batch's shapes; and a stream started at
    step 3 equals the whole stream's batches from 3 on, pixels included
    (each crop and mask draws from its batch's RandomState)."""
    cfg = trec.build_config(os.path.join(os.path.dirname(trec.__file__), "configs",
                                         "debug.yaml"),
                            [f"data.path={data_dir / 'pairs.jsonl'}", "data.batch_size=4"],
                            defaults=trec.DEFAULTS)
    whole = trec.real_batches(cfg)
    batches = [next(whole) for _ in range(6)]
    b = batches[0]
    assert {k: tuple(v.shape) for k, v in b.items()} == {
        "image": (4, 32, 32, 3), "image_for_codebook": (4, 32, 32, 3),
        "image_patches_mask": (4, 4, 4), "text": (4, 16), "text_masked": (4, 16),
        "mlm_labels": (4, 16), "itm_labels": (4,)}
    assert (b["image_patches_mask"].sum((1, 2)) == 6).all()
    resumed = trec.real_batches(cfg, start_step=3)
    for want in batches[3:]:
        got = next(resumed)
        for k in want:
            assert torch.equal(got[k], want[k]), k


# --------------------------------------------------------------------------
# retrieval eval, COCO eval, AnyPrecision AdamW
# --------------------------------------------------------------------------


@pytest.mark.parametrize("n,d,chunk", [(40, 16, None), (37, 8, 10), (64, 32, 64)])
def test_retrieval_recall_matches_jax(n, d, chunk):
    r = np.random.RandomState(n)
    a = r.randn(n, d).astype(np.float32)
    b = (a + 0.8 * r.randn(n, d)).astype(np.float32)
    b[3] = b[4]  # a tie: strictly larger scores count
    want = j_recall(jnp.asarray(a), jnp.asarray(b), ks=(1, 5, 10), chunk_size=chunk)
    got = retrieval_recall_at_k(torch.from_numpy(a), torch.from_numpy(b), ks=(1, 5, 10),
                                chunk_size=chunk)
    assert got.keys() == want.keys()
    for k in want:  # hits / n, each an fp32 mean: equal to fp32 rounding
        assert got[k] == pytest.approx(want[k], abs=1e-6), k
    with pytest.raises(ValueError, match="equal counts"):
        retrieval_recall_at_k(torch.zeros(3, 2), torch.zeros(4, 2))


def test_coco_retrieval_eval_matches_jax(data_dir):
    """``coco_caption_batches`` over the jsonl (first caption of a list) and
    ``coco_retrieval_eval`` on seeded linear encoders."""
    ds = tds.load_dataset(str(data_dir / "pairs.jsonl"))
    ds.samples[0]["text"] = [ds.samples[0]["text"], "a second caption"]
    r = np.random.RandomState(5)
    wi = r.randn(32 * 32 * 3, 16).astype(np.float32)
    wt = r.randn(16, 16).astype(np.float32)

    def image_transform(path):
        return resample_native(np.load(path), (32, 32), "bicubic").astype(np.float32) / 255

    tok = trec.HashTokenizer(1000, 16)
    jb = list(jcoco.coco_caption_batches(ds, image_transform, tok, batch_size=6))
    tb = list(tcoco.coco_caption_batches(ds, image_transform, tok, batch_size=6))
    assert [len(b["text"]) for b in tb] == [6, 6, 6, 2]
    for g, w in zip(tb, jb):
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])
    want = jcoco.coco_retrieval_eval(
        lambda x: jnp.asarray(x).reshape(len(x), -1) @ wi,
        lambda t: (jnp.asarray(t) % 97).astype(jnp.float32) @ wt, iter(jb))
    got = tcoco.coco_retrieval_eval(
        lambda x: torch.as_tensor(x).reshape(len(x), -1) @ torch.from_numpy(wi),
        lambda t: (torch.as_tensor(t) % 97).float() @ torch.from_numpy(wt), iter(tb))
    assert got.keys() == want.keys()
    for k in want:  # an fp32 mean of hits over 20 pairs: equal to fp32 rounding
        assert got[k] == pytest.approx(want[k], abs=1e-6), k


@pytest.mark.parametrize("pdtype,kahan", [("float32", False), ("bfloat16", True),
                                          ("float32", True)])
def test_anyprecision_adamw_matches_jax(pdtype, kahan):
    """Parameters, bf16 momentum, bf16 variance and the bf16 compensation
    after 5 steps of seeded gradients under the warmup-cosine schedule:
    bitwise equal to ``anyprecision_adamw`` + ``optax.apply_updates``
    (the update's scalars are fp32 on both sides)."""
    r = np.random.RandomState(17)
    shapes = [(64, 32), (33,), ()]
    jdt = jnp.bfloat16 if pdtype == "bfloat16" else jnp.float32
    tdt = getattr(torch, pdtype)
    params = [np.asarray(r.randn(*s), np.float32) for s in shapes]
    grads = [[np.asarray(r.randn(*s), np.float32) for s in shapes] for _ in range(5)]
    sched = optax.warmup_cosine_decay_schedule(0.0, 1e-2, 2, 5)
    tx = anyprecision_adamw(sched, weight_decay=0.1, use_kahan_summation=kahan,
                            momentum_dtype=jnp.bfloat16)
    jp = [jnp.asarray(p, jdt) for p in params]
    state = tx.init(jp)
    tp = [torch.nn.Parameter(torch.from_numpy(p).to(tdt)) for p in params]
    # optax's schedule values themselves (the port's schedule is held to
    # them within a few fp32 units in test_torch_flava.py)
    opt = AnyPrecisionAdamW(tp, lr=lambda n: float(sched(n)), weight_decay=0.1, use_kahan_summation=kahan,
                            momentum_dtype=torch.bfloat16)
    for g in grads:
        upd, state = tx.update([jnp.asarray(x, jdt) for x in g], state, jp)
        jp = optax.apply_updates(jp, upd)
        for p, x in zip(tp, g):
            p.grad = torch.from_numpy(x).to(tdt)
        opt.step()
    for i, p in enumerate(tp):
        st = opt.state[p]
        assert p.dtype == tdt and st["momentum"].dtype == torch.bfloat16
        pairs = [(p.detach(), jp[i]), (st["momentum"], state.momentum[i]),
                 (st["variance"], state.variance[i])]
        if kahan:
            pairs.append((st["compensation"], state.compensation[i]))
        for got, want in pairs:
            np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


def test_anyprecision_state_dict_round_trip():
    """A restored optimizer keeps its count and its state's dtypes, and its
    next step equals the original's."""
    r = np.random.RandomState(2)
    make = lambda: torch.nn.Parameter(torch.from_numpy(r.randn(8, 4).astype(np.float32))
                                      .to(torch.bfloat16))
    p = make()
    opt = AnyPrecisionAdamW([p], lr=1e-2, weight_decay=0.1, use_kahan_summation=True)
    for _ in range(3):
        p.grad = torch.randn(8, 4).to(torch.bfloat16)
        opt.step()
    q = torch.nn.Parameter(p.detach().clone())
    opt2 = AnyPrecisionAdamW([q], lr=1e-2, weight_decay=0.1, use_kahan_summation=True)
    opt2.load_state_dict(opt.state_dict())
    assert opt2.count == 3 and opt2.state[q]["variance"].dtype == torch.bfloat16
    assert opt2.state[q]["momentum"].dtype == torch.float32
    g = torch.randn(8, 4).to(torch.bfloat16)
    p.grad, q.grad = g, g.clone()
    opt.step()
    opt2.step()
    assert torch.equal(p, q)
